"""K1 · the GEMM core: ``C[M,N] = A[M,K] @ B[K,N]`` with an f32 accumulator
(≙ ``triton_dist_tpu/ops/gemm.py::matmul`` and its Pallas kernel
``_matmul_kernel`` at ``:24``, which ``ops/common.py::gemm_only`` shares).

:func:`matmul` launches ``csrc/gemm.cu`` for tensors on the card and runs
its plain twin :func:`_matmul_plain` for tensors on the CPU. The TPU tile
sizes of the JAX entry (``block_m/n/k``) have no counterpart: the CUDA
kernel fixes its own tiles (see the source note in ``csrc/gemm.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PROTOTYPES = {
    "tdt_gemm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def _matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Plain version: f32 products and sums, cast to `out_dtype`."""
    _matmul_plain.calls += 1
    return (a.float() @ b.float()).to(out_dtype)


_matmul_plain.calls = 0


def matmul(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``C = A @ B``, f32 accumulation, ``out_dtype`` defaults to A's.
    Takes bf16 or f32 inputs (both the same), row-major and contiguous."""
    out_dtype = out_dtype or a.dtype
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu":
        return _matmul_plain(a, b, out_dtype)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"matmul operands on {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul takes two bf16 or two f32 inputs, got {a.dtype}, {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul writes bf16 or f32, not {out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    lib = _build.library("gemm", _PROTOTYPES)
    rc = lib.tdt_gemm(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], _build.stream_of(a),
    )
    _build.check(lib, rc, "gemm")
    matmul.launches += 1
    return c


matmul.launches = 0

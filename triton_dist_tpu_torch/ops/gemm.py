"""K1 · the GEMM core: ``C[M,N] = A[M,K] @ B[K,N] (+ Σ adds)`` with an f32
accumulator (≙ ``triton_dist_tpu/ops/gemm.py::matmul`` and its Pallas
kernel ``_matmul_kernel`` at ``:24``, which ``ops/common.py::gemm_only``
shares; the adds are ``gemm_add_pipeline``'s epilogue, ``:468``).

:func:`matmul` launches ``csrc/gemm.cu`` for tensors on the card and runs
its plain twin :func:`_matmul_plain` for tensors on the CPU. The TPU tile
sizes of the JAX entry (``block_m/n/k``) have no counterpart: the CUDA
kernel fixes its own tiles (see the source note in ``csrc/gemm.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.utils import count_call, count_launch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ADDS = 7  # csrc/gemm_core.cuh MAX_ADDS: world - 1 landed chunks at world 8
_PROTOTYPES = {
    "tdt_gemm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p],
}


def _matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype, adds=()) -> torch.Tensor:
    """Plain version: f32 products and sums (then each add, in order, in
    f32), cast to `out_dtype`."""
    count_call(_matmul_plain)
    acc = a.float() @ b.float()
    for r in adds:
        acc = acc + r.float()
    return acc.to(out_dtype)


_matmul_plain.calls = 0


def check_operands(a: torch.Tensor, b: torch.Tensor, out_dtype, what: str) -> None:
    """What every K1-based kernel takes: two bf16 or two f32 row-major
    contiguous operands on one CUDA device, a bf16 or f32 result."""
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"{what} operands on {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODE:
        raise TypeError(f"{what} takes two bf16 or two f32 inputs, got {a.dtype}, {b.dtype}")
    if out_dtype not in DTYPE_CODE:
        raise TypeError(f"{what} writes bf16 or f32, not {out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} takes contiguous row-major operands")


def pointer_array(tensors) -> ctypes.Array:
    """Device pointers of `tensors` as a C ``void*[]`` (kept alive by the
    caller for the duration of the call)."""
    return (ctypes.c_void_p * max(1, len(tensors)))(*[t.data_ptr() for t in tensors])


def matmul(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None,
    adds=(), out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``C = A @ B + Σ adds``, f32 accumulation, ``out_dtype`` defaults to
    A's. Takes bf16 or f32 inputs (both the same), row-major and
    contiguous; each add is ``[M, N]`` in ``out_dtype``, added in order in
    f32 before the single cast. ``out`` (contiguous ``[M, N]``) receives the
    result instead of a new tensor."""
    out_dtype = out_dtype or a.dtype
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if len(adds) > MAX_ADDS or any(r.shape != (m, n) or r.dtype != out_dtype for r in adds):
        raise ValueError(f"matmul takes at most {MAX_ADDS} [{m}, {n}] {out_dtype} adds")
    if out is not None and (out.shape != (m, n) or out.dtype != out_dtype
                            or not out.is_contiguous()):
        raise ValueError(f"matmul out must be a contiguous [{m}, {n}] {out_dtype} tensor")
    if a.device.type == "cpu":
        c = _matmul_plain(a, b, out_dtype, adds)
        return c if out is None else out.copy_(c)
    check_operands(a, b, out_dtype, "matmul")
    if any(r.device != a.device or not r.is_contiguous() for r in adds):
        raise ValueError("matmul adds must be contiguous and on the operands' device")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device) if out is None else out
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.copy_(sum(r.float() for r in adds)) if adds else c.zero_()
    lib = _build.library("gemm", _PROTOTYPES)
    ptrs = pointer_array(adds)
    rc = lib.tdt_gemm(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], ptrs, len(adds), _build.stream_of(a),
    )
    _build.check(lib, rc, "gemm")
    count_launch(matmul)
    return c


matmul.launches = 0

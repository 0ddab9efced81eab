"""K1 · the GEMM core: ``C[M,N] = A[M,K] @ B[K,N] (+ Σ adds)`` with an f32
accumulator (≙ ``triton_dist_tpu/ops/gemm.py::matmul`` and its Pallas
kernel ``_matmul_kernel`` at ``:24``, which ``ops/common.py::gemm_only``
shares; the adds are ``gemm_add_pipeline``'s epilogue, ``:468``).

:func:`matmul` launches ``csrc/gemm.cu`` for tensors on the card and runs
its plain twin :func:`_matmul_plain` for tensors on the CPU. The TPU tile
sizes of the JAX entry (``block_m/n/k``) have no counterpart: the CUDA
kernels fix their own tiles, and :func:`plan` picks the engine and tile by
dtype, shape and alignment (see the source notes in ``csrc/gemm.cu`` and
``csrc/gemm_sm90.cuh``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.utils import cdiv, count_call, count_launch, sm_count

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ADDS = 7  # csrc/gemm_core.cuh MAX_ADDS: world - 1 landed chunks at world 8
_MAP = ctypes.c_longlong * 5
_PROTOTYPES = {
    "tdt_gemm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p],
    "tdt_gemm_sm90": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 3 + [_MAP, _MAP, ctypes.c_void_p],
}
# the wgmma + TMA engine's tile configs (csrc/gemm.cu tdt_gemm_sm90):
# config -> (BM, BN); every config's k step is 64 and its B box [64 k][64 n]
SM90_TILES = {0: (128, 256), 1: (128, 128), 2: (64, 64)}
SM90_BK = 64
SMALL_M = 64  # at most this many rows: the 64x64 config
# device time of a 128x256 tile over a 128x128 tile at equal k, on an H100
# 80GB HBM3 (one wave of each at M 256; PERF.md): the tile rule's weight
WIDE_TILE_COST = 1.6


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How :func:`matmul` runs one product on the card.

    ``engine``: ``"wgmma"`` (the persistent wgmma + TMA kernel), ``"mma_sync"``
    (the mma.sync engine) or ``"f32"`` (the full-f32 FMA kernel). For
    ``"wgmma"``: the tile ``config`` of :data:`SM90_TILES`, the output
    ``tiles``, the persistent ``grid`` and the two tensor maps' arguments
    ``map_a`` / ``map_b``: ``(dim0, dim1, outer stride in bytes, box0,
    box1)``, innermost first, as ``cuTensorMapEncodeTiled`` takes them."""

    engine: str
    config: int = -1
    tiles: int = 0
    grid: int = 0
    map_a: tuple = ()
    map_b: tuple = ()


def tma_ok(n: int, k: int, aligned: bool) -> bool:
    """TMA's rule for bf16 row-major A [M, K] and B [K, N]: 16-byte row
    strides (K and N multiples of 8) and 16-byte aligned base pointers."""
    return k % 8 == 0 and n % 8 == 0 and aligned


def plan(m: int, n: int, k: int, dtype: torch.dtype, *, aligned: bool = True, sms: int = 132,
         engine: str | None = None, config: int | None = None) -> GemmPlan:
    """The engine and tile for ``[m, k] @ [k, n]`` in `dtype` on a card of
    `sms` SMs; `aligned` says whether A, B and C are 16-byte aligned.

    f32 runs the f32 engine. bf16 runs the wgmma + TMA engine when
    :func:`tma_ok`, else the mma.sync engine. The wgmma tile: at most
    :data:`SMALL_M` rows take the 64x64 tile (one consumer warpgroup, a
    64-wide N tile: a short product spreads its weight panel over the
    SMs); larger products take 128x256 unless 128x128 finishes in fewer
    waves of `sms` tiles, a wide tile's wave weighing
    :data:`WIDE_TILE_COST` narrow ones. `engine` and `config` override the
    choice (the A/B of the chip script; a wgmma override of a product TMA
    cannot load raises)."""
    if dtype == torch.float32:
        return GemmPlan("f32")
    if dtype != torch.bfloat16:
        raise TypeError(f"matmul takes bf16 or f32, not {dtype}")
    ok = tma_ok(n, k, aligned)
    engine = engine or ("wgmma" if ok else "mma_sync")
    if engine == "mma_sync":
        return GemmPlan("mma_sync")
    if engine != "wgmma" or not ok:
        raise ValueError(f"no {engine} engine for [{m}, {k}] @ [{k}, {n}] (aligned={aligned})")
    if config is None:
        waves = [cdiv(cdiv(m, bm) * cdiv(n, bn), sms) for bm, bn in (SM90_TILES[0], SM90_TILES[1])]
        config = 2 if m <= SMALL_M else (0 if WIDE_TILE_COST * waves[0] <= waves[1] else 1)
    bm, bn = SM90_TILES[config]
    tiles = cdiv(m, bm) * cdiv(n, bn)
    return GemmPlan("wgmma", config, tiles, min(tiles, sms),
                    (k, m, 2 * k, SM90_BK, bm), (n, k, 2 * n, 64, SM90_BK))


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
    adds=(), out: torch.Tensor | None = None, _engine: str | None = None,
    _config: int | None = None,
) -> torch.Tensor:
    """``C = A @ B + Σ adds``, f32 accumulation, ``out_dtype`` defaults to
    A's. Takes bf16 or f32 inputs (both the same), row-major and
    contiguous; each add is ``[M, N]`` in ``out_dtype``, added in order in
    f32 before the single cast. ``out`` (contiguous ``[M, N]``) receives the
    result instead of a new tensor.

    On the card, :func:`plan` routes by shape only: bf16 with K and N
    multiples of 8 and A, B and C 16-byte aligned runs the wgmma + TMA
    kernel (``tdt_gemm_sm90``, counted on ``wgmma_launches``); any other
    bf16 product runs the mma.sync engine (``tdt_gemm``, counted on
    ``mma_launches``); f32 runs the full-f32 kernel. ``launches`` counts
    all three. A kernel that fails to build or launch raises; nothing falls
    back. ``_engine`` / ``_config`` force an engine or wgmma tile (the
    chip script's A/B; never the main path)."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, b, c))
    p = plan(m, n, k, a.dtype, aligned=aligned, sms=sm_count(a.get_device()),
             engine=_engine, config=_config)
    lib = _build.library("gemm", _PROTOTYPES)
    ptrs = pointer_array(adds)
    if p.engine == "wgmma":
        rc = lib.tdt_gemm_sm90(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, DTYPE_CODE[out_dtype], ptrs,
            len(adds), p.config, p.grid, _MAP(*p.map_a), _MAP(*p.map_b), _build.stream_of(a),
        )
        _build.check(lib, rc, "gemm (wgmma)")
        count_launch(matmul, "wgmma_launches")
    else:
        rc = lib.tdt_gemm(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
            DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], ptrs, len(adds), _build.stream_of(a),
        )
        _build.check(lib, rc, "gemm")
        if p.engine == "mma_sync":
            count_launch(matmul, "mma_launches")
    count_launch(matmul)
    return c


matmul.launches = 0
matmul.wgmma_launches = 0  # the wgmma + TMA engine
matmul.mma_launches = 0    # the mma.sync engine (bf16 TMA cannot load)

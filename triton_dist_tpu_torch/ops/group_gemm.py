"""K8 · the block-aligned grouped GEMM of the MoE expert compute (≙
``triton_dist_tpu/ops/group_gemm.py::group_gemm``; its Pallas site is
``_group_gemm_fused`` at ``:299`` with the body
``ops/gg_pipeline.py:87 make_group_gemm_kernel``), and K11, its weight
gradient (≙ ``group_gemm_dw``, ``:553``; Pallas site ``:534``, body
``gg_pipeline.py:159 make_group_gemm_dw_kernel``).

Rows of ``a_sorted`` are sorted by expert and padded so every ``block_m``
rows belong to one expert (``moe_utils.moe_align_block_size``); block ``i``
multiplies ``b[expert_ids[i]]``. :func:`group_gemm` launches
``csrc/group_gemm.cu`` for tensors on the card and runs its plain twin
:func:`_group_gemm_plain` (what ``_group_gemm_xla``, ``:204``, computes)
for tensors on the CPU. There is no fallback: a kernel that does not
build or launch raises. The TPU tile sizes ``block_n``/``block_k`` have no
counterpart here (the CUDA kernel fixes its own tiles); ``block_m`` is the
alignment block and must be a multiple of 128 on the card, so a 128-row M
tile never straddles two experts.

The bf16/f32 padded path is ported, forward and weight gradient. The int8
and fp8 weight formats (``w8``, ``fp8``; pre-quantized ``scale=`` banks
are not taken), ragged rows, the ``ragged_dot`` backend and the chunked
overlap schedules (``chunks_per_shard > 1``, span policies) are not:
asking for them through the config raises ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE, check_operands
from triton_dist_tpu_torch.utils import count_call, count_launch

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"tdt_group_gemm": [_P] * 4 + [_I] * 8 + [_P],
               "tdt_group_gemm_dw": [_P] * 4 + [_I] * 6 + [_P]}
# the M tile of the bf16 engine (csrc/gemm_core.cuh Bf16Engine::BM); the f32
# engine's 64 divides it
TILE_M = 128


@dataclasses.dataclass(frozen=True)
class GroupGemmConfig:
    """The JAX package's grouped-GEMM config, field for field (positional
    constructions keep their meaning). The ported path reads ``block_m``;
    :func:`check_config` refuses the options that are not ported."""

    block_m: int = 128
    block_n: int = 1024
    block_k: int = 512
    chunks_per_shard: int = 1
    ragged: bool = False
    w8: bool = False
    backend: str = "pallas"
    span_policy: str = "contig"
    fp8: bool = False

    def __post_init__(self):
        if self.w8 and self.fp8:
            raise ValueError("GroupGemmConfig: w8 and fp8 are exclusive operand formats")


def check_config(cfg: GroupGemmConfig | None) -> GroupGemmConfig:
    """``cfg`` (default ``GroupGemmConfig()``), or ``NotImplementedError``
    for an option that is not ported."""
    cfg = cfg or GroupGemmConfig()
    refused = (
        (cfg.w8 or cfg.fp8, "int8/fp8 expert weights (w8, fp8)", "B16, w8/fp8"),
        (cfg.ragged, "ragged rows", "B16, ragged"),
        (cfg.backend != "pallas", f"backend={cfg.backend!r}", "B16, ragged_dot"),
        (cfg.chunks_per_shard != 1, "chunks_per_shard > 1", "B17/B18, chunked"),
        (cfg.span_policy != "contig", f"span_policy={cfg.span_policy!r}",
         "B17/B18, span policies"),
    )
    for bad, what, item in refused:
        if bad:
            raise NotImplementedError(
                f"grouped GEMM {what} is not ported yet (ROADMAP {item})")
    return cfg


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU: ``jax.nn.gelu``'s default, and the one
    activation the kernels fuse."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def _group_gemm_plain(a_sorted, b, expert_ids, bm, out_dtype, act_fn):
    """Plain version (≙ ``_group_gemm_xla``): sort the blocks by expert
    (stable), one f32 product per expert's run of blocks, unsort; padded
    rows are computed as rows of their block's clamped expert. The expert
    counts cross to the host."""
    count_call(_group_gemm_plain)
    n_exp, k, n = b.shape
    nb = expert_ids.shape[0]
    ids = expert_ids.long().clamp(0, n_exp - 1)
    a = a_sorted if act_fn is None else act_fn(a_sorted.float()).to(a_sorted.dtype)
    order = torch.argsort(ids, stable=True)
    a3 = a.reshape(nb, bm, k)[order].reshape(nb * bm, k).float()
    parts, start = [], 0
    for e, c in enumerate(torch.bincount(ids, minlength=n_exp).tolist()):
        if c:
            parts.append(a3[start * bm:(start + c) * bm] @ b[e].float())
            start += c
    y = torch.cat(parts).reshape(nb, bm, n) if parts else a3.new_zeros((0, bm, n))
    out = torch.empty_like(y)
    out[order] = y
    return out.reshape(nb * bm, n).to(out_dtype)


_group_gemm_plain.calls = 0


def check_group_operands(a, b, expert_ids, out_dtype, act_fn, what) -> int:
    """What K8 and K9 take on the card; returns the row block size."""
    check_operands(a, b, out_dtype, what)
    if act_fn not in (None, gelu):
        raise ValueError(f"{what}: the kernel fuses only the tanh GELU (group_gemm.gelu)")
    if expert_ids.dtype != torch.int32 or expert_ids.device != a.device \
            or not expert_ids.is_contiguous():
        raise ValueError(f"{what}: expert_ids must be contiguous int32 on {a.device}")
    bm = a.shape[0] // max(1, expert_ids.numel())
    if bm % TILE_M or bm * expert_ids.numel() != a.shape[0]:
        raise ValueError(
            f"{what}: block_m={bm} must be a multiple of {TILE_M} on the card "
            f"(a {TILE_M}-row tile holds one expert)")
    return bm


def group_gemm(
    a_sorted: torch.Tensor,
    b: torch.Tensor,
    expert_ids: torch.Tensor,
    *,
    config: GroupGemmConfig | None = None,
    out_dtype: torch.dtype | None = None,
    act_fn=None,
) -> torch.Tensor:
    """``out[i*bm:(i+1)*bm] = act?(a_sorted[i*bm:(i+1)*bm]) @ b[expert_ids[i]]``
    with f32 accumulation. a_sorted ``[t_pad, K]`` bf16 or f32, b ``[E, K,
    N]`` of the same type, expert_ids ``[t_pad / block_m]`` int32 (read on
    the card, no host sync) → ``[t_pad, N]`` in ``out_dtype`` (default A's).
    ``act_fn`` (:func:`gelu`) runs on every A element in f32, rounded back
    to A's type, before the product."""
    cfg = check_config(config)
    out_dtype = out_dtype or a_sorted.dtype
    t_pad, k = a_sorted.shape
    n_exp, kb, n = b.shape
    nb = expert_ids.shape[0]
    if kb != k or nb == 0 or t_pad % nb:
        raise ValueError(f"group_gemm shapes {tuple(a_sorted.shape)} @ {tuple(b.shape)}, "
                         f"{nb} blocks")
    bm = t_pad // nb
    if bm != cfg.block_m:
        raise ValueError(f"rows per block {bm} != config.block_m {cfg.block_m}: "
                         f"alignment and GEMM must use the same block size")
    if a_sorted.device.type == "cpu":
        return _group_gemm_plain(a_sorted, b, expert_ids, bm, out_dtype, act_fn)
    check_group_operands(a_sorted, b, expert_ids, out_dtype, act_fn, "group_gemm")
    out = torch.empty((t_pad, n), dtype=out_dtype, device=a_sorted.device)
    if n == 0:
        return out
    lib = _build.library("group_gemm", _PROTOTYPES)
    rc = lib.tdt_group_gemm(
        a_sorted.data_ptr(), b.data_ptr(), expert_ids.data_ptr(), out.data_ptr(),
        t_pad, n, k, n_exp, bm, DTYPE_CODE[a_sorted.dtype], DTYPE_CODE[out_dtype],
        int(act_fn is not None), _build.stream_of(a_sorted),
    )
    _build.check(lib, rc, "group_gemm")
    count_launch(group_gemm)
    return out


group_gemm.launches = 0


def _group_gemm_dw_plain(a_sorted, g_sorted, expert_ids, n_exp, bm):
    """Plain version (≙ ``_group_gemm_dw_xla``): for each expert, the sum
    of ``A_blkᵀ · G_blk`` over its row blocks in block order, each product
    and the sum in f32; an expert with no blocks is zero. The ids cross to
    the host."""
    count_call(_group_gemm_dw_plain)
    nb = expert_ids.shape[0]
    k, n = a_sorted.shape[1], g_sorted.shape[1]
    a3 = a_sorted.reshape(nb, bm, k)
    g3 = g_sorted.reshape(nb, bm, n)
    out = torch.zeros((n_exp, k, n), dtype=torch.float32, device=a_sorted.device)
    for i, e in enumerate(expert_ids.tolist()):
        out[e] += a3[i].float().t() @ g3[i].float()
    return out


_group_gemm_dw_plain.calls = 0


def group_gemm_dw(
    a_sorted: torch.Tensor,
    g_sorted: torch.Tensor,
    expert_ids: torch.Tensor,
    n_exp: int,
    *,
    config: GroupGemmConfig | None = None,
) -> torch.Tensor:
    """Transpose grouped GEMM, the expert-weight gradient of
    :func:`group_gemm`: ``dW[e] = Σ_{blocks i of e} A_iᵀ · G_i``.
    a_sorted ``[t_pad, K]`` and g_sorted ``[t_pad, N]`` block-aligned rows
    in the same order (bf16 or f32, one type), expert_ids ``[t_pad /
    block_m]`` (clamped into ``[0, n_exp)`` first) → ``[n_exp, K, N]`` f32;
    an expert with no rows comes back exactly zero.

    Each expert's blocks are summed in block order whatever the layout, so
    the port needs no ``assume_sorted`` (the JAX package's licence to skip
    its grouping permutation): the rank-major rows take the same path."""
    cfg = check_config(config)
    t_pad, k = a_sorted.shape
    n = g_sorted.shape[1]
    nb = expert_ids.shape[0]
    if g_sorted.shape[0] != t_pad or nb == 0 or t_pad % nb or t_pad // nb != cfg.block_m:
        raise ValueError(f"group_gemm_dw shapes {tuple(a_sorted.shape)}, "
                         f"{tuple(g_sorted.shape)}, {nb} blocks of {cfg.block_m} rows")
    bm = cfg.block_m
    ids = expert_ids.clamp(0, n_exp - 1).contiguous()
    if a_sorted.device.type == "cpu":
        return _group_gemm_dw_plain(a_sorted, g_sorted, ids, n_exp, bm)
    check_operands(a_sorted, g_sorted, torch.float32, "group_gemm_dw")
    if ids.dtype != torch.int32 or ids.device != a_sorted.device:
        raise ValueError(f"group_gemm_dw: expert_ids must be int32 on {a_sorted.device}")
    if bm % TILE_M:
        raise ValueError(f"group_gemm_dw: block_m={bm} must be a multiple of {TILE_M} "
                         f"on the card")
    out = torch.empty((n_exp, k, n), dtype=torch.float32, device=a_sorted.device)
    if k == 0 or n == 0:
        return out.zero_()
    lib = _build.library("group_gemm", _PROTOTYPES)
    rc = lib.tdt_group_gemm_dw(
        a_sorted.data_ptr(), g_sorted.data_ptr(), ids.data_ptr(), out.data_ptr(),
        t_pad, k, n, n_exp, bm, DTYPE_CODE[a_sorted.dtype], _build.stream_of(a_sorted),
    )
    _build.check(lib, rc, "group_gemm_dw")
    count_launch(group_gemm_dw)
    return out


group_gemm_dw.launches = 0

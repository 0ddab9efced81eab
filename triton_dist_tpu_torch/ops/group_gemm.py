"""K8 · the block-aligned grouped GEMM of the MoE expert compute (≙
``triton_dist_tpu/ops/group_gemm.py::group_gemm``; its Pallas site is
``_group_gemm_fused`` at ``:299`` with the body
``ops/gg_pipeline.py:87 make_group_gemm_kernel``), K24, the same kernel
over int8 or fp8 expert banks with their per-(expert, out-column) scales
(``group_gemm_w8`` / ``group_gemm_fp8``, ``:400``/``:427``, the kernel body
under ``OperandFormat.scaled``), K29, the same kernel under the ragged-row
policy in all three formats (``GroupGemmConfig.ragged`` with the
alignment's ``valid_rows`` map; the body's ragged branch,
``gg_pipeline.py:110-152``), and K11, its weight gradient (≙
``group_gemm_dw``, ``:553``; Pallas site ``:534``, body
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

The operand format is keyed off the bank's dtype, as the JAX package keys
it (``:286``): ``torch.int8`` is w8, ``torch.float8_e4m3fn`` fp8, each with
an f32 ``scale [E, 1, N]``; ``config.w8``/``.fp8`` quantize a float bank at
the op boundary (:func:`resolve_w8`). Under ``config.ragged`` the kernel
skips every 128-row tile at or past its block's live count and writes it
as zeros; dead rows of a live tile are zeroed after the scale fold. The
``ragged_dot`` backend, the chunked overlap schedules (``chunks_per_shard >
1``, span policies) and the ragged weight gradient are not ported: asking
for them raises ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE, check_operands
from triton_dist_tpu_torch.utils import count_call, count_launch

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"tdt_group_gemm": [_P] * 6 + [_I] * 9 + [_P],
               "tdt_group_gemm_dw": [_P] * 4 + [_I] * 6 + [_P]}
# the M tile of the bf16 engine (csrc/gemm_core.cuh Bf16Engine::BM); the f32
# engine's 64 divides it
TILE_M = 128

# fp8_e4m3fn, the finite-max e4m3 variant (≙ ``FP8_DTYPE``/``_FP8_MAX``,
# ``:138-139``): 448 is its largest normal, the absmax maps onto it as 127
# does for int8
FP8_DTYPE = torch.float8_e4m3fn
_FP8_MAX = 448.0
# the weight dtype codes of csrc/gemm_core.cuh (DType): a one-byte bank
WEIGHT_CODE = {torch.int8: 2, FP8_DTYPE: 3}
# a one-byte bank's rows ride 16-byte cp.async copies on the card
WEIGHT_ROW_QUANTUM = 16


@dataclasses.dataclass(frozen=True)
class GroupGemmConfig:
    """The JAX package's grouped-GEMM config, field for field (positional
    constructions keep their meaning). The ported path reads ``block_m``,
    ``ragged`` and the formats; :func:`check_config` refuses the options
    that are not ported."""

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


def _absmax_scale(bf: torch.Tensor, q_max: float) -> torch.Tensor:
    """``max(absmax over K / q_max, 1e-8)`` in f32, divided exactly: the
    divisor is a tensor, because PyTorch's CUDA division by a Python scalar
    multiplies by its rounded reciprocal, one ulp off the JAX package's
    scales for some columns."""
    amax = bf.abs().amax(dim=1, keepdim=True)
    return torch.clamp(amax / amax.new_full((), q_max), min=1e-8)


def quantize_expert_weights(b: torch.Tensor):
    """Per-(expert, out-column) absmax int8 quantization of expert weights
    ``[E, K, N]`` → ``(b_q int8, scale f32 [E, 1, N])`` (≙
    ``quantize_expert_weights``, ``:123``; the same f32 operations, so the
    pools and scales equal the JAX package's)."""
    bf = b.float()
    scale = _absmax_scale(bf, 127.0)
    return torch.clamp(torch.round(bf / scale), -127, 127).to(torch.int8), scale


def quantize_expert_weights_fp8(b: torch.Tensor):
    """Per-(expert, out-column) absmax fp8 e4m3 quantization (≙
    ``quantize_expert_weights_fp8``, ``:142``): 448 in 127's seat, the
    rounding left to the dtype cast (nearest even)."""
    bf = b.float()
    scale = _absmax_scale(bf, _FP8_MAX)
    return torch.clamp(bf / scale, -_FP8_MAX, _FP8_MAX).to(FP8_DTYPE), scale


def is_quantized(b: torch.Tensor) -> bool:
    """A one-byte scaled bank: int8 (w8) or fp8 e4m3."""
    return b.dtype in WEIGHT_CODE


def resolve_w8(b: torch.Tensor, scale: torch.Tensor | None, cfg: GroupGemmConfig):
    """The scaled-format config axes at an op boundary (≙ ``resolve_w8``,
    ``:159``): with ``cfg.w8`` or ``cfg.fp8`` and no caller scale, quantize
    the float bank now; an explicit ``scale`` (the pre-quantized serving
    path) wins. Returns ``(b, scale)``."""
    if scale is not None or not (cfg.w8 or cfg.fp8):
        return b, scale
    if not b.is_floating_point() or b.dtype == FP8_DTYPE:
        fmt = "fp8" if cfg.fp8 else "w8"
        raise ValueError(
            f"GroupGemmConfig.{fmt} with a pre-quantized weight bank needs the matching "
            f"per-(expert, out-column) scale (pass scale=, from quantize_expert_weights"
            f"{'_fp8' if cfg.fp8 else ''})")
    return (quantize_expert_weights_fp8 if cfg.fp8 else quantize_expert_weights)(b)


def check_scale(b: torch.Tensor, scale: torch.Tensor | None, what: str) -> None:
    """A scale marks a one-byte bank and has its ``[E, 1, N]`` shape; a
    one-byte bank needs one."""
    if scale is None:
        if is_quantized(b):
            raise ValueError(f"{what}: an {b.dtype} bank needs its scale [E, 1, N]")
        return
    if not is_quantized(b):
        raise ValueError(f"{what}: a scale marks an int8/fp8 bank, got {b.dtype}")
    if tuple(scale.shape) != (b.shape[0], 1, b.shape[2]):
        raise ValueError(f"{what}: scale {tuple(scale.shape)} for a bank {tuple(b.shape)}")


class OperandFormat:
    """The weight operand format of the plain twins (≙ ``OperandFormat``,
    ``ops/gg_pipeline.py:43-80``; the CUDA kernels do the same in
    ``csrc/gemm_core.cuh``): with a scale, the B tile is upcast to A's type
    before the product (exact: |q| <= 127 and every e4m3 value fit bf16),
    and the f32 accumulator is multiplied by the scale row once, before the
    output cast and anything downstream."""

    @staticmethod
    def mxu_b(b_tile: torch.Tensor, a_dtype: torch.dtype, scale) -> torch.Tensor:
        return b_tile.to(a_dtype) if scale is not None else b_tile

    @staticmethod
    def fold(acc: torch.Tensor, s_row) -> torch.Tensor:
        return acc * s_row if s_row is not None else acc


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU: ``jax.nn.gelu``'s default, and the one
    activation the kernels fuse."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def _group_gemm_plain(a_sorted, b, expert_ids, bm, out_dtype, act_fn, scale=None,
                      valid_rows=None):
    """Plain version (≙ ``_group_gemm_xla``): sort the blocks by expert
    (stable), one f32 product per expert's run of blocks, unsort; padded
    rows are computed as rows of their block's clamped expert (and scale).
    With a ``scale``, :class:`OperandFormat`'s upcast and fold. With the
    ragged map ``valid_rows``, rows at or past their block's live count are
    exact zeros, masked after the fold (``:204-238``). The expert counts
    cross to the host."""
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
            y = a3[start * bm:(start + c) * bm] @ OperandFormat.mxu_b(b[e], a.dtype, scale).float()
            parts.append(OperandFormat.fold(y, None if scale is None else scale[e].float()))
            start += c
    y = torch.cat(parts).reshape(nb, bm, n) if parts else a3.new_zeros((0, bm, n))
    out = torch.empty_like(y)
    out[order] = y
    if valid_rows is not None:
        live = torch.arange(bm, device=out.device)[None, :, None] < valid_rows.to(
            out.device).long()[:, None, None]
        out = torch.where(live, out, 0.0)
    return out.reshape(nb * bm, n).to(out_dtype)


_group_gemm_plain.calls = 0


def check_group_operands(a, b, expert_ids, out_dtype, act_fn, what, scale=None,
                         valid_rows=None) -> int:
    """What K8/K24/K29 and K9/K25/K30 take on the card; returns the row
    block size. A one-byte bank comes with its f32 scale on the same
    device, both contiguous, and rows of a multiple of 16 weights; a ragged
    map is contiguous int32 of the ids' shape."""
    if scale is None:
        check_operands(a, b, out_dtype, what)
    else:
        check_operands(a, a, out_dtype, what)
        if b.device != a.device or scale.device != a.device or scale.dtype != torch.float32:
            raise ValueError(f"{what}: the bank and its f32 scale must be on {a.device}")
        if not (b.is_contiguous() and scale.is_contiguous()):
            raise ValueError(f"{what} takes a contiguous bank and scale")
        if b.shape[2] % WEIGHT_ROW_QUANTUM:
            raise ValueError(
                f"{what}: an {b.dtype} bank's rows ride 16-byte copies on the card; "
                f"N={b.shape[2]} must be a multiple of {WEIGHT_ROW_QUANTUM}")
    if act_fn not in (None, gelu):
        raise ValueError(f"{what}: the kernel fuses only the tanh GELU (group_gemm.gelu)")
    for name, ids in (("expert_ids", expert_ids), ("valid_rows", valid_rows)):
        if ids is not None and (ids.dtype != torch.int32 or ids.device != a.device
                                or not ids.is_contiguous() or ids.shape != expert_ids.shape):
            raise ValueError(f"{what}: {name} must be contiguous int32 {tuple(expert_ids.shape)} "
                             f"on {a.device}")
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
    valid_rows: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    config: GroupGemmConfig | None = None,
    out_dtype: torch.dtype | None = None,
    act_fn=None,
) -> torch.Tensor:
    """``out[i*bm:(i+1)*bm] = act?(a_sorted[i*bm:(i+1)*bm]) @ b[expert_ids[i]]``
    with f32 accumulation. a_sorted ``[t_pad, K]`` bf16 or f32, b ``[E, K,
    N]`` of the same type, expert_ids ``[t_pad / block_m]`` int32 (read on
    the card, no host sync) → ``[t_pad, N]`` in ``out_dtype`` (default A's).
    ``act_fn`` (:func:`gelu`) runs on every A element in f32, rounded back
    to A's type, before the product.

    With ``scale`` (``[E, 1, N]`` f32), `b` is an int8 or fp8 e4m3 pool
    (K24): ``(act?(A_i) @ upcast(b[e])) * scale[e]``, the scale folded into
    the f32 accumulator before the cast. ``config.w8``/``.fp8`` quantize a
    float bank first (:func:`resolve_w8`).

    With ``config.ragged`` (K29), ``valid_rows`` (``[t_pad / block_m]``
    int32, the alignment's map from ``moe_align_block_size(...,
    ragged=True)``) bounds each block's live rows: a 128-row tile at or
    past it is not computed and comes back zero, and so do the dead rows
    of a live tile, after the scale fold. Live rows equal the padded
    kernel's bit for bit (the same tile, the same sum order)."""
    cfg = check_config(config)
    if cfg.ragged and valid_rows is None:
        raise ValueError(
            "GroupGemmConfig.ragged needs the alignment's per-block valid_rows map — build "
            "it with moe_align_block_size(..., ragged=True) / moe_align_ranked(..., "
            "ragged=True)")
    valid_rows = valid_rows if cfg.ragged else None
    b, scale = resolve_w8(b, scale, cfg)
    check_scale(b, scale, "group_gemm")
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
        return _group_gemm_plain(a_sorted, b, expert_ids, bm, out_dtype, act_fn, scale,
                                 valid_rows)
    check_group_operands(a_sorted, b, expert_ids, out_dtype, act_fn, "group_gemm", scale,
                         valid_rows)
    out = torch.empty((t_pad, n), dtype=out_dtype, device=a_sorted.device)
    if n == 0:
        return out
    lib = _build.library("group_gemm", _PROTOTYPES)
    rc = lib.tdt_group_gemm(
        a_sorted.data_ptr(), b.data_ptr(), None if scale is None else scale.data_ptr(),
        expert_ids.data_ptr(), None if valid_rows is None else valid_rows.data_ptr(),
        out.data_ptr(), t_pad, n, k, n_exp, bm, DTYPE_CODE[a_sorted.dtype],
        weight_code(a_sorted, b), DTYPE_CODE[out_dtype], int(act_fn is not None),
        _build.stream_of(a_sorted),
    )
    _build.check(lib, rc, "group_gemm")
    count_launch(group_gemm, launch_key(scale, valid_rows))
    return out


group_gemm.launches = 0         # K8
group_gemm.scaled_launches = 0  # K24
group_gemm.ragged_launches = 0  # K29, all three formats


def launch_key(scale, valid_rows) -> str:
    """The counter a grouped launch bumps: the ragged kernel (any format),
    else the padded one by format."""
    if valid_rows is not None:
        return "ragged_launches"
    return "launches" if scale is None else "scaled_launches"


def weight_code(a: torch.Tensor, b: torch.Tensor) -> int:
    """The kernels' dtype code of bank `b` under activations `a`."""
    return WEIGHT_CODE[b.dtype] if is_quantized(b) else DTYPE_CODE[a.dtype]


def group_gemm_w8(a_sorted, b_q, scale, expert_ids, *, valid_rows=None, config=None,
                  out_dtype=None, act_fn=None):
    """:func:`group_gemm` over an int8 pool from
    :func:`quantize_expert_weights` (≙ ``group_gemm_w8``, ``:400``)."""
    return group_gemm(a_sorted, b_q, expert_ids, valid_rows=valid_rows, scale=scale,
                      config=config, out_dtype=out_dtype, act_fn=act_fn)


def group_gemm_fp8(a_sorted, b_q, scale, expert_ids, *, valid_rows=None, config=None,
                   out_dtype=None, act_fn=None):
    """:func:`group_gemm` over an fp8 e4m3 pool from
    :func:`quantize_expert_weights_fp8` (≙ ``group_gemm_fp8``, ``:427``)."""
    return group_gemm(a_sorted, b_q, expert_ids, valid_rows=valid_rows, scale=scale,
                      config=config, out_dtype=out_dtype, act_fn=act_fn)


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
    its grouping permutation): the rank-major rows take the same path.
    A ragged config is refused: its dW kernel is not ported."""
    cfg = check_config(config)
    refuse_ragged_backward(cfg)
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


def refuse_ragged_backward(cfg: GroupGemmConfig) -> None:
    """The backward of a ragged config needs the ragged dW kernel
    (``gg_pipeline.py:159`` with ``ragged=True``), which is not ported."""
    if cfg.ragged:
        raise NotImplementedError(
            "the grouped-GEMM backward with ragged rows (GroupGemmConfig.ragged) is not "
            "ported yet (ROADMAP B16, ragged dW): serve with ragged rows, train padded")

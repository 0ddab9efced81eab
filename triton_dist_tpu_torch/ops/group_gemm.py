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
as zeros; dead rows of a live tile are zeroed after the scale fold.

``config.backend="ragged_dot"`` is the JAX package's XLA sentinel
(``_ragged_dot_group_gemm``, ``:177``): not a Pallas kernel but
``jax.lax.ragged_dot`` over the same padded layout, so the port serves it
with plain PyTorch (:func:`_group_gemm_plain`), on the card too. It needs
globally expert-sorted blocks, and ignores ``ragged``. The chunked
overlap schedules (``chunks_per_shard``, ``span_policy``) are read by the
overlapped pair (K32/K33); this grid GEMM has nothing to chunk.

K34 is K11 under the ragged-row policy (``group_gemm_dw`` with
``config.ragged`` and the alignment's ``valid_rows`` map; the TPU body's
ragged branch, ``gg_pipeline.py:159`` with ``ragged=True``): each 64-row
step of a block at or past its live count is skipped, and a step that
straddles it has the dead rows of A and G zeroed in shared memory before
the product.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.gemm import (
    DTYPE_CODE,
    SM90_TILES,
    WIDE_TILE_COST,
    GemmPlan,
    check_operands,
    tma_ok,
)
from triton_dist_tpu_torch.utils import cdiv, count_call, count_launch, sm_count

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"tdt_group_gemm": [_P] * 6 + [_I] * 9 + [_P],
               "tdt_group_gemm_sm90": [_P] * 6 + [_I] * 9 + [_P],
               "tdt_group_gemm_dw": [_P] * 5 + [_I] * 6 + [_P]}
# the M tile of the bf16 engines (csrc/gemm_core.cuh Bf16Engine::BM, the
# wgmma engine's 128-row tiles); the f32 engine's 64 divides it
TILE_M = 128
# the wgmma engine lists a layout's row tiles in shared memory
# (csrc/group_gemm.cu MAX_ROW_TILES): longer layouts take the mma.sync one
MAX_ROW_TILES = 2048

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
    constructions keep their meaning). The kernels read ``block_m``,
    ``ragged``, the formats and ``backend``; the overlapped pair also
    ``chunks_per_shard`` and ``span_policy``. The TPU tiles ``block_n`` /
    ``block_k`` are carried for the mapping only."""

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
    """``cfg``, or the default ``GroupGemmConfig()``."""
    return cfg or GroupGemmConfig()


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


def group_gemm_plan(t_pad: int, n: int, k: int, dtype: torch.dtype, *, scaled: bool = False,
                    aligned: bool = True, sms: int = 132,
                    engine: str | None = None) -> GemmPlan:
    """K8/K24/K29's engine and tile for ``[t_pad, k]`` rows in `dtype` over
    a bank ``[E, k, n]`` on a card of `sms` SMs; `scaled` marks a one-byte
    bank, `aligned` whether A, the bank and the output are 16-byte aligned.

    bf16 A over a bf16 bank runs the persistent ``wgmma`` + TMA kernel
    (``"wgmma"``) when :func:`~triton_dist_tpu_torch.ops.gemm.tma_ok` and the
    layout has at most :data:`MAX_ROW_TILES` row tiles, else the mma.sync
    engine (``"mma_sync"``); a one-byte bank keeps its engine (``"mma_sync"``
    under bf16 A), f32 A the FMA one (``"f32"``). The ``wgmma`` tile is K1's
    128x256 unless 128x128 finishes in fewer waves of `sms` tiles, a wide
    tile's wave weighing :data:`~triton_dist_tpu_torch.ops.gemm.WIDE_TILE_COST`
    narrow ones, counted over every row tile of the layout (the live ones
    are known only on the card). `engine` forces one (the chip script's A/B);
    a forced engine that cannot take the operands raises."""
    if dtype == torch.float32:
        if engine not in (None, "f32"):
            raise ValueError(f"no {engine} engine for an f32 group_gemm")
        return GemmPlan("f32")
    if dtype != torch.bfloat16:
        raise TypeError(f"group_gemm takes bf16 or f32 rows, not {dtype}")
    ok = (not scaled and k > 0 and tma_ok(n, k, aligned)
          and cdiv(t_pad, TILE_M) <= MAX_ROW_TILES)
    engine = engine or ("wgmma" if ok else "mma_sync")
    if engine == "mma_sync":
        return GemmPlan("mma_sync")
    if engine != "wgmma" or not ok:
        raise ValueError(f"no {engine} engine for [{t_pad}, {k}] @ [E, {k}, {n}] "
                         f"(scaled={scaled}, aligned={aligned})")
    tiles = [cdiv(t_pad, bm) * cdiv(n, bn) for bm, bn in (SM90_TILES[0], SM90_TILES[1])]
    waves = [cdiv(t, sms) for t in tiles]
    config = 0 if WIDE_TILE_COST * waves[0] <= waves[1] else 1
    return GemmPlan("wgmma", config, tiles[config], min(tiles[config], sms))


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
    _engine: str | None = None,
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
    kernel's bit for bit (the same tile, the same sum order).

    On the card :func:`group_gemm_plan` picks the engine: bf16 over a bf16
    bank that TMA can load runs the ``wgmma`` + TMA kernel
    (``tdt_group_gemm_sm90``, also counted on ``wgmma_launches``; with the
    GELU, a pass activates A's live rows once into a scratch copy first),
    everything else the mma.sync / FMA kernel (``tdt_group_gemm``).
    ``_engine`` forces one (the chip script's A/B, never the main path).

    With ``config.backend="ragged_dot"`` this is
    :func:`_group_gemm_plain`, plain PyTorch on any device, ``ragged``
    ignored."""
    cfg = check_config(config)
    if cfg.backend == "ragged_dot":
        t_pad, nb = a_sorted.shape[0], expert_ids.shape[0]
        if nb == 0 or t_pad % nb or t_pad // nb != cfg.block_m:
            raise ValueError(f"rows per block of {t_pad} rows in {nb} blocks != config.block_m "
                             f"{cfg.block_m}: alignment and GEMM must use the same block size")
        # the sentinel's contract on globally expert-sorted blocks (``:177``:
        # pad rows are rows of their block's clamped expert, a scaled bank
        # upcast, the scale folded per row after the f32 product) is the
        # plain twin's: the same per-expert f32 products of the same rows
        b, scale = resolve_w8(b, scale, cfg)
        return _group_gemm_plain(a_sorted, b, expert_ids, cfg.block_m,
                                 out_dtype or a_sorted.dtype, act_fn, scale)
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (a_sorted, b, out))
    p = group_gemm_plan(t_pad, n, k, a_sorted.dtype, scaled=scale is not None, aligned=aligned,
                        sms=sm_count(a_sorted.get_device()), engine=_engine)
    lib = _build.library("group_gemm", _PROTOTYPES)
    ids_ptr = expert_ids.data_ptr()
    valid_ptr = None if valid_rows is None else valid_rows.data_ptr()
    if p.engine == "wgmma":
        scratch = torch.empty_like(a_sorted) if act_fn is not None else None
        rc = lib.tdt_group_gemm_sm90(
            a_sorted.data_ptr(), b.data_ptr(), ids_ptr, valid_ptr, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), t_pad, n, k, n_exp, bm,
            DTYPE_CODE[out_dtype], int(act_fn is not None), p.config, p.grid,
            _build.stream_of(a_sorted),
        )
        _build.check(lib, rc, "group_gemm (wgmma)")
        count_launch(group_gemm, "wgmma_launches")
    else:
        rc = lib.tdt_group_gemm(
            a_sorted.data_ptr(), b.data_ptr(), None if scale is None else scale.data_ptr(),
            ids_ptr, valid_ptr, out.data_ptr(), t_pad, n, k, n_exp, bm,
            DTYPE_CODE[a_sorted.dtype], weight_code(a_sorted, b), DTYPE_CODE[out_dtype],
            int(act_fn is not None), _build.stream_of(a_sorted),
        )
        _build.check(lib, rc, "group_gemm")
    count_launch(group_gemm, launch_key(scale, valid_rows))
    return out


group_gemm.launches = 0         # K8
group_gemm.scaled_launches = 0  # K24
group_gemm.ragged_launches = 0  # K29, all three formats
group_gemm.wgmma_launches = 0   # K8/K29 on the wgmma + TMA engine


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


def _group_gemm_dw_plain(a_sorted, g_sorted, expert_ids, n_exp, bm, valid_rows=None):
    """Plain version (≙ ``_group_gemm_dw_xla``, ``:453-470``): for each
    expert, the sum of ``A_blkᵀ · G_blk`` over its row blocks in block
    order, each product and the sum in f32; an expert with no blocks is
    zero. With the ragged map ``valid_rows``, each block's rows at or past
    its live count are zeroed on A first, as the reference does, and on G
    too, so junk in G's dead rows (a NaN) never reaches a sum. The ids
    cross to the host."""
    count_call(_group_gemm_dw_plain)
    nb = expert_ids.shape[0]
    k, n = a_sorted.shape[1], g_sorted.shape[1]
    a3 = a_sorted.reshape(nb, bm, k).float()
    g3 = g_sorted.reshape(nb, bm, n).float()
    if valid_rows is not None:
        live = torch.arange(bm, device=a3.device)[None, :, None] < valid_rows.to(
            a3.device).long()[:, None, None]
        a3, g3 = torch.where(live, a3, 0.0), torch.where(live, g3, 0.0)
    out = torch.zeros((n_exp, k, n), dtype=torch.float32, device=a_sorted.device)
    for i, e in enumerate(expert_ids.tolist()):
        out[e] += a3[i].t() @ g3[i]
    return out


_group_gemm_dw_plain.calls = 0


def group_gemm_dw(
    a_sorted: torch.Tensor,
    g_sorted: torch.Tensor,
    expert_ids: torch.Tensor,
    n_exp: int,
    *,
    valid_rows: torch.Tensor | None = None,
    config: GroupGemmConfig | None = None,
    assume_sorted: bool = False,
) -> torch.Tensor:
    """Transpose grouped GEMM, the expert-weight gradient of
    :func:`group_gemm` (≙ ``group_gemm_dw``, ``:553``): ``dW[e] = Σ_{blocks
    i of e} A_iᵀ · G_i``. a_sorted ``[t_pad, K]`` and g_sorted ``[t_pad,
    N]`` block-aligned rows in the same order (bf16 or f32, one type),
    expert_ids ``[t_pad / block_m]`` (clamped into ``[0, n_exp)`` first) →
    ``[n_exp, K, N]`` f32; an expert with no rows comes back exactly zero.
    K11 on the card.

    With ``config.ragged`` (K34), ``valid_rows`` (``[t_pad / block_m]``
    int32, the alignment's map) bounds each block's live rows: the rows at
    or past it take no part in the sum, whatever A and G hold there.

    Each expert's blocks are summed in block order whatever the layout, so
    ``assume_sorted`` (the JAX package's licence to skip its grouping
    permutation) is taken for the API's sake and changes nothing: the
    rank-major rows take the same path."""
    del assume_sorted
    cfg = check_config(config)
    t_pad, k = a_sorted.shape
    n = g_sorted.shape[1]
    nb = expert_ids.shape[0]
    if g_sorted.shape[0] != t_pad or nb == 0 or t_pad % nb or t_pad // nb != cfg.block_m:
        raise ValueError(f"group_gemm_dw shapes {tuple(a_sorted.shape)}, "
                         f"{tuple(g_sorted.shape)}, {nb} blocks of {cfg.block_m} rows")
    if cfg.ragged and valid_rows is None:
        raise ValueError(
            "GroupGemmConfig.ragged needs the alignment's per-block valid_rows map — build "
            "it with moe_align_block_size(..., ragged=True) / moe_align_ranked(..., "
            "ragged=True)")
    valid_rows = valid_rows if cfg.ragged else None
    bm = cfg.block_m
    ids = expert_ids.clamp(0, n_exp - 1).contiguous()
    if a_sorted.device.type == "cpu":
        return _group_gemm_dw_plain(a_sorted, g_sorted, ids, n_exp, bm, valid_rows)
    check_operands(a_sorted, g_sorted, torch.float32, "group_gemm_dw")
    for name, t in (("expert_ids", ids), ("valid_rows", valid_rows)):
        if t is not None and (t.dtype != torch.int32 or t.device != a_sorted.device
                              or not t.is_contiguous() or t.shape != expert_ids.shape):
            raise ValueError(f"group_gemm_dw: {name} must be contiguous int32 "
                             f"{tuple(expert_ids.shape)} on {a_sorted.device}")
    if bm % TILE_M:
        raise ValueError(f"group_gemm_dw: block_m={bm} must be a multiple of {TILE_M} "
                         f"on the card")
    out = torch.empty((n_exp, k, n), dtype=torch.float32, device=a_sorted.device)
    if k == 0 or n == 0:
        return out.zero_()
    lib = _build.library("group_gemm", _PROTOTYPES)
    rc = lib.tdt_group_gemm_dw(
        a_sorted.data_ptr(), g_sorted.data_ptr(), ids.data_ptr(),
        None if valid_rows is None else valid_rows.data_ptr(), out.data_ptr(),
        t_pad, k, n, n_exp, bm, DTYPE_CODE[a_sorted.dtype], _build.stream_of(a_sorted),
    )
    _build.check(lib, rc, "group_gemm_dw")
    count_launch(group_gemm_dw, "launches" if valid_rows is None else "ragged_launches")
    return out


group_gemm_dw.launches = 0         # K11
group_gemm_dw.ragged_launches = 0  # K34

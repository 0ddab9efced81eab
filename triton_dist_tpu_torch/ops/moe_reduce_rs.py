"""The MoE down-projection: grouped GEMM + top-k weighted combine +
reduce-scatter (≙ ``triton_dist_tpu/ops/moe_reduce_rs.py``) → K10 at
world > 1 (the overlapped entry, whose Pallas site is
``_moe_rs_overlap_fused`` at ``:236`` with the body
``ops/gg_pipeline.py:576 make_moe_rs_overlap_kernel``), K8 at world 1.

Two entries, as in the JAX package:

- :func:`moe_reduce_rs`, the sequential composition: the grouped GEMM (K8,
  with the activation fused on its A tiles and an f32 output), the top-k
  combine (``moe_utils.scatter_add_unsorted``, plain PyTorch as XLA's work
  is in the JAX package), and the reduce-scatter (K12 on the card; the
  identity at world 1). The tensor-parallel MoE forward takes it at world
  1.
- :func:`moe_reduce_rs_overlap`, over the rank-major rows of the
  overlapped up-projection. After the entry barrier (K4: every rank has
  read its landing slots from the previous call), for each destination
  rank c, own chunk last as in K7: K8 computes c's aligned rows
  ``h_sorted[c]`` @ ``w_down[e]`` in f32 into a private buffer; the combine
  kernel (``csrc/dist.cu``) sums each of c's tokens' ``topk`` rows in k
  order with their routing weights — the gather form, with the inverse
  map of ``moe_utils.ranked_combine_rows``: deterministic, no atomics —
  and stores the partial straight into c's landing slot for this rank; a
  one-warp kernel raises c's flag. Once every rank has issued its pushes
  (the host rendezvous), the reduce kernel waits (bounded) for the peers'
  flags and sums the n slots in rank order in f32. The partials travel in
  the output type, as the TPU kernel's pushes do, so a bf16 output carries
  one rounding of each peer's partial more than the plain version.

Both take ``scale=`` (``[E, 1, H]`` f32) for an int8 or fp8 e4m3 ``w_down``,
or ``config.w8``/``.fp8`` to quantize a float one at the op boundary: the
grouped GEMMs are then K24, whose store folds the scale into each row
before the combine weights multiply it (``gg_pipeline.py:718-721``); the
overlapped entry over K24 is K26.

Both take ``valid_rows=`` under ``config.ragged`` (the ragged-row policy):
the grouped GEMMs are then K29, which skip the dead tiles and write dead
rows as zeros. The combine reads only the rows of real assignments, all
live, so the overlapped entry (K31) gives K10's output bit for bit, and it
still pushes and flags every destination, even one whose blocks are all
dead (its receiver waits for it).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    dist_launch,
    dist_lib,
    launch_barrier,
    max_consumer_blocks,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE
from triton_dist_tpu_torch.ops.group_gemm import (
    _group_gemm_plain,
    check_config,
    check_group_operands,
    check_scale,
    group_gemm,
    launch_key,
    resolve_w8,
)
from triton_dist_tpu_torch.ops.moe_utils import MoEAlignment, scatter_add_unsorted
from triton_dist_tpu_torch.ops.reduce_scatter import reduce_scatter
from triton_dist_tpu_torch.utils import axis_index, axis_size, count_call, count_launch


def moe_reduce_rs(
    h_sorted: torch.Tensor,
    w_down: torch.Tensor,
    alignment: MoEAlignment,
    topk_weights: torch.Tensor,
    *,
    ctx=None,
    n_tokens: int,
    config=None,
    rs_config=None,
    rs_method: str = "auto",
    out_dtype: torch.dtype | None = None,
    act_fn=None,
    scale: torch.Tensor | None = None,
    valid_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sequential MoE down-projection (≙ ``moe_reduce_rs``, ``:63``; call
    inside ``ctx.run``). h_sorted ``[t_pad, f_loc]`` aligned rows (with
    ``act_fn``, pre-activation: the activation rides the grouped GEMM's A
    tiles), w_down ``[E, f_loc, H]``, topk_weights ``[n_tokens, topk]`` of
    the gathered tokens → this rank's ``[n_tokens / world, H]``; the
    reduce-scatter takes `rs_method` and `rs_config`
    (``ops/reduce_scatter.py``) as at ``:104``. ``scale`` marks `w_down`
    as an int8/fp8 pool (``:93-97``). Under ``config.ragged`` the grouped
    GEMM (K29) takes `valid_rows`, by default the alignment's map."""
    out_dtype = out_dtype or h_sorted.dtype
    if valid_rows is None:
        valid_rows = alignment.valid_rows
    y_sorted = group_gemm(h_sorted, w_down, alignment.expert_ids, valid_rows=valid_rows,
                          scale=scale, config=config, out_dtype=torch.float32, act_fn=act_fn)
    partial = scatter_add_unsorted(y_sorted, alignment, topk_weights, n_tokens)
    return reduce_scatter(partial.to(out_dtype), ctx=ctx, method=rs_method, config=rs_config)


def _moe_rs_overlap_xla(h_sorted, w_down, expert_ids, dst_ids, w_rows, ctx, m_out, out_dtype,
                        scale=None, valid_rows=None):
    """Plain version (≙ ``_moe_rs_overlap_xla``, ``:125``): the plain
    grouped GEMM over every row in f32 (the scale folded; with the ragged
    map `valid_rows`, dead rows zero), a scatter-add combine per
    destination chunk (rows in order), then the f32 sum over ranks of this
    rank's chunk, cast."""
    count_call(_moe_rs_overlap_xla)
    n, nb, bm = dst_ids.shape
    h = w_down.shape[2]
    valid = None if valid_rows is None else valid_rows.reshape(-1)
    y = _group_gemm_plain(h_sorted, w_down, expert_ids.reshape(-1), bm, torch.float32,
                          None, scale, valid).reshape(n, nb * bm, h)
    w = w_rows.reshape(n, nb * bm, 1).float()
    dst = dst_ids.reshape(n, nb * bm).long()
    partial = torch.zeros((n, m_out, h), dtype=torch.float32, device=h_sorted.device)
    for c in range(n):
        partial[c].index_add_(0, dst[c], y[c] * w[c])
    partial = partial.reshape(n * m_out, h)
    if axis_size(ctx) > 1:
        partial = ctx.psum_scatter(partial, 0)
    return partial.to(out_dtype)


_moe_rs_overlap_xla.calls = 0


def moe_reduce_rs_overlap(
    h_sorted: torch.Tensor,
    w_down: torch.Tensor,
    expert_ids: torch.Tensor,
    dst_ids: torch.Tensor,
    w_rows: torch.Tensor,
    *,
    ctx=None,
    m_out: int,
    combine_rows: torch.Tensor | None = None,
    valid_rows: torch.Tensor | None = None,
    config=None,
    out_dtype: torch.dtype | None = None,
    scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Overlapped MoE down-projection + combine + reduce-scatter (≙
    ``moe_reduce_rs_overlap``, ``:281``; call inside ``ctx.run``).
    h_sorted ``[n * t_pad_loc, f_loc]`` rank-major aligned rows (the
    activated output of the overlapped up-projection), w_down ``[E, f_loc,
    H]``, expert_ids ``[n, nb]``, ``(dst_ids, w_rows)`` ``[n, nb, bm]`` from
    ``ranked_scatter_meta``, and on the card ``combine_rows`` ``[n, m_out,
    topk]`` from ``ranked_combine_rows`` (the kernel's gather-form combine
    reads it; the plain version scatters by ``dst_ids``) → this rank's
    fully reduced ``[m_out, H]``. World 1 has nothing to reduce over and
    takes :func:`moe_reduce_rs` on the card, as the MoE forward routes it.
    ``scale`` (``[E, 1, H]``) marks `w_down` as an int8/fp8 pool (K26), as
    does ``config.w8``/``.fp8`` over this rank's float shard
    (``:300-342``). ``config.ragged`` needs ``valid_rows`` ``[n, nb]`` (the
    ranked alignment's map) and takes K31."""
    cfg = check_config(config)
    out_dtype = out_dtype or h_sorted.dtype
    bm = dst_ids.shape[2]
    if bm != cfg.block_m:
        raise ValueError(f"alignment block {bm} != config.block_m {cfg.block_m}")
    if cfg.ragged and valid_rows is None:
        raise ValueError("GroupGemmConfig.ragged needs the ranked alignment's valid_rows map "
                         "(moe_align_ranked(..., ragged=True))")
    valid_rows = valid_rows if cfg.ragged else None
    w_down, scale = resolve_w8(w_down, scale, cfg)
    check_scale(w_down, scale, "moe_reduce_rs_overlap")
    if h_sorted.device.type == "cpu":
        return _moe_rs_overlap_xla(h_sorted, w_down, expert_ids, dst_ids, w_rows, ctx, m_out,
                                   out_dtype, scale, valid_rows)
    if axis_size(ctx) == 1:
        raise ValueError("moe_reduce_rs_overlap at world 1 on the card: take moe_reduce_rs")
    if combine_rows is None:
        raise ValueError("moe_reduce_rs_overlap on the card combines by the inverse rows: "
                         "pass combine_rows (moe_utils.ranked_combine_rows)")
    return _moe_rs_overlap_fused(h_sorted, w_down, expert_ids, w_rows, combine_rows, ctx,
                                 m_out, out_dtype, cfg, scale, valid_rows)


moe_reduce_rs_overlap.launches = 0         # K10
moe_reduce_rs_overlap.scaled_launches = 0  # K26
moe_reduce_rs_overlap.ragged_launches = 0  # K31, all three formats


def _moe_rs_overlap_fused(h_sorted, w_down, expert_ids, w_rows, combine_rows, ctx, m_out,
                          out_dtype, cfg, scale, valid_rows):
    n, me = axis_size(ctx), axis_index(ctx)
    t_pad_loc = h_sorted.shape[0] // n
    h = w_down.shape[2]
    topk = combine_rows.shape[2]
    check_group_operands(h_sorted[:t_pad_loc], w_down, expert_ids[0], torch.float32, None,
                         "moe_reduce_rs_overlap", scale)
    if combine_rows.shape != (n, m_out, topk) or combine_rows.dtype != torch.int32:
        raise ValueError(f"combine_rows must be int32 [{n}, {m_out}, topk]")
    rows = combine_rows.contiguous()
    w = w_rows.reshape(n, t_pad_loc).float().contiguous()
    out = torch.empty((m_out, h), dtype=out_dtype, device=h_sorted.device)
    lib = dist_lib()
    stream = stream_ptr(torch.cuda.current_stream())
    code = DTYPE_CODE[out_dtype]

    slot = m_out * h * out.element_size()
    recv = ctx.symmetric("moe_rs.recv", n * slot)
    arrive = symmetric_flags(ctx, "moe_rs.arrive")
    flags = symmetric_flags(ctx, "moe_rs.flags")
    launch = dist_launch(ctx, "moe_rs")
    launch_barrier(ctx, launch, arrive, torch.cuda.current_stream())
    for s in range(1, n + 1):
        c = (me + s) % n  # own chunk last
        y = group_gemm(h_sorted[c * t_pad_loc:(c + 1) * t_pad_loc], w_down, expert_ids[c],
                       valid_rows=None if valid_rows is None else valid_rows[c],
                       scale=scale, config=cfg, out_dtype=torch.float32)
        rc = lib.tdt_moe_combine_push(y.data_ptr(), rows[c].data_ptr(), w[c].data_ptr(),
                                      recv.peer_addr(c, me * slot), m_out, h, topk, code,
                                      stream)
        _build.check(lib, rc, "moe_reduce_rs_overlap combine")
        if c != me:
            sig = (ctypes.c_longlong * 1)(flags.peer_addr(c, 4 * me))
            rc = lib.tdt_put_signal(0, None, None, 0, 1, sig, launch.epoch, stream)
            _build.check(lib, rc, "moe_reduce_rs_overlap signal")
    ctx.rendezvous()  # every rank's pushes are issued before any reduce waits
    slots = recv.view(me, (n, m_out, h), out_dtype)
    rc = lib.tdt_moe_rs_reduce(slots.data_ptr(), out.data_ptr(), m_out * h, code, n, me,
                               flags.peer_addr(me), launch.epoch, max_consumer_blocks(ctx),
                               *launch.wait, stream)
    _build.check(lib, rc, "moe_reduce_rs_overlap reduce")
    count_launch(moe_reduce_rs_overlap, launch_key(scale, valid_rows))
    return out

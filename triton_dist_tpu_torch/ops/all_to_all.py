"""The padded-slab all-to-all, the transport of expert-parallel MoE dispatch
and combine (≙ ``triton_dist_tpu/ops/all_to_all.py``): ``A2AConfig``
(``:72``), ``fast_all_to_all`` (``:195``) with its plain version
``_fast_all_to_all_xla`` (``:51``), ``all_to_all_post_process`` (``:327``)
and ``fast_all_to_all_op`` (``:373``); the Pallas kernels ``_a2a_kernel``
(``:92``) → K27 and ``_a2a_chunked_kernel`` (``:136``) → K28, both in
``csrc/a2a.cu``.

Slab ``d`` of this rank's ``[n, max_m, hidden]`` send buffer lands as slab
``me`` of rank ``d``'s recv; the valid counts and any per-slab metadata
ride the same exchange as one int32 payload ``[n, 1 + K]``. Full slabs
always move. On the card a call is two launches with one host rendezvous
between them: the push puts every slab into its receiver's symmetric
workspace (the own slab is a local copy) and raises a flag per (sender,
chunk); the collect waits on the flags, bounded, and copies the landed
slabs into the private recv. ``A2AConfig.chunks_per_shard > 1`` moves every
slab in that many spans (``chunk_schedule``), issued and consumed
chunk-major, with a flag each (K28). ``puts_per_slab`` is the least number
of pieces a chunk moves in; the kernel also cuts a chunk into pieces of at
most 256 KiB so that every slab rides several blocks.

Over a group of a 2-D runtime (``ctx.group("tp")``, the two phases of
the hierarchical EP dispatch) the same kernels run over the group's
members, with the group's own workspace, flags and epochs.

The plain version exchanges the slabs over the runtime's host collective
(``DistContext.all_to_all``, the twin of XLA's ``all_to_all``); the tests
hold the kernels to it bit for bit (a copy). Unlike the JAX entry, which
degrades to its golden through ``resilience.guarded_call``, a kernel that
does not build or launch raises here.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build, config
from triton_dist_tpu_torch.ops.common import chunk_schedule, max_consumer_blocks, stream_ptr
from triton_dist_tpu_torch.resilience import watchdog
from triton_dist_tpu_torch.resilience.sites import MAX_SPANS
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SPANS = [ctypes.POINTER(_I), _I, _I]  # spans, n_spans, pieces
_WAIT = [_P, _LL, _I, _P]               # diag, timeout ns, family code, stream
_PROTOTYPES = {
    "tdt_all_to_all_push": [_P] * 4 + [_LL, _I, _I, _P, _LL, _LL, _P, _P] + _SPANS
    + [_I, _I, _I, _I, _P],
    "tdt_all_to_all_collect": [_P, _P, _LL, _I, _I, _P, _LL, _LL, _P] + _SPANS
    + [_I, _I, _I, _I] + _WAIT,
}
PIECE_BYTES = 256 * 1024  # the most a block moves of one chunk
MAX_PIECES = 64           # csrc/a2a.cu MAX_PIECES


@dataclasses.dataclass(frozen=True)
class A2AConfig:
    """The JAX package's transport schedule, field for field (≙
    ``A2AConfig``, ``:72``): ``puts_per_slab`` splits each chunk into at
    least that many puts; ``chunks_per_shard > 1`` moves each slab as that
    many chunks, each with its flag, issued and waited for chunk-major
    (K28); 1 is the whole-slab kernel (K27)."""

    puts_per_slab: int = 1
    chunks_per_shard: int = 1


def _payload(splits: torch.Tensor, meta: torch.Tensor | None, n: int) -> torch.Tensor:
    payload = splits.reshape(n, 1).to(torch.int32)
    if meta is None:
        return payload
    if meta.shape[0] != n:
        raise ValueError(f"meta {tuple(meta.shape)}: dim 0 must be the world {n}")
    return torch.cat([payload, meta.reshape(n, -1).to(torch.int32)], dim=1)


def _unpack(recv, rpayload, meta):
    rsplits = rpayload[:, 0]
    if meta is None:
        return recv, rsplits
    return recv, rsplits, rpayload[:, 1:].reshape(meta.shape)


def _fast_all_to_all_xla(tokens: torch.Tensor, splits: torch.Tensor, ctx, *, meta=None):
    """Plain version (≙ ``_fast_all_to_all_xla``): the slabs and the payload
    exchanged over the runtime's host all-to-all, the same slab contract as
    the kernels."""
    count_call(_fast_all_to_all_xla)
    payload = _payload(splits, meta, tokens.shape[0])
    return _unpack(ctx.all_to_all(tokens), ctx.all_to_all(payload), meta)


_fast_all_to_all_xla.calls = 0


def fast_all_to_all(
    tokens: torch.Tensor,
    splits: torch.Tensor,
    *,
    meta: torch.Tensor | None = None,
    ctx=None,
    config: A2AConfig | None = None,
):
    """Exchange padded token slabs between the ranks (call inside
    ``ctx.run``; ≙ ``fast_all_to_all``). tokens ``[n, max_m, hidden]``:
    slab ``p`` holds the ``splits[p]`` tokens this rank sends to rank ``p``
    (rows past the count are padding, and move too); splits ``[n]`` int;
    meta an optional ``[n, ...]`` int32 per-slab payload (expert ids,
    bitcast scales) that rides the same exchange.

    Returns ``(recv, recv_splits[, recv_meta])``: slab ``j`` of ``recv``
    holds what rank ``j`` sent here (``recv_splits[j]`` valid rows). On the
    card K27 (one chunk a slab) or K28 (``config.chunks_per_shard > 1``);
    on the CPU the plain version."""
    cfg = config or A2AConfig()
    n = axis_size(ctx)
    if tokens.dim() != 3 or tokens.shape[0] != n:
        raise ValueError(f"fast_all_to_all: tokens {tuple(tokens.shape)} must be [{n}, max_m, "
                         f"hidden]")
    if n == 1:  # the world-1 all-to-all is the identity
        return _unpack(tokens, _payload(splits, meta, 1), meta)
    if tokens.device.type == "cpu":
        return _fast_all_to_all_xla(tokens, splits, ctx, meta=meta)
    spans = chunk_schedule(tokens.shape[1], max(1, int(cfg.chunks_per_shard)))
    if len(spans) > MAX_SPANS:
        raise ValueError(f"chunks_per_shard={cfg.chunks_per_shard}: the all-to-all takes at "
                         f"most {MAX_SPANS} chunks a slab")
    payload = _payload(splits, meta, n)
    if len(spans) > 1:
        recv, rpayload = _a2a_chunked(tokens, payload, ctx, spans, cfg.puts_per_slab)
    else:
        recv, rpayload = _a2a(tokens, payload, ctx, spans, cfg.puts_per_slab)
    return _unpack(recv, rpayload, meta)


def _a2a_launch(tokens, payload, ctx, spans, puts_per_slab, family):
    """K27/K28: every allocation first, the push, the ranks meet (every
    push is issued before any collect waits), the collect. One epoch counter
    and one flag set serve both kernels; the workspace region alternates
    with the epoch's parity (``csrc/a2a.cu``)."""
    n, me = ctx.world, ctx.rank
    tokens, payload = tokens.contiguous(), payload.contiguous()
    max_m = tokens.shape[1]
    row_bytes = tokens.shape[2] * tokens.element_size()
    w = payload.shape[1]
    pay_off = -(-n * max_m * row_bytes // 16) * 16
    region = -(-(pay_off + 4 * n * w) // 256) * 256
    ws = ctx.symmetric("all_to_all.ws", 2 * region)
    flags = ctx.symmetric("all_to_all.flags", 4 * n * MAX_SPANS)
    count = ctx.symmetric("all_to_all.count", 4 * n * MAX_SPANS)
    recv, rpayload = torch.empty_like(tokens), torch.empty_like(payload)
    epoch = ctx.next_epoch("all_to_all")
    at = (epoch % 2) * (ws.nbytes // 2 // 256 * 256)
    biggest = max(rows for _, rows in spans) * row_bytes
    pieces = min(MAX_PIECES, max(int(puts_per_slab), -(-biggest // PIECE_BYTES), 1))
    flat = [v for span in spans for v in span]
    c_spans = (ctypes.c_int * len(flat))(*flat)
    lib = _build.library("a2a", _PROTOTYPES)
    stream = stream_ptr(torch.cuda.current_stream())
    table = ws.table[me].data_ptr()
    flag_table = flags.table[me].data_ptr()
    rc = lib.tdt_all_to_all_push(
        tokens.data_ptr(), payload.data_ptr(), recv.data_ptr(), rpayload.data_ptr(), row_bytes,
        max_m, w, table, at, pay_off, flag_table, count.peer_addr(me), c_spans, len(spans),
        pieces, n, me, epoch, int(config.debug_comm_delay), stream)
    _build.check(lib, rc, "all_to_all push")
    ctx.rendezvous()
    rc = lib.tdt_all_to_all_collect(
        recv.data_ptr(), rpayload.data_ptr(), row_bytes, max_m, w, table, at, pay_off,
        flag_table, c_spans, len(spans), pieces, n, me, epoch, max_consumer_blocks(ctx),
        *watchdog.wait_args(ctx.diag[me], family), stream)
    _build.check(lib, rc, "all_to_all collect")
    return recv, rpayload


def _a2a(tokens, payload, ctx, spans, puts_per_slab):
    """K27: one chunk a slab, one flag per (sender, receiver)."""
    out = _a2a_launch(tokens, payload, ctx, spans, puts_per_slab, "all_to_all")
    count_launch(_a2a)
    return out


def _a2a_chunked(tokens, payload, ctx, spans, puts_per_slab):
    """K28: a flag per (sender, chunk), chunk-major issue and waits."""
    out = _a2a_launch(tokens, payload, ctx, spans, puts_per_slab, "all_to_all_chunked")
    count_launch(_a2a_chunked)
    return out


_a2a.launches = 0
_a2a_chunked.launches = 0


def all_to_all_post_process(recv: torch.Tensor, recv_splits: torch.Tensor):
    """Compact the padded recv slabs to the front (≙
    ``all_to_all_post_process``): ``(packed, total)``, ``packed[:total]``
    the valid rows in slab order and zeros after them, shapes static."""
    n, max_m, hidden = recv.shape
    dev = recv.device
    flat = recv.reshape(n * max_m, hidden)
    idx = torch.arange(n * max_m, device=dev)
    slab, pos = idx // max_m, idx % max_m
    splits = recv_splits.long()
    valid = pos < splits[slab]
    offsets = torch.cumsum(splits, 0) - splits
    keys = torch.where(valid, offsets[slab] + pos, n * max_m)
    order = torch.argsort(keys, stable=True)
    packed = torch.where(valid[order][:, None], flat[order], torch.zeros((), dtype=recv.dtype,
                                                                         device=dev))
    return packed, splits.sum().to(torch.int32)


def fast_all_to_all_op(tokens: torch.Tensor, splits: torch.Tensor, *, ctx=None,
                       config: A2AConfig | None = None):
    """The op-level entry, per rank (≙ ``fast_all_to_all_op``, whose
    ``[n, n, max_m, hidden]`` global array is sharded on dim 0: this is
    one rank's ``[n, max_m, hidden]`` of it): ``(recv, recv_splits)``. At
    world 1 the identity."""
    return fast_all_to_all(tokens, splits, ctx=ctx, config=config)

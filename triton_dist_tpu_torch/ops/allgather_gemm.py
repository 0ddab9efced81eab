"""Column-parallel projection ``all_gather(a) @ b`` (≙
``triton_dist_tpu/ops/allgather_gemm.py::ag_gemm``; its fused path
``_ag_gemm_fused`` at ``:341`` launches ``_ag_gemm_kernel`` at ``:69``, or
``_ag_gemm_chunked_kernel`` at ``:109`` when ``AGGemmConfig.chunks_per_shard
> 1`` splits a shard into spans, ``:443-470``) → K6 on a full mesh with one
span, K15 on a ring or with spans, K1 (``gemm_only``) at world 1.

The TPU kernel rides a ring: step s forwards shard ``me - s`` to the right
neighbour while the MXU multiplies it, so compute order equals arrival
order. On the H100 (≙ the reference's Hopper design) the gather moves on
copy engines and a persistent consumer waits per shard:

- comm stream: once ``a`` is ready, K4 as the entry barrier (every rank has
  finished reading its gather workspace from the previous call), then one
  ``cudaMemcpyAsync`` of ``a`` into slot ``me`` of every rank's workspace
  and a one-warp kernel that sets each rank's flag ``me`` to this launch's
  epoch;
- once every rank has issued its producer (a host rendezvous: no device
  wait is issued before what it waits for), compute stream: the consumer
  (``csrc/dist.cu``), a K1-derived persistent
  kernel of at most floor(SMs / ranks) - 2 blocks, walks the shards in
  arrival order ``me, me-1, ...`` and waits (bounded) for a shard's flag
  before its first tile of it.

On a context whose ranks do not form a full mesh (``ctx.full_mesh``
False), or with more than one span, the shards ride the ring as on the
TPU: K15 (``csrc/ring.cu``), one persistent kernel a rank that walks steps
s = 0 .. n-1 over shard ``me - s``, forwards each span to the right
neighbour before its GEMM tiles and waits (bounded) for the left
neighbour's span of the step before. With one span it is
``_ag_gemm_kernel``'s own ring schedule. The spans are
``ops/common.py::ring_spans``, the JAX package's. On the CPU the ring runs
its plain version over the rank threads, span by span in arrival order.

Over a pair of axes (``axis=("dp", "tp")``, or a ``ctx`` that is a group
over two axes; ≙ the tuple dispatch at ``:365-423`` and ``_ag_gemm_2d`` at
``:247-290``): ``_ag_gemm_2d_kernel`` (``:179``) → K37 (``csrc/ring.cu``),
K36's forwarding of each chunk (an inner ring over this rank's outer row,
every chunk on down the outer ring as it lands) into the pair's gather
workspace, with K15's GEMM tiles on each chunk after its forwards are
issued, in that 2-D arrival order. Rows are in the flattened group's
order ``(o * n_i + i) * m_loc``, so every output tile runs K15's K loop
over the same rows. Its plain version gathers on the host and multiplies
chunk by chunk in the same order. A pair with one outer or one inner rank
is the 1-D op over the other axis. The port has no DCN axis (every axis
rides the card), so the reference's DCN branches (``:371-411``) are left
out; more than two axes raise as the reference's assert does.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    dist_launch,
    gemm_only,
    launch_barrier,
    max_consumer_blocks,
    pair_dims,
    ring_2d_launch,
    ring_launch,
    ring_spans,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE, _matmul_plain, check_operands
from triton_dist_tpu_torch.resilience.sites import MAX_SPANS
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch, group_of


@dataclasses.dataclass(frozen=True)
class AGGemmConfig:
    """Tunables (≙ ``AGGemmConfig``, ``:50-66``, field for field). The CUDA
    kernels fix their own tiles, so ``block_n``/``block_k`` are carried for
    the mapping only; ``block_m`` quantizes the spans as in the JAX package;
    ``chunks_per_shard`` > 1 splits each ring hop's shard into spans."""

    block_m: int = 512
    block_n: int = 2048
    block_k: int = 512
    chunks_per_shard: int = 1


def _ag_gemm_xla(a, b, ctx, gather_output, out_dtype):
    """Plain version (≙ ``_ag_gemm_xla``): gather on the host rendezvous,
    then the plain product."""
    count_call(_ag_gemm_xla)
    ag = ctx.all_gather(a, 0)
    out = _matmul_plain(ag, b, out_dtype)
    return (out, ag) if gather_output else out


_ag_gemm_xla.calls = 0


def _ag_gemm_ring_plain(a, b, ctx, gather_output, out_dtype, spans):
    """Plain version of K15: gather on the host rendezvous, then each
    shard's spans in the ring's arrival order ``me, me-1, ...``, f32
    products cast once."""
    count_call(_ag_gemm_ring_plain)
    n, me = ctx.world, ctx.rank
    m_loc = a.shape[0]
    ag = ctx.all_gather(a, 0)
    out = torch.empty((n * m_loc, b.shape[1]), dtype=out_dtype, device=a.device)
    bf = b.float()
    for s in range(n):
        c = (me - s) % n
        for off, rows in spans:
            lo = c * m_loc + off
            out[lo:lo + rows] = (ag[lo:lo + rows].float() @ bf).to(out_dtype)
    return (out, ag) if gather_output else out


_ag_gemm_ring_plain.calls = 0


def ag_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    ctx=None,
    config: AGGemmConfig | None = None,
    gather_output: bool = False,
    out_dtype: torch.dtype | None = None,
    axis=None,
):
    """a ``[m_loc, K]`` token shard, b ``[K, n_loc]`` column shard →
    ``[world * m_loc, n_loc]`` (plus the gathered ``[world * m_loc, K]`` A
    if `gather_output`). Call inside ``ctx.run``; ``ctx=None`` is world 1,
    where the gather is the identity and this is :func:`gemm_only`.
    `axis` (a name or a pair) runs over ``ctx``'s group over it; over a
    pair, K37."""
    cfg = config or AGGemmConfig()
    out_dtype = out_dtype or a.dtype
    ctx = group_of(ctx, axis)
    if axis_size(ctx) == 1:
        out = gemm_only(a, b, out_dtype=out_dtype)
        return (out, a) if gather_output else out
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ag_gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if len(ctx.axis_names) > 1:
        if len(ctx.axis_names) > 2:
            raise ValueError(f"at most 2 axes supported, got {ctx.axis_names}")
        return _ag_gemm_2d(a, b, ctx, gather_output, out_dtype)
    spans = ring_spans(a.shape[0], cfg.chunks_per_shard, cfg.block_m)
    ring = len(spans) > 1 or not ctx.full_mesh
    if a.device.type == "cpu":
        if ring:
            return _ag_gemm_ring_plain(a, b, ctx, gather_output, out_dtype, spans)
        return _ag_gemm_xla(a, b, ctx, gather_output, out_dtype)
    if ring:
        return _ag_gemm_ring(a, b, ctx, gather_output, out_dtype, spans)
    return _ag_gemm_fused(a, b, ctx, gather_output, out_dtype)


ag_gemm.launches = 0


def push_shards(ctx, a: torch.Tensor, family: str, spans=None):
    """The producer side of K6, K9 and K32, on the rank's comm stream: once
    `a` is ready, the family's entry barrier (every rank has finished
    reading its gather workspace from the previous call), one copy-engine
    put of `a` into slot ``me`` of every rank's workspace and a one-warp
    kernel that raises each rank's flag ``me`` to this launch's epoch; then
    the host rendezvous (every rank's producer is issued before any
    consumer waits). With more than one of `spans` (``(offset, rows)`` of
    `a`'s rows, K32), one put per span in list order instead, each raising
    slot ``me * MAX_SPANS + j`` of every rank's chunk flags, and the waits
    record the family ``{family}_chunked``. Returns ``(launch, this rank's
    gathered workspace [world * rows, K], this rank's flag address)``."""
    n, me = ctx.world, ctx.rank
    shard = a.numel() * a.element_size()
    row = shard // max(1, a.shape[0])
    ws = ctx.symmetric(f"{family}.ws", n * shard)
    arrive = symmetric_flags(ctx, f"{family}.arrive")
    if spans is None or len(spans) == 1:
        flags = symmetric_flags(ctx, f"{family}.flags")
        puts = [(0, a.shape[0], 4 * me)]
        launch = dist_launch(ctx, family)
    else:
        flags = ctx.symmetric(f"{family}.chunk_flags", 4 * n * MAX_SPANS)
        puts = [(off, rows, 4 * (me * MAX_SPANS + j)) for j, (off, rows) in enumerate(spans)]
        launch = dist_launch(ctx, family, f"{family}_chunked")
    comp, comm = torch.cuda.current_stream(), ctx.comm_stream
    ready = torch.cuda.Event()
    ready.record(comp)
    comm.wait_event(ready)
    launch_barrier(ctx, launch, arrive, comm)
    for off, rows, slot in puts:
        dsts = (ctypes.c_longlong * n)(*[ws.peer_addr(p, me * shard + off * row)
                                         for p in range(n)])
        sigs = (ctypes.c_longlong * n)(*[flags.peer_addr(p, slot) for p in range(n)])
        rc = launch.lib.tdt_put_signal(n, dsts, a.data_ptr() + off * row, rows * row, n, sigs,
                                       launch.epoch, stream_ptr(comm))
        _build.check(launch.lib, rc, f"{family} put")
    a.record_stream(comm)
    ctx.rendezvous()
    gathered = ws.view(me, (n * a.shape[0], *a.shape[1:]), a.dtype)
    return launch, gathered, flags.peer_addr(me)


def _ag_gemm_fused(a, b, ctx, gather_output, out_dtype):
    check_operands(a, b, out_dtype, "ag_gemm")
    n, me = ctx.world, ctx.rank
    m_loc, k = a.shape
    n_loc = b.shape[1]
    out = torch.empty((n * m_loc, n_loc), dtype=out_dtype, device=a.device)
    launch, gathered, flags = push_shards(ctx, a, "ag_gemm")

    # consumer: shards in arrival order, a bounded flag wait per shard
    rc = launch.lib.tdt_ag_gemm_consumer(
        gathered.data_ptr(), b.data_ptr(), out.data_ptr(), m_loc, n_loc, k,
        DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], n, me, flags,
        launch.epoch, max_consumer_blocks(ctx), launch.jitter, *launch.wait,
        stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(launch.lib, rc, "ag_gemm")
    count_launch(ag_gemm)
    if gather_output:
        # the workspace is reused by the next call: hand out a copy, taken
        # after the consumer has seen every shard land
        return out, gathered.clone()
    return out


def _ag_gemm_ring(a, b, ctx, gather_output, out_dtype, spans):
    """K15 (``csrc/ring.cu``): every allocation, then the ranks meet, then
    only the launch, then they meet again."""
    check_operands(a, b, out_dtype, "ag_gemm")
    n, me = ctx.world, ctx.rank
    m_loc, k = a.shape
    n_loc = b.shape[1]
    ws = ctx.symmetric("ag_gemm_ring.ws", n * m_loc * k * a.element_size())
    out = torch.empty((n * m_loc, n_loc), dtype=out_dtype, device=a.device)
    ring = ring_launch(ctx, "ag_gemm_ring", spans)
    ctx.rendezvous()
    rc = ring.lib.tdt_ring_ag_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.peer_addr(me), ws.peer_addr(ring.right),
        m_loc, n_loc, k, DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], ring.spans,
        ring.n_spans, n, me, *ring.flags, ring.launch.epoch, max_consumer_blocks(ctx),
        ring.launch.jitter, *ring.launch.wait, stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(ring.lib, rc, "ag_gemm ring")
    count_launch(_ag_gemm_ring)
    ctx.rendezvous()  # every rank's kernel is issued before any rank goes on
    if gather_output:
        # the workspace is the next call's landing buffer: hand out a copy
        return out, ws.view(me, (n * m_loc, k), a.dtype).clone()
    return out


_ag_gemm_ring.launches = 0


def _ag_gemm_2d(a, b, pair, gather_output, out_dtype):
    """The pair dispatch (≙ ``_ag_gemm_2d``, ``:247``)."""
    outer, inner = pair.axis_names
    n_o, n_i = pair_dims(pair)
    if n_o == 1 or n_i == 1:
        return ag_gemm(a, b, ctx=pair.group(inner if n_o == 1 else outer),
                       gather_output=gather_output, out_dtype=out_dtype)
    if a.device.type == "cpu":
        return _ag_gemm_2d_plain(a, b, pair, gather_output, out_dtype)
    return _ag_gemm_ring_2d(a, b, pair, gather_output, out_dtype)


def arrival_order_2d(me: int, n_o: int, n_i: int) -> list[int]:
    """The chunks of a pair's gather in K36/K37's arrival order at rank
    `me` = (me_o, me_i): this rank's outer row by inner steps ``(me_o, me_i
    - s)``, then each outer round t's row ``(me_o - t, me_i - s)``."""
    me_o, me_i = divmod(me, n_i)
    return [((me_o - t) % n_o) * n_i + (me_i - s) % n_i for t in range(n_o) for s in range(n_i)]


def _ag_gemm_2d_plain(a, b, pair, gather_output, out_dtype):
    """Plain version of K37: gather on the pair's host rendezvous, then
    each chunk's rows in the 2-D arrival order, f32 products cast once."""
    count_call(_ag_gemm_2d_plain)
    n_o, n_i = pair_dims(pair)
    m_loc = a.shape[0]
    ag = pair.all_gather(a, 0)
    out = torch.empty((pair.world * m_loc, b.shape[1]), dtype=out_dtype, device=a.device)
    bf = b.float()
    for c in arrival_order_2d(pair.rank, n_o, n_i):
        lo = c * m_loc
        out[lo:lo + m_loc] = (ag[lo:lo + m_loc].float() @ bf).to(out_dtype)
    return (out, ag) if gather_output else out


_ag_gemm_2d_plain.calls = 0


def _ag_gemm_ring_2d(a, b, pair, gather_output, out_dtype):
    """K37 (``csrc/ring.cu``): every allocation, then the pair's ranks
    meet, then only the launch, then they meet again."""
    check_operands(a, b, out_dtype, "ag_gemm")
    a, b = a.contiguous(), b.contiguous()
    n, me = pair.world, pair.rank
    m_loc, k = a.shape
    n_loc = b.shape[1]
    ws = pair.symmetric("ag_gemm_2d.ws", n * m_loc * k * a.element_size())
    out = torch.empty((n * m_loc, n_loc), dtype=out_dtype, device=a.device)
    ring = ring_2d_launch(pair, "ag_gemm_2d")
    pair.rendezvous()
    rc = ring.lib.tdt_ring_ag_gemm_2d(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.peer_addr(me), ws.peer_addr(ring.right),
        ws.peer_addr(ring.down), m_loc, n_loc, k, DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype],
        ring.n_o, ring.n_i, me, *ring.flags, ring.launch.epoch, max_consumer_blocks(pair),
        ring.launch.jitter, *ring.launch.wait, stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(ring.lib, rc, "ag_gemm_2d")
    count_launch(_ag_gemm_ring_2d)
    pair.rendezvous()  # every rank's kernel is issued before any rank goes on
    if gather_output:
        # the workspace is the next call's landing buffer: hand out a copy
        return out, ws.view(me, (n * m_loc, k), a.dtype).clone()
    return out


_ag_gemm_ring_2d.launches = 0

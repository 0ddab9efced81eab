"""Row-parallel projection ``psum_scatter(a @ b)`` (≙
``triton_dist_tpu/ops/gemm_reduce_scatter.py::gemm_rs``, dispatched at
``:417-445``): the ``scatter`` method ``_gemm_rs_scatter_kernel`` (``:99``)
→ K7, the ``ring`` method ``_gemm_rs_ring_kernel`` (``:147``) → K16 and,
with ``GemmRSConfig.chunks_per_shard > 1``, ``_gemm_rs_ring_chunked_kernel``
(``:187``) → K17; K1 (``gemm_only``) at world 1. Over a pair of axes
(``axis=("dp", "tp")``), ``_gemm_rs_2d`` (``:264-295``, dispatched at
``:343-395``) composes those kernels over the inner group with the
reduce-scatter over the outer one; the port has no DCN axis, so the
reference's DCN branches are left out.

The TPU kernel GEMMs the chunk for peer ``me+d`` (d = 1 .. n-1, own chunk
last) into a two-slot send buffer, pushes it into the peer's landing slot
``d-1``, and fuses the n-way reduction into its own chunk's epilogue.
:func:`gemm_rs_plan` picks the port's engine. bf16 that TMA can load runs
on K1's ``wgmma`` + TMA mainloop in two launches on the compute stream:

- K4 as the entry barrier (every rank's landing slots are free: its
  previous reduce has read them);
- one producer launch (``tdt_gemm_rs_produce``) that walks the n-1 peer
  chunks, rounds each output tile to the output type and stores it
  straight into rank ``me+d``'s landing slot ``d-1``; the block that stores
  a chunk's last tile raises that rank's flag ``d-1``. No send slots, no
  copy-engine puts, no flag kernels;
- once every rank has issued its producer (a host rendezvous: no device
  wait is issued before what it waits for), the consumer
  (``tdt_gemm_rs_reduce_sm90``): the own chunk's k loop, a bounded wait for
  the n-1 landing flags before the first epilogue, the landed chunks added
  in slot order in f32, one cast.

Other bf16 and f32 keep the earlier schedule (the mma.sync / FMA
consumer): K4, then for each d the K1 GEMM of peer ``me+d``'s row chunk
into send slot ``(d-1) % 2`` (at d >= 3 the stream first waits for the copy
that last read that slot, the send-slot reuse wait of ``:126-127``), each
chunk's copy-engine put and one-warp flag kernel on the comm stream, the
rendezvous, and ``tdt_gemm_rs_reduce``, a persistent K1-derived kernel that
runs its own chunk's k loop, waits (bounded) for the n-1 landing flags, and
adds the landed chunks in its f32 epilogue.

The ring (``csrc/ring.cu``, chosen by ``auto`` off a full mesh): one
persistent kernel a rank. At step s it GEMMs row chunk ``me-1-s``, adds the
partial that landed from the left in its f32 epilogue, rounds once to the
output type and stores straight into the right neighbour's landing slot s;
the last step's chunk is its own, fully reduced. K17 does the same per
span, with a flag per (step, span); one span is K16. So the ring rounds at
every hop (n - 1 times) where ``scatter`` rounds once: the plain version
:func:`_gemm_rs_ring_plain` follows the ring's hop order and rounding, and
runs on the CPU. :func:`~triton_dist_tpu_torch.ops.common.ring_gemm_plan`
picks the ring's engine: bf16 that TMA can load runs K1's ``wgmma`` + TMA
mainloop over the ring's step walk (``tdt_ring_gemm_rs_sm90``), where the
wait for the left partial of a (step, span) sits before its epilogue, not
before its k loop; other bf16 the mma.sync kernel, f32 the FMA kernel
(``tdt_ring_gemm_rs``).
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
    ring_gemm_plan,
    ring_launch,
    ring_order_sum,
    ring_spans,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.ops.gemm import (
    DTYPE_CODE,
    SM90_TILES,
    WIDE_TILE_COST,
    GemmPlan,
    check_operands,
    matmul,
    pointer_array,
    tma_ok,
)
from triton_dist_tpu_torch.ops.reduce_scatter import get_auto_reduce_scatter_method
from triton_dist_tpu_torch.utils import axis_size, cdiv, count_call, count_launch, group_of


@dataclasses.dataclass(frozen=True)
class GemmRSConfig:
    """Tunables (≙ ``GemmRSConfig``, ``:74-88``, field for field): the CUDA
    kernels fix their own tiles, ``block_m`` quantizes the spans, and
    ``chunks_per_shard`` > 1 splits each ring hop into spans (ring method
    only, as in the JAX package)."""

    block_m: int = 256
    block_n: int = 1024
    block_k: int = 512
    chunks_per_shard: int = 1


def _gemm_rs_xla(a, b, ctx, out_dtype):
    """Plain version (≙ ``_gemm_rs_xla``): each rank's f32 product, summed
    over ranks in f32 on the host rendezvous, this rank's rows cast."""
    count_call(_gemm_rs_xla)
    return ctx.psum_scatter(a.float() @ b.float(), 0).to(out_dtype)


_gemm_rs_xla.calls = 0


def _gemm_rs_ring_plain(a, b, ctx, out_dtype, spans):
    """Plain version of K16/K17: every rank's f32 product, exchanged on
    the host rendezvous, then this rank's chunk reduced span by span in the
    ring's hop order with a rounding to `out_dtype` at every hop."""
    count_call(_gemm_rs_ring_plain)
    n, me = ctx.world, ctx.rank
    m_loc = a.shape[0] // n
    parts = ctx.all_gather((a.float() @ b.float())[None], 0)[:, me * m_loc:(me + 1) * m_loc]
    out = torch.empty((m_loc, b.shape[1]), dtype=out_dtype, device=a.device)
    for off, rows in spans:
        out[off:off + rows] = ring_order_sum(parts[:, off:off + rows], me, n, out_dtype)
    return out


_gemm_rs_ring_plain.calls = 0


def gemm_rs_plan(m_loc: int, n: int, k: int, world: int, dtype: torch.dtype, *,
                 aligned: bool = True, blocks: int = 31,
                 engine: str | None = None) -> GemmPlan:
    """K7's engine and tile for ``world`` row chunks of ``[m_loc, k] @ [k,
    n]`` a rank, the consumer on a persistent grid of at most `blocks`
    spinning blocks and the producer on ``blocks + 2`` (floor(SMs / ranks)
    when `blocks` is :func:`~triton_dist_tpu_torch.ops.common.max_consumer_blocks`);
    `aligned` says whether A, B and the output are 16-byte aligned.

    f32 runs the FMA consumer (``"f32"``). bf16 runs the producer and the
    consumer on K1's ``wgmma`` + TMA mainloop (``"wgmma"``) when
    :func:`~triton_dist_tpu_torch.ops.gemm.tma_ok`, else K1's GEMMs, the puts
    and the mma.sync consumer (``"mma_sync"``). The ``wgmma`` tile is K1's
    128x256 unless 128x128 finishes the producer's n-1 chunks in fewer waves
    of its grid, a wide tile's wave weighing
    :data:`~triton_dist_tpu_torch.ops.gemm.WIDE_TILE_COST` narrow ones.
    `engine` forces one (the chip script's A/B); a forced engine that cannot
    take the operands raises."""
    if dtype == torch.float32:
        if engine not in (None, "f32"):
            raise ValueError(f"no {engine} engine for an f32 gemm_rs")
        return GemmPlan("f32")
    if dtype != torch.bfloat16:
        raise TypeError(f"gemm_rs takes bf16 or f32, not {dtype}")
    ok = k > 0 and tma_ok(n, k, aligned)
    engine = engine or ("wgmma" if ok else "mma_sync")
    if engine == "mma_sync":
        return GemmPlan("mma_sync")
    if engine != "wgmma" or not ok:
        raise ValueError(f"no {engine} engine for {world} x [{m_loc}, {k}] @ [{k}, {n}] "
                         f"(aligned={aligned})")
    producers = blocks + 2
    own = [cdiv(m_loc, bm) * cdiv(n, bn) for bm, bn in (SM90_TILES[0], SM90_TILES[1])]
    waves = [cdiv((world - 1) * t, producers) for t in own]
    config = 0 if WIDE_TILE_COST * waves[0] <= waves[1] else 1
    return GemmPlan("wgmma", config, own[config], min(own[config], blocks),
                    producer_grid=min((world - 1) * own[config], producers))


def gemm_rs(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    ctx=None,
    method: str = "auto",
    config: GemmRSConfig | None = None,
    out_dtype: torch.dtype | None = None,
    axis=None,
    _engine: str | None = None,
) -> torch.Tensor:
    """a ``[M, k_loc]``, b ``[k_loc, N]`` → this rank's ``[M / world, N]``
    slice of the reduced product (call inside ``ctx.run``). ``ctx=None``
    is world 1, where the reduce-scatter is the identity and this is
    :func:`gemm_only`. `axis` (a name or a pair) runs over ``ctx``'s group
    over it; over a pair, the staged composition of ``_gemm_rs_2d``.

    K7 on the card counts on ``launches``, its ``wgmma`` engine also on
    ``wgmma_launches``; K16 on ``_gemm_rs_ring.launches`` and K17 on
    ``_gemm_rs_ring_chunked.launches``, each ``wgmma`` engine also on its
    ``wgmma_launches``. ``_engine`` forces K7's engine (``"wgmma"`` or
    ``"mma_sync"``, :func:`gemm_rs_plan`), or K16/K17's on a ring
    (:func:`~triton_dist_tpu_torch.ops.common.ring_gemm_plan`): the chip
    script's A/B, never the main path."""
    out_dtype = out_dtype or a.dtype
    ctx = group_of(ctx, axis)
    if ctx is not None and len(ctx.axis_names) > 1:
        if len(ctx.axis_names) > 2:
            raise ValueError(f"at most 2 axes supported, got {ctx.axis_names}")
        return _gemm_rs_2d(a, b, ctx, method, config, out_dtype)
    n = axis_size(ctx)
    if n == 1:
        return gemm_only(a, b, out_dtype=out_dtype)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_rs shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[0] % n:
        raise ValueError(f"gemm_rs: M={a.shape[0]} must divide over {n} ranks")
    if method == "auto":
        method = get_auto_reduce_scatter_method(
            a.shape[0] // n * b.shape[1] * torch.empty((), dtype=out_dtype).element_size(),
            n, ctx.full_mesh,
        )
    method = {"scatter_reduce": "scatter"}.get(method, method)
    if method not in ("scatter", "ring"):
        raise ValueError(f"unknown gemm_rs method: {method!r} (want scatter|ring)")
    if method == "scatter":
        if a.device.type == "cpu":
            return _gemm_rs_xla(a, b, ctx, out_dtype)
        return _gemm_rs_scatter(a, b, ctx, out_dtype, _engine)
    cfg = config or GemmRSConfig()
    spans = ring_spans(a.shape[0] // n, cfg.chunks_per_shard, cfg.block_m)
    if a.device.type == "cpu":
        return _gemm_rs_ring_plain(a, b, ctx, out_dtype, spans)
    if len(spans) == 1:
        return _gemm_rs_ring(a, b, ctx, out_dtype, _engine)
    return _gemm_rs_ring_chunked(a, b, ctx, out_dtype, spans, _engine)


gemm_rs.launches = 0
gemm_rs.wgmma_launches = 0  # K7 on K1's wgmma + TMA mainloop (producer and consumer)


def _gemm_rs_2d(a, b, pair, method, config, out_dtype):
    """The pair composition (≙ ``_gemm_rs_2d``, ``:264-295``): the GEMM-RS
    over the inner axis on A's rows permuted slab-major, so inner rank i
    ends up owning slab ``concat_o (chunk (o, i))`` reduced over the inner
    group, then the standalone reduce-scatter over the outer axis. No new
    kernel: K7/K16/K17 over the inner group, then K12/K18 over the outer."""
    from triton_dist_tpu_torch.ops.reduce_scatter import reduce_scatter

    outer, inner = pair.axis_names
    n_o, n_i = pair.axis_size(outer), pair.axis_size(inner)
    if n_o == 1 or n_i == 1:
        return gemm_rs(a, b, ctx=pair.group(inner if n_o == 1 else outer), method=method,
                       config=config, out_dtype=out_dtype)
    m_tot, k_loc = a.shape
    if m_tot % (n_o * n_i):
        raise ValueError(f"gemm_rs: M={m_tot} must divide over {n_o * n_i} ranks")
    m_loc = m_tot // (n_o * n_i)
    a_perm = a.reshape(n_o, n_i, m_loc, k_loc).transpose(0, 1).reshape(m_tot, k_loc)
    part = gemm_rs(a_perm, b, ctx=pair.group(inner), method=method, config=config,
                   out_dtype=out_dtype)
    # gemm_rs and the standalone reduce-scatter name the scatter method
    # differently
    rs_method = {"scatter": "scatter_reduce"}.get(method, method)
    return reduce_scatter(part, ctx=pair.group(outer), method=rs_method)


def _gemm_rs_scatter(a, b, ctx, out_dtype, forced=None):
    check_operands(a, b, out_dtype, "gemm_rs")
    n, me = ctx.world, ctx.rank
    m_tot, k_loc = a.shape
    n_dim = b.shape[1]
    m_loc = m_tot // n
    chunk = m_loc * n_dim * torch.empty((), dtype=out_dtype).element_size()
    out = torch.empty((m_loc, n_dim), dtype=out_dtype, device=a.device)
    p = gemm_rs_plan(m_loc, n_dim, k_loc, n, a.dtype, blocks=max_consumer_blocks(ctx),
                     aligned=all(t.data_ptr() % 16 == 0 for t in (a, b, out)), engine=forced)
    recv = ctx.symmetric("gemm_rs.recv", (n - 1) * chunk)
    arrive = symmetric_flags(ctx, "gemm_rs.arrive")
    flags = symmetric_flags(ctx, "gemm_rs.flags")
    if p.engine == "wgmma":
        return _gemm_rs_sm90(a, b, ctx, out, p, recv, arrive, flags)
    send = ctx.symmetric("gemm_rs.send", 2 * chunk)
    launch = dist_launch(ctx, "gemm_rs")
    comp, comm = torch.cuda.current_stream(), ctx.comm_stream

    launch_barrier(ctx, launch, arrive, comp)
    sent = []
    for d in range(1, n):
        dst = (me + d) % n
        slot = send.view(me, (m_loc, n_dim), out_dtype, offset=((d - 1) % 2) * chunk)
        if d >= 3:
            comp.wait_event(sent[d - 3])  # the send slot is free again
        matmul(a[dst * m_loc:(dst + 1) * m_loc], b, out_dtype=out_dtype, out=slot)
        produced = torch.cuda.Event()
        produced.record(comp)
        comm.wait_event(produced)
        dst_addr = (ctypes.c_longlong * 1)(recv.peer_addr(dst, (d - 1) * chunk))
        sig = (ctypes.c_longlong * 1)(flags.peer_addr(dst, 4 * (d - 1)))
        rc = launch.lib.tdt_put_signal(1, dst_addr, slot.data_ptr(), chunk, 1, sig,
                                       launch.epoch, stream_ptr(comm))
        _build.check(launch.lib, rc, "gemm_rs put")
        done = torch.cuda.Event()
        done.record(comm)
        sent.append(done)

    ctx.rendezvous()
    landed = [recv.view(me, (m_loc, n_dim), out_dtype, offset=i * chunk) for i in range(n - 1)]
    own = a[me * m_loc:(me + 1) * m_loc]
    ptrs = pointer_array(landed)
    rc = launch.lib.tdt_gemm_rs_reduce(
        own.data_ptr(), b.data_ptr(), out.data_ptr(), m_loc, n_dim, k_loc,
        DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], n, ptrs, me, flags.peer_addr(me),
        launch.epoch, max_consumer_blocks(ctx), launch.jitter, *launch.wait,
        stream_ptr(comp),
    )
    _build.check(launch.lib, rc, "gemm_rs")
    count_launch(gemm_rs)
    # the next call's GEMMs overwrite the send slots these puts read
    comp.wait_stream(comm)
    return out


def _gemm_rs_sm90(a, b, ctx, out, p, recv, arrive, flags):
    """K7 on the ``wgmma`` + TMA engine, on the compute stream: K4, the one
    producer launch, the host rendezvous, the consumer."""
    n, me = ctx.world, ctx.rank
    m_loc, n_dim = out.shape
    k_loc = a.shape[1]
    chunk = out.numel() * out.element_size()
    count = ctx.symmetric("gemm_rs.count", 4 * n)  # tiles stored a peer chunk
    launch = dist_launch(ctx, "gemm_rs")
    comp = torch.cuda.current_stream()
    code = DTYPE_CODE[out.dtype]

    launch_barrier(ctx, launch, arrive, comp)
    rc = launch.lib.tdt_gemm_rs_produce(
        a.data_ptr(), b.data_ptr(), m_loc, n_dim, k_loc, code, n, me,
        recv.table[me].data_ptr(), flags.table[me].data_ptr(), count.peer_addr(me),
        launch.epoch, p.config, p.producer_grid, stream_ptr(comp),
    )
    _build.check(launch.lib, rc, "gemm_rs produce (wgmma)")
    ctx.rendezvous()  # every rank's producer is issued before any consumer waits
    landed = [recv.view(me, (m_loc, n_dim), out.dtype, offset=i * chunk) for i in range(n - 1)]
    ptrs = pointer_array(landed)
    rc = launch.lib.tdt_gemm_rs_reduce_sm90(
        a[me * m_loc:(me + 1) * m_loc].data_ptr(), b.data_ptr(), out.data_ptr(), m_loc, n_dim,
        k_loc, code, n, ptrs, me, flags.peer_addr(me), launch.epoch, p.config, p.grid,
        launch.jitter, *launch.wait, stream_ptr(comp),
    )
    _build.check(launch.lib, rc, "gemm_rs (wgmma)")
    count_launch(gemm_rs, "wgmma_launches")
    count_launch(gemm_rs)
    return out


def _ring_gemm_rs_launch(a, b, ctx, out_dtype, spans, counter, forced=None):
    """K16/K17 (``csrc/ring.cu``): every allocation, then the ranks meet,
    then only the launch (counted on `counter`), then they meet again. bf16
    that TMA can load runs the ``wgmma`` + TMA kernel (``ring_gemm_plan``),
    other bf16 the mma.sync kernel, f32 the FMA kernel."""
    check_operands(a, b, out_dtype, "gemm_rs")
    n, me = ctx.world, ctx.rank
    m_tot, k_loc = a.shape
    n_dim = b.shape[1]
    m_loc = m_tot // n
    elt = torch.empty((), dtype=out_dtype).element_size()
    recv = ctx.symmetric("gemm_rs_ring.recv", (n - 1) * m_loc * n_dim * elt)
    out = torch.empty((m_loc, n_dim), dtype=out_dtype, device=a.device)
    blocks = max_consumer_blocks(ctx)
    recv_me, recv_right = recv.peer_addr(me), recv.peer_addr((me + 1) % n)
    p = ring_gemm_plan(spans, n_dim, k_loc, n, a.dtype, blocks=blocks, engine=forced,
                       aligned=all(x % 16 == 0 for x in (a.data_ptr(), b.data_ptr(),
                                                         out.data_ptr(), recv_me, recv_right)),
                       what="gemm_rs ring")
    ring = ring_launch(ctx, "gemm_rs_ring", spans)
    ctx.rendezvous()
    stream = stream_ptr(torch.cuda.current_stream())
    if p.engine == "wgmma":
        rc = ring.lib.tdt_ring_gemm_rs_sm90(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), recv_me, recv_right, m_loc, n_dim,
            k_loc, DTYPE_CODE[out_dtype], ring.spans, ring.n_spans, n, me, *ring.flags,
            ring.launch.epoch, p.config, p.grid, ring.launch.jitter, *ring.launch.wait, stream,
        )
        _build.check(ring.lib, rc, "gemm_rs ring (wgmma)")
        count_launch(counter, "wgmma_launches")
    else:
        rc = ring.lib.tdt_ring_gemm_rs(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), recv_me, recv_right, m_loc, n_dim,
            k_loc, DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], ring.spans, ring.n_spans, n, me,
            *ring.flags, ring.launch.epoch, blocks, ring.launch.jitter, *ring.launch.wait,
            stream,
        )
        _build.check(ring.lib, rc, "gemm_rs ring")
    count_launch(counter)
    ctx.rendezvous()  # every rank's kernel is issued before any rank goes on
    return out


def _gemm_rs_ring(a, b, ctx, out_dtype, forced=None):
    """K16: the ring with one span a hop."""
    return _ring_gemm_rs_launch(a, b, ctx, out_dtype, ((0, a.shape[0] // ctx.world),),
                                _gemm_rs_ring, forced)


_gemm_rs_ring.launches = 0
_gemm_rs_ring.wgmma_launches = 0  # K16 on K1's wgmma + TMA mainloop


def _gemm_rs_ring_chunked(a, b, ctx, out_dtype, spans, forced=None):
    """K17: the ring with a flag per (step, span)."""
    return _ring_gemm_rs_launch(a, b, ctx, out_dtype, spans, _gemm_rs_ring_chunked, forced)


_gemm_rs_ring_chunked.launches = 0
_gemm_rs_ring_chunked.wgmma_launches = 0  # K17 on K1's wgmma + TMA mainloop

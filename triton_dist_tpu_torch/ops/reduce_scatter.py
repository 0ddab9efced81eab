"""K12, K18 and K23 · the standalone reduce-scatter (≙
``triton_dist_tpu/ops/reduce_scatter.py::reduce_scatter``, ``:280``): its
``scatter_reduce`` method runs ``_scatter_reduce_kernel`` (``:227``,
launched at ``:410``) → K12, its ``ring`` method ``_ring_rs_kernel``
(``:102``, the branch at ``:392-395``) → K18 and, with
``chunks_per_shard > 1``, ``_ring_rs_chunked_kernel`` (``:152``) → K23;
with the method choice
(``get_auto_reduce_scatter_method``, ``:68``), the config
(``ReduceScatterConfig``, ``:52``) and the plain versions
(``_reduce_scatter_xla``, ``:45``, and the ring's hop-order twin).

The TPU kernel pushes chunk ``me+d`` of this rank's partial straight into
landing slot ``d-1`` of rank ``me+d``, waits for its n-1 arrivals and sums
its own chunk and the slots in one f32 pass. The port keeps that schedule
and the world-4 rules of the other fused kernels (``csrc/dist.cu``):

- compute stream: K4 as the entry barrier (every rank has read its landing
  slots in its previous reduce);
- comm stream: for each d a copy-engine put of the chunk into the peer's
  landing slot ``d-1`` and a one-warp flag kernel;
- once every rank has issued its puts (the host rendezvous), compute
  stream: the reduce kernel, a persistent grid of at most floor(SMs /
  ranks) - 2 blocks that waits (bounded) for the n-1 flags and sums the
  own chunk, then slots 0 .. n-2, in f32, cast once.

The ring K18 (``csrc/ring.cu``, chosen by ``auto`` off a full mesh) is
one persistent kernel a rank: step 0 sends chunk ``me-1`` into the right
neighbour's landing slot 0 as it is; step s adds chunk ``me-1-s`` to the
partial that landed from the left in f32, rounds to the dtype and stores
into the right neighbour's slot s; the last step's sum is this rank's
chunk. K23 is the same kernel over spans of the chunk's rows (quantized
as ``:381-384`` quantizes them, ``ring_spans``): span j of step s goes on
as soon as span j of the left partial has landed. Every element keeps
K18's hop order and its rounding per hop, so K23 equals K18 bit for bit
and both are held to one plain version.

Over several axes (``axis=("dp", "tp")``, or a ``ctx`` that is a group
over several axes; ≙ the N-D peel at ``:316-360`` and
``reduce_scatter_2d`` at ``:430-452``): chunk ``(o, r)`` is laid out
slab-major ``(r, o)``, the reduce-scatter over the inner axes runs first
on the permuted rows, then the one over the outermost axis, so every row
crosses the outer axis once and already reduced over the inner ones. No
new kernel: K12/K18/K23 over each group. The port has no DCN axis, so the
reference's DCN branch (``:365-372``) is left out.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    dist_launch,
    launch_barrier,
    max_consumer_blocks,
    ring_launch,
    ring_order_sum,
    ring_spans,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch, group_of


@dataclasses.dataclass(frozen=True)
class ReduceScatterConfig:
    """Tunables (≙ ``ReduceScatterConfig``, ``:52``, field for field):
    ``method`` pins the kernel family when the call asks for "auto";
    ``block_m`` quantizes the spans; ``chunks_per_shard`` > 1 is the
    chunked ring (K23)."""

    block_m: int = 256
    block_n: int = 1024
    method: str | None = None
    chunks_per_shard: int = 1


def _reduce_scatter_xla(x: torch.Tensor, ctx) -> torch.Tensor:
    """Plain version (≙ ``jax.lax.psum_scatter(x, axis, tiled=True)``):
    this rank's row slice of the ranks' sum, in f32 in rank order, on the
    host rendezvous."""
    count_call(_reduce_scatter_xla)
    return ctx.psum_scatter(x, 0)


_reduce_scatter_xla.calls = 0


def _reduce_scatter_ring_plain(x: torch.Tensor, ctx) -> torch.Tensor:
    """Plain version of K18 and K23: every rank's partial, exchanged on the
    host rendezvous, then this rank's chunk summed in the ring's hop order
    with a rounding to the dtype at every hop (element-wise, so the spans
    do not enter)."""
    count_call(_reduce_scatter_ring_plain)
    n, me = ctx.world, ctx.rank
    m_loc = x.shape[0] // n
    parts = ctx.all_gather(x[None], 0)[:, me * m_loc:(me + 1) * m_loc]
    return ring_order_sum(parts, me, n, x.dtype)


_reduce_scatter_ring_plain.calls = 0


def get_auto_reduce_scatter_method(chunk_bytes: int, n_pes: int, full_mesh: bool = True) -> str:
    """Topology-based choice (≙ ``get_auto_reduce_scatter_method``): on a
    full mesh each chunk goes straight to its owner ("scatter_reduce",
    which ``gemm_rs`` calls "scatter"); without one it rides the ring
    ("ring"). No TPU crossover is carried over."""
    del chunk_bytes, n_pes
    return "scatter_reduce" if full_mesh else "ring"


def reduce_scatter(
    x: torch.Tensor, *, ctx=None, method: str = "auto",
    config: ReduceScatterConfig | None = None, axis=None,
) -> torch.Tensor:
    """x ``[m_tot, N]``, this rank's full partial array → this rank's
    ``[m_tot / world, N]`` row slice of the sum over ranks (call inside
    ``ctx.run``). ``ctx=None`` is world 1, where it is the identity.
    `axis` (a name or a tuple) runs over ``ctx``'s group over it; over
    several axes the staged composition (module docstring)."""
    cfg = config or ReduceScatterConfig()
    ctx = group_of(ctx, axis)
    if ctx is not None and len(ctx.axis_names) > 1:
        return _reduce_scatter_nd(x, ctx, method, config)
    n = axis_size(ctx)
    if n == 1:
        return x
    if x.ndim != 2 or x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {tuple(x.shape)} rows must divide over {n} ranks")
    if cfg.method is not None and method == "auto":
        method = cfg.method
    if method == "auto":
        method = get_auto_reduce_scatter_method(
            x.shape[0] // n * x.shape[1] * x.element_size(), n, ctx.full_mesh)
    if method == "ring":
        spans = ring_spans(x.shape[0] // n, cfg.chunks_per_shard, cfg.block_m)
        if x.device.type == "cpu":
            return _reduce_scatter_ring_plain(x, ctx)
        if len(spans) == 1:
            return _ring_reduce_scatter(x, ctx)
        return _ring_reduce_scatter_chunked(x, ctx, spans)
    if method != "scatter_reduce":
        raise ValueError(f"unknown reduce_scatter method: {method!r}")
    if x.device.type == "cpu":
        return _reduce_scatter_xla(x, ctx)
    return _scatter_reduce(x, ctx)


reduce_scatter.launches = 0


def _reduce_scatter_nd(x, ctx, method, config):
    """Peel the outermost axis (≙ ``:316-360``): the inner axes'
    reduce-scatter on the slab-major rows, then the outermost axis'."""
    a0, rest = ctx.axis_names[0], ctx.axis_names[1:]
    n0, nr = ctx.axis_size(a0), ctx.axis_size(rest)
    orig_ndim = x.ndim
    if x.ndim == 1:
        x = x.reshape(x.shape[0], 1)
    m_tot, nd = x.shape
    if m_tot % (n0 * nr):
        raise ValueError(f"reduce_scatter: {tuple(x.shape)} rows must divide over "
                         f"{n0 * nr} ranks")
    m0 = m_tot // (n0 * nr)
    xt = x.reshape(n0, nr, m0, nd).transpose(0, 1).reshape(m_tot, nd)
    part = reduce_scatter(xt, ctx=ctx.group(rest), method=method, config=config)
    out = reduce_scatter(part, ctx=ctx.group(a0), method=method, config=config)
    return out.reshape(m0) if orig_ndim == 1 else out


def reduce_scatter_2d(x: torch.Tensor, *, ctx=None, axes=None, method: str = "auto",
                      config: ReduceScatterConfig | None = None) -> torch.Tensor:
    """The hierarchical reduce-scatter over a pair ``(outer, inner)`` (≙
    ``reduce_scatter_2d``, ``:430``): the inner stage on permuted rows, then
    the outer one (module docstring); `ctx` the pair group, or a runtime
    and ``axes`` the pair."""
    return reduce_scatter(x, ctx=group_of(ctx, axes), method=method, config=config)


def _scatter_reduce(x, ctx):
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"reduce_scatter takes bf16 or f32 on the card, not {x.dtype}")
    n, me = ctx.world, ctx.rank
    x = x.contiguous()
    m_loc, n_dim = x.shape[0] // n, x.shape[1]
    chunk = m_loc * n_dim * x.element_size()
    recv = ctx.symmetric("reduce_scatter.recv", (n - 1) * chunk)
    arrive = symmetric_flags(ctx, "reduce_scatter.arrive")
    flags = symmetric_flags(ctx, "reduce_scatter.flags")
    launch = dist_launch(ctx, "reduce_scatter")
    comp, comm = torch.cuda.current_stream(), ctx.comm_stream

    launch_barrier(ctx, launch, arrive, comp)  # every peer's landing slots are free
    ready = torch.cuda.Event()
    ready.record(comp)
    comm.wait_event(ready)
    for d in range(1, n):
        dst = (me + d) % n
        dst_addr = (ctypes.c_longlong * 1)(recv.peer_addr(dst, (d - 1) * chunk))
        sig = (ctypes.c_longlong * 1)(flags.peer_addr(dst, 4 * (d - 1)))
        rc = launch.lib.tdt_put_signal(1, dst_addr, x.data_ptr() + dst * chunk, chunk, 1, sig,
                                       launch.epoch, stream_ptr(comm))
        _build.check(launch.lib, rc, "reduce_scatter put")
    x.record_stream(comm)
    ctx.rendezvous()  # every rank's puts are issued before any reduce waits
    out = torch.empty((m_loc, n_dim), dtype=x.dtype, device=x.device)
    rc = launch.lib.tdt_scatter_reduce(
        x.data_ptr() + me * chunk, recv.peer_addr(me), out.data_ptr(), m_loc * n_dim,
        DTYPE_CODE[x.dtype], n, me, flags.peer_addr(me), launch.epoch,
        max_consumer_blocks(ctx), launch.jitter, *launch.wait, stream_ptr(comp),
    )
    _build.check(launch.lib, rc, "reduce_scatter")
    count_launch(reduce_scatter)
    return out


def _ring_rs_launch(x, ctx, spans):
    """K18/K23 (``csrc/ring.cu``): every allocation, then the ranks meet,
    then only the launch."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"reduce_scatter takes bf16 or f32 on the card, not {x.dtype}")
    n, me = ctx.world, ctx.rank
    x = x.contiguous()
    m_loc, n_dim = x.shape[0] // n, x.shape[1]
    recv = ctx.symmetric("reduce_scatter_ring.recv", (n - 1) * m_loc * n_dim * x.element_size())
    out = torch.empty((m_loc, n_dim), dtype=x.dtype, device=x.device)
    ring = ring_launch(ctx, "reduce_scatter_ring", spans)
    ctx.rendezvous()
    rc = ring.lib.tdt_ring_reduce_scatter(
        x.data_ptr(), out.data_ptr(), recv.peer_addr(me), recv.peer_addr(ring.right), m_loc,
        n_dim, DTYPE_CODE[x.dtype], ring.spans, ring.n_spans, n, me, *ring.flags,
        ring.launch.epoch, max_consumer_blocks(ctx), ring.launch.jitter, *ring.launch.wait,
        stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(ring.lib, rc, "reduce_scatter ring")
    return out


def _ring_reduce_scatter(x, ctx):
    """K18: the ring with one span a hop."""
    out = _ring_rs_launch(x, ctx, ((0, x.shape[0] // ctx.world),))
    count_launch(_ring_reduce_scatter)
    ctx.rendezvous()  # every rank's kernel is issued before any rank goes on
    return out


_ring_reduce_scatter.launches = 0


def _reduce_scatter_nd(x, ctx, method, config):
    """Peel the outermost axis (≙ ``:316-360``): the inner axes'
    reduce-scatter on the slab-major rows, then the outermost axis'."""
    a0, rest = ctx.axis_names[0], ctx.axis_names[1:]
    n0, nr = ctx.axis_size(a0), ctx.axis_size(rest)
    orig_ndim = x.ndim
    if x.ndim == 1:
        x = x.reshape(x.shape[0], 1)
    m_tot, nd = x.shape
    if m_tot % (n0 * nr):
        raise ValueError(f"reduce_scatter: {tuple(x.shape)} rows must divide over "
                         f"{n0 * nr} ranks")
    m0 = m_tot // (n0 * nr)
    xt = x.reshape(n0, nr, m0, nd).transpose(0, 1).reshape(m_tot, nd)
    part = reduce_scatter(xt, ctx=ctx.group(rest), method=method, config=config)
    out = reduce_scatter(part, ctx=ctx.group(a0), method=method, config=config)
    return out.reshape(m0) if orig_ndim == 1 else out


def reduce_scatter_2d(x: torch.Tensor, *, ctx=None, axes=None, method: str = "auto",
                      config: ReduceScatterConfig | None = None) -> torch.Tensor:
    """The hierarchical reduce-scatter over a pair ``(outer, inner)`` (≙
    ``reduce_scatter_2d``, ``:430``): the inner stage on permuted rows, then
    the outer one (module docstring); `ctx` the pair group, or a runtime
    and ``axes`` the pair."""
    return reduce_scatter(x, ctx=group_of(ctx, axes), method=method, config=config)


def _ring_reduce_scatter_chunked(x, ctx, spans):
    """K23: the ring with a flag per (step, span)."""
    out = _ring_rs_launch(x, ctx, spans)
    count_launch(_ring_reduce_scatter_chunked)
    ctx.rendezvous()
    return out


_ring_reduce_scatter_chunked.launches = 0


def reduce_scatter_op(x: torch.Tensor, *, ctx=None, method: str = "auto",
                      config: ReduceScatterConfig | None = None) -> torch.Tensor:
    """Host-level entry (≙ ``reduce_scatter_op``, ``:471``): `x` ``[n,
    m_total]`` or ``[n, m_total, d]``, slice ``r`` rank ``r``'s whole
    partial array (moved to its device); returns ``[m_total, ...]``, the
    elementwise sum, rank ``r``'s rows ``[r m_loc, (r+1) m_loc)`` from rank
    ``r``, on `x`'s device. `method` and ``config.chunks_per_shard`` pick
    among K12 (``"scatter_reduce"``) and the rings K18/K23 (``"ring"``), as
    :func:`reduce_scatter` does."""
    n = axis_size(ctx)
    if x.shape[0] != n:
        raise ValueError(f"reduce_scatter_op: dim 0 of {tuple(x.shape)} must be the world {n}")
    if x.ndim not in (2, 3):
        raise ValueError(f"reduce_scatter_op wants [n, m] or [n, m, d]; got {tuple(x.shape)}")
    two_d = x.ndim == 3

    def one(part):
        part = part if two_d else part[:, None]
        out = reduce_scatter(part.contiguous(), ctx=ctx, method=method, config=config)
        return out if two_d else out[:, 0]

    if n == 1:
        return one(x[0])
    parts = ctx.run(lambda: one(x[ctx.rank].to(ctx.rank_device)))
    return torch.cat([p.to(x.device) for p in parts])

"""AllGather (≙ ``triton_dist_tpu/ops/allgather.py``): the full-mesh push
kernel ``_full_mesh_push_kernel`` (``:258``) → K5, the rings
``_ring_1d_kernel`` (``:73``) → K19, ``_ring_1d_chunked_kernel`` (``:144``)
→ K20, ``_ring_bidir_kernel`` (``:102``) → K21 and
``_ring_bidir_chunked_kernel`` (``:191``) → K22, their plain version
``_all_gather_xla`` (``:40``), and the method choice
``get_auto_all_gather_method`` (``:53``) re-keyed on the port's topology.

Full mesh (K5): after an entry barrier (K4: every peer has finished
reading its workspace), every rank stores its shard straight into every
peer's symmetric workspace and sets that peer's flag (``csrc/dist.cu``
push, one block a peer); once all ranks have issued their pushes, each
copies the peers' shards out of its own workspace as their flags rise
(collect).

Rings (K19-K22, ``csrc/ring.cu``): one persistent kernel a rank. Going
right, step s forwards shard ``me-s`` into the right neighbour's symmetric
gather workspace at that shard's rows; the bidirectional ring also goes
left, forwarding shard ``me+s`` into the left neighbour's (ceil((n-1)/2)
steps right, floor((n-1)/2) left). With ``chunks_per_shard > 1`` every
step moves in spans (``chunk_schedule(m, chunks)``, quantum 1, as
``:520`` calls it), and span j goes on as soon as span j of the previous
step has landed. Each landed shard is copied to ``out``.

Over two or more axes (``axis=("dp", "tp")``, or a ``ctx`` that is a group
over several axes; ≙ the tuple dispatch at ``:459-498``): the fused 2-D
ring over the two innermost axes (``all_gather_2d``, ``:372-432``), then
staged 1-D gathers outward, the outermost last, so shard ``(o, i)`` lands
at rows ``(o * n_i + i) * m`` as ``jax.lax.all_gather(x, axes,
tiled=True)`` lays it out. The 2-D ring ``_ring_2d_kernel`` (``:284``) →
K36 (``csrc/ring.cu``): after an entry barrier over the pair, an inner
ring gathers this rank's outer row, and every chunk goes on down the
outer ring the moment it lands (module notes of ``csrc/ring.cu``). A pair
with one outer or one inner rank is the 1-D gather over the other axis
(``:404-407``). The port has no DCN axis (every axis rides the card), so
the reference's DCN peel (``_is_dcn``) is left out.

A gather is a copy, so the plain version is also the golden: every kernel
is held to it bit for bit. On NVLink — or with every rank on one card —
all ranks reach all ranks, so a full mesh pushes directly and no TPU
crossover carries over; off a full mesh ``auto`` follows the JAX
package's branches without its ICI crossover: ``ring_1d`` for two ranks,
``ring_bidir`` beyond.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    chunk_schedule,
    dist_launch,
    launch_barrier,
    max_consumer_blocks,
    pair_dims,
    ring_2d_launch,
    ring_launch,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.resilience.sites import MAX_SPANS
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch, group_of

METHODS = ("full_mesh_push", "ring_1d", "ring_bidir")


def _all_gather_xla(x: torch.Tensor, ctx) -> torch.Tensor:
    """Plain version (≙ XLA's all-gather): the ranks' shards concatenated
    in rank order on the host rendezvous."""
    count_call(_all_gather_xla)
    return ctx.all_gather(x, 0)


_all_gather_xla.calls = 0


def get_auto_all_gather_method(chunk_bytes: int, n_pes: int, full_mesh: bool = True) -> str:
    """Topology-based method choice (≙ ``get_auto_all_gather_method``):
    on a full mesh every peer is one store away, so every size pushes
    directly; off one, ``ring_1d`` for two ranks (the bidirectional ring
    has nothing to send left) and ``ring_bidir`` beyond. The JAX package's
    size crossover models the TPU's ICI and does not carry over."""
    del chunk_bytes
    if full_mesh:
        return "full_mesh_push"
    return "ring_1d" if n_pes <= 2 else "ring_bidir"


def all_gather(
    x: torch.Tensor, *, ctx=None, method: str = "auto", chunks_per_shard: int = 1,
    axis=None,
) -> torch.Tensor:
    """Gather the ranks' shards (call inside ``ctx.run``): `x` is this
    rank's ``(m, ...)``; returns ``(world * m, ...)`` with rank i's shard
    at rows ``[i*m, (i+1)*m)``. ``chunks_per_shard > 1`` moves every ring
    step in that many spans, each forwarded as soon as it lands (ring
    methods only; the full-mesh push ignores it, as in the JAX package).
    `axis` (a name or a tuple) gathers over ``ctx``'s group over it; over
    several axes (or a ``ctx`` that spans several) the 2-D hierarchy runs,
    which takes only ``method="auto"``."""
    ctx = group_of(ctx, axis)
    if ctx is not None and len(ctx.axis_names) > 1:
        if method != "auto":
            raise ValueError(
                f"multi-axis all_gather always uses the ring hierarchy; got "
                f"method={method!r} (only 'auto' is valid with >1 axis)"
            )
        axes = ctx.axis_names
        out = all_gather_2d(x, ctx=ctx.group(axes[-2:]))
        for a in reversed(axes[:-2]):
            out = all_gather(out, ctx=ctx.group(a), chunks_per_shard=chunks_per_shard)
        return out
    n = axis_size(ctx)
    if n == 1:
        return x
    orig_shape = x.shape
    if x.ndim == 1:
        x = x.reshape(x.shape[0], 1)
    if method == "auto":
        method = get_auto_all_gather_method(x.numel() * x.element_size(), n, ctx.full_mesh)
    if method not in METHODS:
        raise ValueError(f"unknown all_gather method {method!r}; want one of {METHODS}")
    spans = chunk_schedule(x.shape[0], max(1, int(chunks_per_shard)))
    if len(spans) > MAX_SPANS:
        raise ValueError(f"chunks_per_shard={chunks_per_shard}: the ring allgathers take "
                         f"at most {MAX_SPANS} spans a shard")
    if x.device.type == "cpu":
        out = _all_gather_xla(x, ctx)
    elif method == "full_mesh_push":
        out = _full_mesh_push(x, ctx)
    else:
        out = _RING_WRAPPERS[method, len(spans) > 1](x, ctx, spans)
    if len(orig_shape) == 1:
        out = out.reshape(n * orig_shape[0])
    return out


all_gather.launches = 0


def _full_mesh_push(x: torch.Tensor, ctx) -> torch.Tensor:
    x = x.contiguous()
    n, me = ctx.world, ctx.rank
    shard = x.numel() * x.element_size()
    ws = ctx.symmetric("all_gather.ws", n * shard)
    arrive = symmetric_flags(ctx, "all_gather.arrive")
    data = symmetric_flags(ctx, "all_gather.data")
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    launch = dist_launch(ctx, "all_gather")
    stream = torch.cuda.current_stream()
    launch_barrier(ctx, launch, arrive, stream)
    lib, ws_t, data_t = launch.lib, ws.table[me].data_ptr(), data.table[me].data_ptr()
    rc = lib.tdt_all_gather_push(x.data_ptr(), out.data_ptr(), shard, ws_t, data_t, n, me,
                                 launch.epoch, launch.jitter, stream_ptr(stream))
    _build.check(lib, rc, "all_gather push")
    ctx.rendezvous()  # every rank's push is issued before any collect
    rc = lib.tdt_all_gather_collect(out.data_ptr(), shard, ws_t, data_t, n, me, launch.epoch,
                                    *launch.wait, stream_ptr(stream))
    _build.check(lib, rc, "all_gather collect")
    count_launch(all_gather)
    return out


def _ring_all_gather(x: torch.Tensor, ctx, directions: int, spans) -> torch.Tensor:
    """K19-K22 (``csrc/ring.cu``) in one direction or both: every
    allocation, then the ranks meet, then only the launch, then they meet
    again (no device wait is issued before what it waits for)."""
    x = x.contiguous()
    n, me = ctx.world, ctx.rank
    m = x.shape[0]
    row_bytes = x[0].numel() * x.element_size()
    ws = ctx.symmetric("all_gather_ring.ws", n * m * row_bytes)
    out = torch.empty((n * m, *x.shape[1:]), dtype=x.dtype, device=x.device)
    family = "all_gather_ring_bidir" if directions == 2 else "all_gather_ring_1d"
    ring = ring_launch(ctx, family, spans, directions)
    ctx.rendezvous()
    rc = ring.lib.tdt_ring_all_gather(
        x.data_ptr(), out.data_ptr(), ws.peer_addr(me), ws.peer_addr(ring.right),
        ws.peer_addr(ring.left) if directions == 2 else 0, row_bytes, m, ring.spans,
        ring.n_spans, directions, n, me, *ring.flags, *ring.flags_left, ring.launch.epoch,
        max_consumer_blocks(ctx), ring.launch.jitter, *ring.launch.wait,
        stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(ring.lib, rc, f"all_gather {family}")
    return out


def _all_gather_ring_1d(x, ctx, spans):
    """K19: the one-way ring, one span a shard."""
    out = _ring_all_gather(x, ctx, 1, spans)
    count_launch(_all_gather_ring_1d)
    ctx.rendezvous()  # every rank's kernel is issued before any rank goes on
    return out


def _all_gather_ring_1d_chunked(x, ctx, spans):
    """K20: the one-way ring with a flag per (step, span)."""
    out = _ring_all_gather(x, ctx, 1, spans)
    count_launch(_all_gather_ring_1d_chunked)
    ctx.rendezvous()
    return out


def _all_gather_ring_bidir(x, ctx, spans):
    """K21: both directions, one span a shard."""
    out = _ring_all_gather(x, ctx, 2, spans)
    count_launch(_all_gather_ring_bidir)
    ctx.rendezvous()
    return out


def _all_gather_ring_bidir_chunked(x, ctx, spans):
    """K22: both directions with a flag per (direction, step, span)."""
    out = _ring_all_gather(x, ctx, 2, spans)
    count_launch(_all_gather_ring_bidir_chunked)
    ctx.rendezvous()
    return out


for _fn in (_all_gather_ring_1d, _all_gather_ring_1d_chunked, _all_gather_ring_bidir,
            _all_gather_ring_bidir_chunked):
    _fn.launches = 0
_RING_WRAPPERS = {
    ("ring_1d", False): _all_gather_ring_1d,
    ("ring_1d", True): _all_gather_ring_1d_chunked,
    ("ring_bidir", False): _all_gather_ring_bidir,
    ("ring_bidir", True): _all_gather_ring_bidir_chunked,
}


def all_gather_2d(x: torch.Tensor, *, ctx=None, axes=None) -> torch.Tensor:
    """The hierarchical gather over a pair of axes ``(outer, inner)`` (≙
    ``all_gather_2d``, ``:372``; call inside ``ctx.run``): `ctx` is the pair
    group, or a runtime and ``axes`` the pair. Returns ``(n_o * n_i * m,
    ...)`` with the shard of rank (o, i) at rows ``(o * n_i + i) * m``. On
    the card K36, on the CPU the pair group's host gather."""
    pair = group_of(ctx, axes)
    if pair is None or len(pair.axis_names) != 2:
        raise ValueError("all_gather_2d gathers over a pair of axes (outer, inner)")
    outer, inner = pair.axis_names
    n_o, n_i = pair_dims(pair)
    if n_o == 1:
        return all_gather(x, ctx=pair.group(inner))
    if n_i == 1:
        return all_gather(x, ctx=pair.group(outer))
    orig_shape = x.shape
    if x.ndim == 1:
        x = x.reshape(x.shape[0], 1)
    if x.device.type == "cpu":
        out = _all_gather_xla(x, pair)
    else:
        out = _all_gather_ring_2d(x, pair)
    if len(orig_shape) == 1:
        out = out.reshape(-1)
    return out


def _all_gather_ring_2d(x: torch.Tensor, pair) -> torch.Tensor:
    """K36 (``csrc/ring.cu``): every allocation, then the pair's ranks
    meet, then only the launch, then they meet again."""
    x = x.contiguous()
    n, me = pair.world, pair.rank
    m = x.shape[0]
    row_bytes = x[0].numel() * x.element_size()
    ws = pair.symmetric("all_gather_2d.ws", n * m * row_bytes)
    out = torch.empty((n * m, *x.shape[1:]), dtype=x.dtype, device=x.device)
    ring = ring_2d_launch(pair, "all_gather_2d")
    pair.rendezvous()
    rc = ring.lib.tdt_ring_all_gather_2d(
        x.data_ptr(), out.data_ptr(), ws.peer_addr(me), ws.peer_addr(ring.right),
        ws.peer_addr(ring.down), row_bytes, m, ring.n_o, ring.n_i, me, *ring.flags,
        ring.launch.epoch, max_consumer_blocks(pair), ring.launch.jitter, *ring.launch.wait,
        stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(ring.lib, rc, "all_gather_2d")
    count_launch(_all_gather_ring_2d)
    pair.rendezvous()  # every rank's kernel is issued before any rank goes on
    return out


_all_gather_ring_2d.launches = 0


def all_gather_op(x: torch.Tensor, *, ctx=None, method: str = "auto",
                  chunks_per_shard: int = 1) -> torch.Tensor:
    """Host-level entry (≙ ``all_gather_op``, ``:566``): `x` a global ``[n
    * m, ...]`` tensor whose rows ``[r m, (r+1) m)`` are rank ``r``'s shard
    (moved to its device); every rank gathers the shards with `method` and
    `chunks_per_shard` (K5, or the rings K19-K22), and rank 0's replicated
    result comes back on `x`'s device. At world 1 the identity."""
    n = axis_size(ctx)
    if x.shape[0] % n:
        raise ValueError(f"all_gather_op: {x.shape[0]} rows over {n} ranks")
    if n == 1:
        return x
    m = x.shape[0] // n

    def body():
        r = ctx.rank
        return all_gather(x[r * m:(r + 1) * m].contiguous().to(ctx.rank_device), ctx=ctx,
                          method=method, chunks_per_shard=chunks_per_shard)

    return ctx.run(body)[0].to(x.device)

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
    ring_launch,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.resilience.sites import MAX_SPANS
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch

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
) -> torch.Tensor:
    """Gather the ranks' shards (call inside ``ctx.run``): `x` is this
    rank's ``(m, ...)``; returns ``(world * m, ...)`` with rank i's shard
    at rows ``[i*m, (i+1)*m)``. ``chunks_per_shard > 1`` moves every ring
    step in that many spans, each forwarded as soon as it lands (ring
    methods only; the full-mesh push ignores it, as in the JAX package)."""
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

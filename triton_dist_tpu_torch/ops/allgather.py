"""AllGather (≙ ``triton_dist_tpu/ops/allgather.py``): the full-mesh push
kernel ``_full_mesh_push_kernel`` (``:258``) → K5, its plain version
``_all_gather_xla`` (``:40``), and the method choice
``get_auto_all_gather_method`` (``:53``) re-keyed on the port's topology.

After an entry barrier (K4: every peer has finished reading its
workspace), every rank stores its shard straight into every peer's
symmetric workspace and sets that peer's flag (``csrc/dist.cu`` push, one
block a peer); once all ranks have issued their pushes, each copies the
peers' shards out of its own workspace as their flags rise (collect).
On NVLink — or with every rank on one card — all ranks reach all ranks,
so there is no ring to prefer and no TPU crossover to carry over. The
ring methods are a later slice (ROADMAP B6) and raise.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    dist_launch,
    launch_barrier,
    stream_ptr,
    symmetric_flags,
)
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
    directly; without one a ring would be the way (B6, not ported)."""
    del chunk_bytes, n_pes
    return "full_mesh_push" if full_mesh else "ring_1d"


def all_gather(x: torch.Tensor, *, ctx=None, method: str = "auto") -> torch.Tensor:
    """Gather the ranks' shards (call inside ``ctx.run``): `x` is this
    rank's ``(m, ...)``; returns ``(world * m, ...)`` with rank i's shard
    at rows ``[i*m, (i+1)*m)``."""
    n = axis_size(ctx)
    if n == 1:
        return x
    if method == "auto":
        method = get_auto_all_gather_method(x.numel() * x.element_size(), n, ctx.full_mesh)
    if method not in METHODS:
        raise ValueError(f"unknown all_gather method {method!r}; want one of {METHODS}")
    if method != "full_mesh_push":
        raise NotImplementedError(
            f"all_gather method {method!r}: the ring allgathers are a later "
            f"slice (ROADMAP B6); use 'full_mesh_push'"
        )
    if x.device.type == "cpu":
        return _all_gather_xla(x, ctx)
    return _full_mesh_push(x, ctx)


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
                                 launch.epoch, stream_ptr(stream))
    _build.check(lib, rc, "all_gather push")
    ctx.rendezvous()  # every rank's push is issued before any collect
    rc = lib.tdt_all_gather_collect(out.data_ptr(), shard, ws_t, data_t, n, me, launch.epoch,
                                    *launch.wait, stream_ptr(stream))
    _build.check(lib, rc, "all_gather collect")
    count_launch(all_gather)
    return out

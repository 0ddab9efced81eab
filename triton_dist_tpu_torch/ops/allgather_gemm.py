"""Column-parallel projection ``all_gather(a) @ b`` (≙
``triton_dist_tpu/ops/allgather_gemm.py::ag_gemm``; its fused path
``_ag_gemm_fused`` at ``:341`` launches ``_ag_gemm_kernel`` at ``:69``) →
K6 at world > 1, K1 (``gemm_only``) at world 1.

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

``chunks_per_shard > 1`` (the chunked ring, ``:109``) is a later slice.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    dist_launch,
    gemm_only,
    launch_barrier,
    max_consumer_blocks,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE, _matmul_plain, check_operands
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch


def _ag_gemm_xla(a, b, ctx, gather_output, out_dtype):
    """Plain version (≙ ``_ag_gemm_xla``): gather on the host rendezvous,
    then the plain product."""
    count_call(_ag_gemm_xla)
    ag = ctx.all_gather(a, 0)
    out = _matmul_plain(ag, b, out_dtype)
    return (out, ag) if gather_output else out


_ag_gemm_xla.calls = 0


def ag_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    ctx=None,
    gather_output: bool = False,
    out_dtype: torch.dtype | None = None,
    chunks_per_shard: int = 1,
):
    """a ``[m_loc, K]`` token shard, b ``[K, n_loc]`` column shard →
    ``[world * m_loc, n_loc]`` (plus the gathered ``[world * m_loc, K]`` A
    if `gather_output`). Call inside ``ctx.run``; ``ctx=None`` is world 1,
    where the gather is the identity and this is :func:`gemm_only`."""
    out_dtype = out_dtype or a.dtype
    if chunks_per_shard != 1:
        raise NotImplementedError(
            "ag_gemm chunks_per_shard > 1 (the chunked ring, "
            "allgather_gemm.py:109) is a later slice (ROADMAP B10)"
        )
    if axis_size(ctx) == 1:
        out = gemm_only(a, b, out_dtype=out_dtype)
        return (out, a) if gather_output else out
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ag_gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu":
        return _ag_gemm_xla(a, b, ctx, gather_output, out_dtype)
    return _ag_gemm_fused(a, b, ctx, gather_output, out_dtype)


ag_gemm.launches = 0


def push_shards(ctx, a: torch.Tensor, family: str):
    """The producer side of K6 and K9, on the rank's comm stream: once `a`
    is ready, the family's entry barrier (every rank has finished reading
    its gather workspace from the previous call), one copy-engine put of
    `a` into slot ``me`` of every rank's workspace and a one-warp kernel
    that raises each rank's flag ``me`` to this launch's epoch; then the
    host rendezvous (every rank's producer is issued before any consumer
    waits). Returns ``(launch, this rank's gathered workspace [world *
    rows, K], this rank's flag address)``."""
    n, me = ctx.world, ctx.rank
    shard = a.numel() * a.element_size()
    ws = ctx.symmetric(f"{family}.ws", n * shard)
    arrive = symmetric_flags(ctx, f"{family}.arrive")
    flags = symmetric_flags(ctx, f"{family}.flags")
    launch = dist_launch(ctx, family)
    comp, comm = torch.cuda.current_stream(), ctx.comm_stream
    ready = torch.cuda.Event()
    ready.record(comp)
    comm.wait_event(ready)
    launch_barrier(ctx, launch, arrive, comm)
    dsts = (ctypes.c_longlong * n)(*[ws.peer_addr(p, me * shard) for p in range(n)])
    sigs = (ctypes.c_longlong * n)(*[flags.peer_addr(p, 4 * me) for p in range(n)])
    rc = launch.lib.tdt_put_signal(n, dsts, a.data_ptr(), shard, n, sigs, launch.epoch,
                                   stream_ptr(comm))
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
        launch.epoch, max_consumer_blocks(ctx), *launch.wait,
        stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(launch.lib, rc, "ag_gemm")
    count_launch(ag_gemm)
    if gather_output:
        # the workspace is reused by the next call: hand out a copy, taken
        # after the consumer has seen every shard land
        return out, gathered.clone()
    return out

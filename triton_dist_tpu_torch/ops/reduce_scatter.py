"""K12 · the standalone reduce-scatter (≙
``triton_dist_tpu/ops/reduce_scatter.py::reduce_scatter``, ``:280``; its
``scatter_reduce`` method runs ``_scatter_reduce_kernel`` at ``:227``,
launched at ``:410``), with the method choice
(``get_auto_reduce_scatter_method``, ``:68``) and the plain version
(``_reduce_scatter_xla``, ``:45``).

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

The rings (``:102``, ``:152``) are not ported (ROADMAP B12, rings).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    dist_launch,
    launch_barrier,
    max_consumer_blocks,
    stream_ptr,
    symmetric_flags,
)
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch


def _reduce_scatter_xla(x: torch.Tensor, ctx) -> torch.Tensor:
    """Plain version (≙ ``jax.lax.psum_scatter(x, axis, tiled=True)``):
    this rank's row slice of the ranks' sum, in f32 in rank order, on the
    host rendezvous."""
    count_call(_reduce_scatter_xla)
    return ctx.psum_scatter(x, 0)


_reduce_scatter_xla.calls = 0


def get_auto_reduce_scatter_method(chunk_bytes: int, n_pes: int, full_mesh: bool = True) -> str:
    """Topology-based choice (≙ ``get_auto_reduce_scatter_method``): on a
    full mesh each chunk goes straight to its owner ("scatter_reduce",
    which ``gemm_rs`` calls "scatter"); without one a ring would (not
    ported). No TPU crossover is carried over."""
    del chunk_bytes, n_pes
    return "scatter_reduce" if full_mesh else "ring"


def reduce_scatter(x: torch.Tensor, *, ctx=None, method: str = "auto") -> torch.Tensor:
    """x ``[m_tot, N]``, this rank's full partial array → this rank's
    ``[m_tot / world, N]`` row slice of the sum over ranks (call inside
    ``ctx.run``). ``ctx=None`` is world 1, where it is the identity."""
    n = axis_size(ctx)
    if n == 1:
        return x
    if x.ndim != 2 or x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {tuple(x.shape)} rows must divide over {n} ranks")
    if method == "auto":
        method = get_auto_reduce_scatter_method(
            x.shape[0] // n * x.shape[1] * x.element_size(), n, ctx.full_mesh)
    if method in ("ring", "ring_chunked"):
        raise NotImplementedError(
            f"reduce_scatter method {method!r}: the ring kernels are not ported yet "
            f"(ROADMAP B12, rings); use 'scatter_reduce'")
    if method != "scatter_reduce":
        raise ValueError(f"unknown reduce_scatter method: {method!r}")
    if x.device.type == "cpu":
        return _reduce_scatter_xla(x, ctx)
    return _scatter_reduce(x, ctx)


reduce_scatter.launches = 0


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
        max_consumer_blocks(ctx), *launch.wait, stream_ptr(comp),
    )
    _build.check(launch.lib, rc, "reduce_scatter")
    count_launch(reduce_scatter)
    return out

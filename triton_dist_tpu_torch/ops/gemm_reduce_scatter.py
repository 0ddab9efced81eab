"""Row-parallel projection ``psum_scatter(a @ b)`` (≙
``triton_dist_tpu/ops/gemm_reduce_scatter.py::gemm_rs``; its ``scatter``
method ``_gemm_rs_scatter_kernel`` at ``:99``, dispatched at ``:328``) →
K7 at world > 1, K1 (``gemm_only``) at world 1.

The TPU kernel GEMMs the chunk for peer ``me+d`` (d = 1 .. n-1, own chunk
last) into a two-slot send buffer, pushes it into the peer's landing slot
``d-1``, and fuses the n-way reduction into its own chunk's epilogue. The
port keeps that schedule:

- compute stream: K4 as the entry barrier (every rank's landing slots are
  free: its previous reduce has read them), then for each d the K1 GEMM of
  peer ``me+d``'s row chunk into send slot ``(d-1) % 2``; at d >= 3 the
  stream first waits for the copy that last read that slot (the send-slot
  reuse wait of ``:126-127``, which world 2 never reaches);
- comm stream: each chunk's copy-engine put into the peer's landing slot
  ``d-1`` and a one-warp flag kernel;
- once every rank has issued its puts (a host rendezvous: no device wait
  is issued before what it waits for), compute stream: the consumer
  (``csrc/dist.cu``), a persistent K1-derived kernel that runs its own
  chunk's k loop, waits (bounded) for the n-1 landing flags, and adds the
  landed chunks in its f32 epilogue.

``ring`` and ``ring_chunked`` (``:147``, ``:187``) are a later slice.
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
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE, check_operands, matmul, pointer_array
from triton_dist_tpu_torch.ops.reduce_scatter import get_auto_reduce_scatter_method
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch


def _gemm_rs_xla(a, b, ctx, out_dtype):
    """Plain version (≙ ``_gemm_rs_xla``): each rank's f32 product, summed
    over ranks in f32 on the host rendezvous, this rank's rows cast."""
    count_call(_gemm_rs_xla)
    return ctx.psum_scatter(a.float() @ b.float(), 0).to(out_dtype)


_gemm_rs_xla.calls = 0


def gemm_rs(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    ctx=None,
    method: str = "auto",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """a ``[M, k_loc]``, b ``[k_loc, N]`` → this rank's ``[M / world, N]``
    slice of the reduced product (call inside ``ctx.run``). ``ctx=None``
    is world 1, where the reduce-scatter is the identity and this is
    :func:`gemm_only`."""
    out_dtype = out_dtype or a.dtype
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
    if method in ("ring", "ring_chunked"):
        raise NotImplementedError(
            f"gemm_rs method {method!r}: the fused ring GEMM-RS is a later "
            f"slice (ROADMAP B11); use 'scatter'"
        )
    if method != "scatter":
        raise ValueError(f"unknown gemm_rs method: {method!r} (want scatter|ring)")
    if a.device.type == "cpu":
        return _gemm_rs_xla(a, b, ctx, out_dtype)
    return _gemm_rs_scatter(a, b, ctx, out_dtype)


gemm_rs.launches = 0


def _gemm_rs_scatter(a, b, ctx, out_dtype):
    check_operands(a, b, out_dtype, "gemm_rs")
    n, me = ctx.world, ctx.rank
    m_tot, k_loc = a.shape
    n_dim = b.shape[1]
    m_loc = m_tot // n
    chunk = m_loc * n_dim * torch.empty((), dtype=out_dtype).element_size()
    recv = ctx.symmetric("gemm_rs.recv", (n - 1) * chunk)
    send = ctx.symmetric("gemm_rs.send", 2 * chunk)
    arrive = symmetric_flags(ctx, "gemm_rs.arrive")
    flags = symmetric_flags(ctx, "gemm_rs.flags")
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
    out = torch.empty((m_loc, n_dim), dtype=out_dtype, device=a.device)
    ptrs = pointer_array(landed)
    rc = launch.lib.tdt_gemm_rs_reduce(
        own.data_ptr(), b.data_ptr(), out.data_ptr(), m_loc, n_dim, k_loc,
        DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], n, ptrs, me, flags.peer_addr(me),
        launch.epoch, max_consumer_blocks(ctx), *launch.wait, stream_ptr(comp),
    )
    _build.check(launch.lib, rc, "gemm_rs")
    count_launch(gemm_rs)
    # the next call's GEMMs overwrite the send slots these puts read
    comp.wait_stream(comm)
    return out

"""Shared pieces of the projection ops and the distributed kernels (≙
``triton_dist_tpu/ops/common.py``): the world-1 GEMM (``gemm_only``, whose
Pallas body is ``gemm_add_pipeline`` at ``:468`` launched as
``gemm_only._kernel`` at ``:523``), the launch wrapper every distributed
kernel goes through (≙ ``dist_pallas_call``, ``:72``), and the standalone
device barrier ``barrier_all_op`` (``:913``, kernel ``:918``) → K4.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.gemm import matmul
from triton_dist_tpu_torch.resilience import watchdog
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_WAIT = [_P, _LL, _I, _P]  # diag, timeout ns, family code, stream
DIST_PROTOTYPES = {
    "tdt_barrier_arrive": [_P, _I, _I, _I, _P],
    "tdt_barrier_wait": [_P, _I, _I, _I] + _WAIT,
    "tdt_all_gather_push": [_P, _P, _LL, _P, _P, _I, _I, _I, _P],
    "tdt_all_gather_collect": [_P, _LL, _P, _P, _I, _I, _I] + _WAIT,
    "tdt_put_signal": [_I, ctypes.POINTER(_LL), _P, _LL, _I, ctypes.POINTER(_LL), _I, _P],
    "tdt_ag_gemm_consumer": [_P] * 3 + [_I] * 7 + [_P, _I, _I] + _WAIT,
    "tdt_gemm_rs_reduce": [_P] * 3 + [_I] * 6 + [ctypes.POINTER(_P), _I, _P, _I, _I] + _WAIT,
    "tdt_ag_group_gemm_consumer": [_P] * 4 + [_I] * 9 + [_P, _I, _I] + _WAIT,
    "tdt_moe_combine_push": [_P] * 4 + [_I] * 4 + [_P],
    "tdt_moe_rs_reduce": [_P, _P, _LL, _I, _I, _I, _P, _I, _I] + _WAIT,
    "tdt_sleep": [_LL, _P],
    "tdt_stream_create": [_I, ctypes.POINTER(_P)],
    "tdt_enable_peer_access": [_I, _I],
}


def dist_lib() -> ctypes.CDLL:
    """``csrc/dist.cu``, built at first use."""
    return _build.library("dist", DIST_PROTOTYPES)


def gemm_only(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """The degenerate world-1 path of ``ag_gemm`` and ``gemm_rs``: no
    gather, no reduction, just ``A @ B`` through the K1 kernel."""
    return matmul(a, b, out_dtype=out_dtype)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One rank's side of one launch of a distributed kernel family (≙
    what ``dist_pallas_call`` adds to every kernel): the family's next
    epoch, which the launch's flags carry and its waits wait for, and the
    bounded-wait arguments (the rank's diagnostic buffer, the timeout,
    the family code)."""

    lib: ctypes.CDLL
    rank: int
    world: int
    epoch: int
    wait: tuple  # (diag pointer, timeout ns, family code)


def dist_launch(ctx, family: str) -> Launch:
    """Open one launch of `family` on this rank (inside ``ctx.run``)."""
    r = ctx.rank
    return Launch(
        dist_lib(), r, ctx.world, ctx.next_epoch(family),
        watchdog.wait_args(ctx.diag[r], family),
    )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def max_consumer_blocks(ctx) -> int:
    """The grid cap of a persistent consumer that spins: the ranks sharing
    this card each get floor(SMs / ranks) - 2 one-block-per-SM blocks, so
    every rank's spinning blocks fit on the card at once and two SMs a
    rank stay free for the small spinning kernels (barriers) and the
    peers' producers."""
    dev = ctx.rank_device
    share = sum(1 for d in ctx.devices if d == dev)
    return max(1, _sm_count(dev.index) // share - 2)


def stream_ptr(stream) -> ctypes.c_void_p:
    return ctypes.c_void_p(stream.cuda_stream)


def symmetric_flags(ctx, name: str):
    """An int32[world] flag set of every rank (allocated zeroed once)."""
    return ctx.symmetric(name, 4 * ctx.world)


def launch_barrier(ctx, launch: Launch, flags, stream) -> None:
    """K4 on `stream`: this rank's arrival into every peer's slot of
    `flags` (an int32[world] symmetric set), then — once every rank has
    issued its arrival (the host rendezvous) — a bounded wait for every
    peer's. A device wait is only ever issued after what it waits for (see
    the source note of ``csrc/dist.cu``). Also the entry barrier of the
    fused kernels, with their family's flags and epoch."""
    r, lib, table = launch.rank, launch.lib, flags.table[launch.rank].data_ptr()
    rc = lib.tdt_barrier_arrive(table, launch.world, r, launch.epoch, stream_ptr(stream))
    _build.check(lib, rc, "barrier arrive")
    ctx.rendezvous()
    rc = lib.tdt_barrier_wait(table, launch.world, r, launch.epoch, *launch.wait,
                              stream_ptr(stream))
    _build.check(lib, rc, "barrier wait")
    count_launch(barrier_all_op)


def _barrier_plain(ctx) -> None:
    """Plain version: the ranks meet on the host."""
    count_call(_barrier_plain)
    ctx.rendezvous()


_barrier_plain.calls = 0


def barrier_all_op(ctx=None) -> None:
    """Standalone device barrier over all ranks (≙ ``barrier_all_op``;
    call inside ``ctx.run``). On the card it launches K4 on the rank's
    current stream: the stream goes on only once every rank's stream has
    reached its barrier. On the CPU the ranks meet on the host."""
    if axis_size(ctx) == 1:
        return
    if not ctx.cuda:
        _barrier_plain(ctx)
        return
    launch = dist_launch(ctx, "barrier")
    launch_barrier(ctx, launch, symmetric_flags(ctx, "barrier.arrive"),
                   torch.cuda.current_stream())


barrier_all_op.launches = 0


def sleep_on_stream(ns: int) -> None:
    """Hold the current stream for `ns` nanoseconds of device time (a
    per-rank skew for barrier stress)."""
    lib = dist_lib()
    _build.check(lib, lib.tdt_sleep(int(ns), stream_ptr(torch.cuda.current_stream())), "sleep")


def create_stream(device: torch.device, high_priority: bool):
    """A stream of the rank runtime's own, created on `device` through
    ``cudaStreamCreateWithPriority`` (non-blocking): see
    ``csrc/dist.cu::tdt_stream_create`` for why not PyTorch's pool."""
    lib = dist_lib()
    ptr = ctypes.c_void_p()
    with torch.cuda.device(device):
        _build.check(lib, lib.tdt_stream_create(int(high_priority), ctypes.byref(ptr)),
                     "stream create")
    return torch.cuda.ExternalStream(ptr.value, device=device)

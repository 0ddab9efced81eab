"""Shared pieces of the projection ops and the distributed kernels (≙
``triton_dist_tpu/ops/common.py``): the world-1 GEMM (``gemm_only``, whose
Pallas body is ``gemm_add_pipeline`` at ``:468`` launched as
``gemm_only._kernel`` at ``:523``), the launch wrapper every distributed
kernel goes through (≙ ``dist_pallas_call``, ``:72``), the standalone
device barrier ``barrier_all_op`` (``:913``, kernel ``:918``) → K4, and
what the ring kernels K15–K23 share: the span schedule (``chunk_schedule``,
``:283``), the per-launch flag sets of ``csrc/ring.cu`` in one direction or
both, and the ring's hop-order sum that their plain versions follow; and
the span policies of the chunked MoE overlap kernels K32/K33
(``span_window_schedule`` … ``resolve_spans``, ``:327-465``), the same
spans for the same arguments.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build, config
from triton_dist_tpu_torch.ops.gemm import matmul
from triton_dist_tpu_torch.parallel.topology import torus_factor
from triton_dist_tpu_torch.resilience import watchdog
from triton_dist_tpu_torch.resilience.sites import MAX_SPANS
from triton_dist_tpu_torch.utils import (
    axis_size, count_call, count_launch, pick_block, sm_count,
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_WAIT = [_P, _LL, _I, _P]  # diag, timeout ns, family code, stream
DIST_PROTOTYPES = {
    "tdt_barrier_arrive": [_P, _I, _I, _I, _P],
    "tdt_barrier_wait": [_P, _I, _I, _I] + _WAIT,
    "tdt_all_gather_push": [_P, _P, _LL, _P, _P, _I, _I, _I, _I, _P],
    "tdt_all_gather_collect": [_P, _LL, _P, _P, _I, _I, _I] + _WAIT,
    "tdt_put_signal": [_I, ctypes.POINTER(_LL), _P, _LL, _I, ctypes.POINTER(_LL), _I, _P],
    "tdt_ag_gemm_consumer": [_P] * 3 + [_I] * 7 + [_P, _I, _I, _I] + _WAIT,
    "tdt_gemm_rs_reduce": [_P] * 3 + [_I] * 6 + [ctypes.POINTER(_P), _I, _P, _I, _I, _I]
    + _WAIT,
    "tdt_ag_group_gemm_consumer": [_P] * 6 + [_I] * 8 + [ctypes.POINTER(_I), _I, _I, _I, _P,
                                                         _I, _I] + _WAIT,
    "tdt_moe_combine_push": [_P] * 4 + [_I] * 4 + [_P],
    "tdt_moe_combine_push_chunked": [_P] * 4 + [_I] * 4 + [ctypes.POINTER(_I), _I, _P, _P, _I,
                                                           _P],
    "tdt_moe_rs_reduce_chunked": [_P, _P] + [_I] * 5 + [_P, ctypes.POINTER(_I), _I, _I, _I]
    + _WAIT,
    "tdt_moe_rs_reduce": [_P, _P, _LL, _I, _I, _I, _P, _I, _I] + _WAIT,
    "tdt_scatter_reduce": [_P, _P, _P, _LL, _I, _I, _I, _P, _I, _I, _I] + _WAIT,
    "tdt_sleep": [_LL, _P],
    "tdt_stream_create": [_I, ctypes.POINTER(_P)],
    "tdt_enable_peer_access": [_I, _I],
}


_RING = [_P, _P, _P, _P, _P]  # entry wait, entry signal, flags mine, flags peer, counters
_SPANS = [ctypes.POINTER(_I), _I]
_LAUNCH = [_I, _I, _I]  # epoch, grid cap, jitter
RING_PROTOTYPES = {
    "tdt_ring_ag_gemm": [_P] * 5 + [_I] * 5 + _SPANS + [_I, _I] + _RING + _LAUNCH + _WAIT,
    "tdt_ring_gemm_rs": [_P] * 5 + [_I] * 5 + _SPANS + [_I, _I] + _RING + _LAUNCH + _WAIT,
    "tdt_ring_reduce_scatter": [_P] * 4 + [_I, _LL, _I] + _SPANS + [_I, _I] + _RING
    + _LAUNCH + _WAIT,
    "tdt_ring_all_gather": [_P] * 5 + [_LL, _I] + _SPANS + [_I, _I, _I] + _RING + _RING
    + _LAUNCH + _WAIT,
    "tdt_ring_all_gather_2d": [_P] * 5 + [_LL] + [_I] * 4 + [_P] * 8 + _LAUNCH + _WAIT,
    "tdt_ring_ag_gemm_2d": [_P] * 6 + [_I] * 8 + [_P] * 8 + _LAUNCH + _WAIT,
}


def dist_lib() -> ctypes.CDLL:
    """``csrc/dist.cu``, built at first use."""
    return _build.library("dist", DIST_PROTOTYPES)


def ring_lib() -> ctypes.CDLL:
    """``csrc/ring.cu``, built at first use."""
    return _build.library("ring", RING_PROTOTYPES)


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
    epoch, which the launch's flags carry and its waits wait for, the
    bounded-wait arguments (the rank's diagnostic buffer, the timeout,
    the family code) and the race-shaking delay (``config.debug_comm_delay``
    when the launch opened)."""

    lib: ctypes.CDLL
    rank: int
    world: int
    epoch: int
    wait: tuple  # (diag pointer, timeout ns, family code)
    jitter: int


def dist_launch(ctx, family: str, wait_family: str | None = None) -> Launch:
    """Open one launch of `family` on this rank (inside ``ctx.run``); its
    bounded waits record `wait_family` (default `family`: a chunked launch
    shares its one-span twin's epochs but names its own wait sites)."""
    r = ctx.rank
    return Launch(
        dist_lib(), r, ctx.world, ctx.next_epoch(family),
        watchdog.wait_args(ctx.diag[r], wait_family or family), int(config.debug_comm_delay),
    )


def max_consumer_blocks(ctx) -> int:
    """The grid cap of a persistent consumer that spins: the ranks sharing
    this card each get floor(SMs / ranks) - 2 one-block-per-SM blocks, so
    every rank's spinning blocks fit on the card at once and two SMs a
    rank stay free for the small spinning kernels (barriers) and the
    peers' producers. The ranks counted are every rank of the runtime on
    the card, not only `ctx`'s group: two groups of one 2-D runtime spin
    on the card at once."""
    dev = ctx.rank_device
    share = sum(1 for d in getattr(ctx, "runtime", ctx).devices if d == dev)
    return max(1, sm_count(dev.index) // share - 2)


def stream_ptr(stream) -> ctypes.c_void_p:
    return ctypes.c_void_p(stream.cuda_stream)


def symmetric_flags(ctx, name: str):
    """An int32[world] flag set of every rank (allocated zeroed once). Over
    a group (``ctx.group(axis)``) the set is the group's own."""
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


# ------------------------------------------------------- the ring family ----

def chunk_schedule(rows: int, chunks: int, quantum: int = 1) -> tuple[tuple[int, int], ...]:
    """Static ``(offset, rows)`` spans splitting a shard's `rows` into
    `chunks` contiguous near-equal chunks (≙ ``chunk_schedule``, ``:283``,
    the same spans for the same arguments): every span boundary is a
    multiple of `quantum`, the last span takes the sub-quantum tail, and a
    request for more chunks than quanta clamps."""
    if rows < 1:
        raise ValueError(f"chunk_schedule: rows must be >= 1, got {rows}")
    if chunks < 1:
        raise ValueError(f"chunk_schedule: chunks must be >= 1, got {chunks}")
    quantum = max(1, min(int(quantum), rows))
    units = rows // quantum
    chunks = min(chunks, max(1, units))
    base, extra = divmod(units, chunks)
    spans, off = [], 0
    for j in range(chunks):
        sz = (base + (1 if j < extra else 0)) * quantum
        if j == chunks - 1:
            sz += rows - units * quantum
        spans.append((off, sz))
        off += sz
    return tuple(spans)


def span_window_schedule(rows: int, chunks: int,
                         quantum: int = 1) -> tuple[tuple[int, int], ...]:
    """The ``window`` policy (≙ ``span_window_schedule``, ``:327``):
    contiguous ascending spans whose sizes roughly double, the first as
    small as the quantum allows, so the consumer's first wait covers the
    smallest span; the last span takes the remainder and the sub-quantum
    tail. One chunk (or too few quanta) is :func:`chunk_schedule`."""
    if rows < 1:
        raise ValueError(f"span_window_schedule: rows must be >= 1, got {rows}")
    if chunks < 1:
        raise ValueError(f"span_window_schedule: chunks must be >= 1, got {chunks}")
    quantum = max(1, min(int(quantum), rows))
    units = rows // quantum
    chunks = min(chunks, max(1, units))
    if chunks == 1:
        return chunk_schedule(rows, 1, quantum)
    weights = [1 << j for j in range(chunks)]
    total_w = sum(weights)
    sizes = [max(1, (units * w) // total_w) for w in weights[:-1]]
    head = sum(sizes)
    if head >= units:  # tiny unit budgets: near-equal spans
        return chunk_schedule(rows, chunks, quantum)
    sizes.append(units - head)
    spans, off = [], 0
    for j, sz_units in enumerate(sizes):
        sz = sz_units * quantum
        if j == chunks - 1:
            sz += rows - units * quantum
        spans.append((off, sz))
        off += sz
    return tuple(spans)


def span_interleave_schedule(rows: int, chunks: int,
                             quantum: int = 1) -> tuple[tuple[int, int], ...]:
    """The ``interleave`` policy (≙ ``span_interleave_schedule``, ``:370``):
    :func:`chunk_schedule`'s spans issued alternately from both ends, ``c0,
    c_{k-1}, c1, c_{k-2}, ...``. Valid only where the consumer drains
    chunks by slot index (the MoE combine side)."""
    base = chunk_schedule(rows, chunks, quantum)
    if len(base) <= 2:
        return base
    order, lo, hi = [], 0, len(base) - 1
    while lo <= hi:
        order.append(lo)
        if hi != lo:
            order.append(hi)
        lo, hi = lo + 1, hi - 1
    return tuple(base[i] for i in order)


def span_torus2d_schedule(rows: int, chunks: int, quantum: int = 1,
                          world: int = 1) -> tuple[tuple[int, int], ...]:
    """The ``torus2d`` policy (≙ ``span_torus2d_schedule``, ``:397``):
    ``chunks x inner`` near-equal contiguous spans, ``inner`` the inner
    dimension of the world's most-square factorization
    (:func:`~triton_dist_tpu_torch.parallel.topology.torus_factor`)."""
    _, inner = torus_factor(max(1, int(world)))
    return chunk_schedule(rows, max(1, int(chunks)) * inner, quantum)


# the policies ``GroupGemmConfig.span_policy`` names (≙ ``SPAN_POLICIES``,
# ``:420``): (schedule, needs the world, contiguous and ascending)
SPAN_POLICIES = {
    "contig": (chunk_schedule, False, True),
    "window": (span_window_schedule, False, True),
    "interleave": (span_interleave_schedule, False, False),
    "torus2d": (span_torus2d_schedule, True, True),
}


def validate_span_policy(policy: str, side: str) -> None:
    """Unknown policies, and an order-permuting one on the AG side, raise
    the reference's ``ValueError`` (≙ ``validate_span_policy``, ``:428``).
    The overlap entries call it before anything runs."""
    try:
        _, _, ascending = SPAN_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown span_policy {policy!r}; known: {sorted(SPAN_POLICIES)}"
        ) from None
    if side == "ag" and not ascending:
        raise ValueError(
            f"span_policy {policy!r} emits non-contiguous span order, which "
            f"the AG gather-group schedule cannot consume (its group "
            f"coverage is derived from ascending span offsets); valid "
            f"sides: moe_rs"
        )


def resolve_spans(rows: int, chunks: int, quantum: int, *, policy: str = "contig",
                  world: int = 1, side: str = "moe_rs") -> tuple[tuple[int, int], ...]:
    """The spans of one overlap launch under ``policy`` (≙
    ``resolve_spans``, ``:449``); ``side="ag"`` refuses the
    order-permuting policies. ``"contig"`` is :func:`chunk_schedule`."""
    validate_span_policy(policy, side)
    fn, needs_world, _ = SPAN_POLICIES[policy]
    if needs_world:
        return fn(rows, chunks, quantum, world)
    return fn(rows, chunks, quantum)


def span_array(spans) -> ctypes.Array:
    """A span list as the kernels take it: int32 ``(offset, rows)`` pairs."""
    flat = [v for span in spans for v in span]
    return (ctypes.c_int * len(flat))(*flat)


def check_span_count(spans, what: str) -> None:
    """The chunked kernels keep at most MAX_SPANS flag slots a source."""
    if len(spans) > MAX_SPANS:
        raise ValueError(f"{what}: {len(spans)} spans; the chunked kernels take at most "
                         f"{MAX_SPANS} a slab")


def ring_spans(m_loc: int, chunks_per_shard: int, block_m: int) -> tuple[tuple[int, int], ...]:
    """The spans of one ring hop's `m_loc` rows, quantized as the JAX
    callers quantize them (``ops/allgather_gemm.py:443-451``,
    ``ops/gemm_reduce_scatter.py:431``, ``ops/reduce_scatter.py:381-384``):
    to the row tile a chunk of ``m_loc / chunks`` rows would pick."""
    if block_m < 1:
        raise ValueError(f"block_m={block_m}: the ring kernels need a row tile >= 1 "
                         f"(block_m=0 is the world-1 XLA sentinel)")
    chunks = max(1, int(chunks_per_shard))
    spans = chunk_schedule(
        m_loc, chunks, quantum=pick_block(m_loc, min(block_m, max(1, m_loc // chunks))))
    if len(spans) > MAX_SPANS:
        raise ValueError(f"chunks_per_shard={chunks_per_shard}: the ring kernels take at "
                         f"most {MAX_SPANS} spans a shard")
    return spans


def ring_order_sum(parts, me: int, world: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The ring's reduction of this rank's chunk, in its own hop order:
    rank me+1 starts it (its part rounded to `out_dtype`), then each next
    rank adds its part in f32 and rounds again (≙ ``gemm_add_pipeline``'s
    epilogue at every hop, ``:468``), rank `me` last. ``parts[r]`` is rank
    r's f32 part."""
    acc = parts[(me + 1) % world].to(out_dtype)
    for s in range(1, world):
        acc = (parts[(me + 1 + s) % world].float() + acc.float()).to(out_dtype)
    return acc


@dataclasses.dataclass(frozen=True)
class RingLaunch:
    """One rank's side of one launch of a ring kernel (``csrc/ring.cu``):
    the launch (epoch, bounded-wait arguments, jitter), the pointers of its
    flag sets — this rank's slot of its right neighbour's arrival, its left
    neighbour's slot of its own, its (step, chunk) arrival flags, its right
    neighbour's, its completion counters — and, for a ring in both
    directions, the same five for the left-moving half (this rank's slot
    of its left neighbour's arrival, its right neighbour's slot of its own,
    the left-moving flags: its own, its left neighbour's, its counters; all
    null in one direction), and the spans as a C array."""

    launch: Launch
    lib: ctypes.CDLL
    left: int
    right: int
    flags: tuple
    flags_left: tuple
    spans: ctypes.Array
    n_spans: int


@dataclasses.dataclass(frozen=True)
class Ring2DLaunch:
    """One rank's side of one launch of a 2-D ring kernel (K36, K37) over a
    pair group ``(outer, inner)``: the launch, the grid of the pair, this
    rank's group rank, its right inner neighbour and its outer neighbour
    below (whose workspaces it stores into), and the flag pointers in the
    order the kernels take them: the entry set's peer table on this rank's
    device and this rank's entry set, then the inner and the outer (step,
    chunk) sets (this rank's, the neighbour's it raises, its counters)."""

    launch: Launch
    lib: ctypes.CDLL
    n_o: int
    n_i: int
    me: int
    right: int
    down: int
    flags: tuple


def pair_dims(ctx) -> tuple[int, int]:
    """``(n_o, n_i)`` of a group over two axes (outer, inner)."""
    outer, inner = ctx.axis_names
    return ctx.axis_size(outer), ctx.axis_size(inner)


def ring_2d_launch(ctx, family: str) -> Ring2DLaunch:
    """Open one launch of the 2-D ring kernel `family` over the pair group
    `ctx` (inside ``ctx.run``). Every flag set lives in the group's own
    symmetric memory, so two pair groups of one runtime never share a
    flag or an epoch."""
    n_o, n_i = pair_dims(ctx)
    n, me = ctx.world, ctx.rank
    me_o, me_i = divmod(me, n_i)
    right = me_o * n_i + (me_i + 1) % n_i
    down = ((me_o + 1) % n_o) * n_i + me_i
    entry = symmetric_flags(ctx, f"{family}.entry")
    slots = 4 * n * MAX_SPANS
    sets = [ctx.symmetric(f"{family}.{name}", slots)
            for name in ("inner", "inner_count", "outer", "outer_count")]
    inner, inner_count, outer, outer_count = sets
    return Ring2DLaunch(
        dist_launch(ctx, family), ring_lib(), n_o, n_i, me, right, down,
        (entry.table[me].data_ptr(), entry.peer_addr(me),
         inner.peer_addr(me), inner.peer_addr(right), inner_count.peer_addr(me),
         outer.peer_addr(me), outer.peer_addr(down), outer_count.peer_addr(me)),
    )


def ring_launch(ctx, family: str, spans, directions: int = 1) -> RingLaunch:
    """Open one launch of the ring kernel `family` (inside ``ctx.run``),
    its flags in one direction (right) or both: each direction has a
    (step, span) flag set and counters of its own, since at world 2 the
    left and the right neighbour are the same rank. The sets are
    symmetric and allocated once (fixed sizes), so this allocates nothing
    after the first call."""
    n, me = ctx.world, ctx.rank
    left, right = (me - 1) % n, (me + 1) % n
    entry = symmetric_flags(ctx, f"{family}.entry")
    slots = 4 * (n - 1) * MAX_SPANS
    arrive = ctx.symmetric(f"{family}.flags", slots)
    count = ctx.symmetric(f"{family}.count", slots)
    flags_left = (0,) * 5
    if directions == 2:
        arrive_l = ctx.symmetric(f"{family}.flags_left", slots)
        count_l = ctx.symmetric(f"{family}.count_left", slots)
        flags_left = (entry.peer_addr(me, 4 * left), entry.peer_addr(right, 4 * me),
                      arrive_l.peer_addr(me), arrive_l.peer_addr(left), count_l.peer_addr(me))
    return RingLaunch(
        dist_launch(ctx, family), ring_lib(), left, right,
        (entry.peer_addr(me, 4 * right), entry.peer_addr(left, 4 * me),
         arrive.peer_addr(me), arrive.peer_addr(right), count.peer_addr(me)),
        flags_left, span_array(spans), len(spans),
    )

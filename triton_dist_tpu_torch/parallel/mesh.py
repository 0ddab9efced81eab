"""The rank runtime (≙ ``triton_dist_tpu/parallel/mesh.py``: ``DistContext``
at ``:31``, ``initialize_distributed`` at ``:111``).

The JAX package runs one controller with SPMD bodies under
``jax.shard_map``. The port keeps that shape: one process runs ``world``
ranks, and :meth:`DistContext.run` calls the same body once per rank, each
on its own host thread, with that rank's CUDA stream current (PyTorch's
current stream is per thread). Rank ``r`` lives on device ``r %
device_count``: on one card all ranks share it, on a 4-card node each has
its own, with peer access enabled. NCCL refuses two ranks on one card and
separate processes do not run kernels at once without MPS, so neither is
used.

Each rank has a compute stream and a comm stream (the copy-engine
producers of the fused kernels run on the latter), an int32 diagnostic
buffer for the bounded device waits, and per-family epoch counters that
its kernels signal and wait on.

Host collectives: the XLA collectives of the JAX bodies (``psum``,
``all_gather``, ``psum_scatter`` in ``models/decode.py``, ``all_to_all``
in ``ops/all_to_all.py``) become :meth:`all_gather`, :meth:`psum`,
:meth:`psum_scatter`, :meth:`all_to_all` and :meth:`ppermute`: each rank
publishes its tensor and a CUDA event at a thread rendezvous, waits on its
peers' events on its own stream, and concatenates or sums there, in rank
order, so every rank gets bitwise the same result. They are the twins of
XLA's collectives, not ports of Pallas kernels, and need no NCCL. On the
CPU the same runtime runs the plain versions with plain threads.

The 2-D (or N-D) runtime (≙ ``make_mesh(shape)``, ``:56-73``):
``initialize_distributed(mesh_shape={"dp": 2, "tp": 2})`` lays its ranks
out outer-major, as ``make_mesh`` reshapes the device list, so rank ``r``
sits at ``np.unravel_index(r, sizes)``. ``ctx.axis_size(name)`` and
``ctx.axis_index(name)`` are the mesh's ``axis_size`` and
``jax.lax.axis_index``; ``ctx.group(axis)`` (a name, or a tuple flattened
outer-major in the tuple's order) is the view of this rank's group over
those axes, with the surface every op reads (``world``, ``rank``,
``devices``, ``diag``, ``next_epoch``, ``rendezvous``, the host
collectives, ``symmetric``), so every op that takes ``ctx=`` runs over a
group unchanged. A rank belongs to several groups, and two groups of one
axis set run the same kernel family at once on one card: each group has
its own rendezvous, collective slots, epoch counters and symmetric
buffers, so no wait can pass on another group's signal. One rank that
raises breaks every group's rendezvous, and the runtime then refuses
further runs. ``world=n`` stays the 1-D runtime, whose one axis is
``"tp"``; the runtime is the group over all its axes.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from triton_dist_tpu_torch import config
from triton_dist_tpu_torch.config import resolve_device
from triton_dist_tpu_torch.parallel import topology
from triton_dist_tpu_torch.resilience import records, watchdog

MAX_WORLD = 8  # csrc/dist.cu MAX_WORLD, csrc/gemm_core.cuh MAX_ADDS + 1
# the interpreter's thread switch interval while ranks run (the default is
# 5 ms, which a rendezvous would otherwise pay on every wake-up)
SWITCH_INTERVAL_S = 5e-5


def _ordered_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The f32 sum of `parts` in rank order, accumulated in place into one
    f32 buffer: the same bits as summing f32 copies, without a copy of each
    part (a replicated embedding's gradient is 2 GB in f32)."""
    acc = parts[0].to(torch.float32, copy=True)
    for t in parts[1:]:
        acc.add_(t)
    return acc


class _Collectives:
    """The host collectives over a set of ranks (the runtime, or a group of
    it): each rank publishes its tensor at the set's rendezvous
    (:meth:`_exchange`), waits on its peers' events on its own stream and
    combines in rank order, so every rank gets bitwise the same result."""

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `x`, concatenated along `dim` in rank order (≙
        ``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``)."""
        if self.world == 1:
            return x
        return torch.cat(self._exchange(x.contiguous()), dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks in rank order, in f32, cast back (≙
        ``jax.lax.psum``)."""
        if self.world == 1:
            return x
        return _ordered_sum(self._exchange(x)).to(x.dtype)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Slab ``p`` of every rank's ``x [world, ...]`` to rank ``p``,
        stacked in source-rank order (≙ ``jax.lax.all_to_all(x, axis, 0,
        0, tiled=True)``)."""
        if self.world == 1:
            return x
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} must be the world "
                             f"{self.world}")
        return torch.stack([t[self.rank] for t in self._exchange(x.contiguous())])

    def psum_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's `dim` slice of the sum over ranks (≙
        ``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``)."""
        if self.world == 1:
            return x
        if x.shape[dim] % self.world:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} over {self.world}")
        m = x.shape[dim] // self.world
        parts = [t.narrow(dim, self.rank * m, m) for t in self._exchange(x)]
        return _ordered_sum(parts).to(x.dtype)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """The tensor of the rank that `perm` (``(source, destination)``
        pairs, each rank at most once on either side) sends here, zeros
        where none does (≙ ``jax.lax.ppermute(x, axis, perm)``)."""
        perm = [(int(s), int(d)) for s, d in perm]
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
                not 0 <= r < self.world for r in srcs + dsts):
            raise ValueError(f"ppermute: {perm} is not a permutation of {self.world} ranks")
        parts = [x] if self.world == 1 else self._exchange(x.contiguous())
        src = next((s for s, d in perm if d == self.rank), None)
        return torch.zeros_like(x) if src is None else parts[src].clone()

    def _exchange_in(self, state, x: torch.Tensor) -> list[torch.Tensor]:
        """Publish `x` in `state`'s slots, meet at its rendezvous, and
        return every rank's tensor (on this rank's stream)."""
        r = self.rank
        slot = state.slots[state.seq[r] % 2]
        state.seq[r] += 1
        event = None
        if x.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream())
        slot[r] = (x, event)
        # a slot is reused two collectives later, when every rank has passed
        # the next rendezvous and so has read this one
        self.rendezvous()
        parts = list(slot)
        if x.is_cuda:
            cur = torch.cuda.current_stream()
            for p, (t, e) in enumerate(parts):
                if p != r:
                    cur.wait_event(e)
                    t.record_stream(cur)
        return [t.to(x.device) for t, _ in parts]

    def _symmetric_in(self, state, devices, name: str, nbytes: int):
        from triton_dist_tpu_torch.shmem.host import SymmetricTensor

        buf = state.symm.get(name)
        if buf is not None and buf.nbytes >= nbytes:
            return buf
        self.rendezvous()
        if self.rank == 0:
            if self.cuda:
                for d in set(devices):
                    torch.cuda.synchronize(d)
            old = state.symm.get(name)
            size = max(nbytes, 0 if old is None else old.nbytes)
            state.symm[name] = SymmetricTensor(devices, size)
        self.rendezvous()
        return state.symm[name]


class _GroupState:
    """What one group of ranks shares: its host rendezvous, the two slots
    of its host collectives, each rank's collective count, and its
    symmetric buffers."""

    def __init__(self, world: int, broken: bool):
        self.barrier = threading.Barrier(world)
        if broken:
            self.barrier.abort()
        self.slots: tuple[list, list] = ([None] * world, [None] * world)
        self.seq = [0] * world
        self.symm: dict[str, object] = {}


def _bounded_wait(barrier: threading.Barrier, rank: int) -> None:
    limit = 4 * config.wait_timeout_s + 60
    t0 = time.monotonic()
    try:
        barrier.wait(timeout=limit)
    except threading.BrokenBarrierError:
        if time.monotonic() - t0 >= limit:
            raise TimeoutError(
                f"rank {rank} waited {limit:.0f} s at the host rendezvous: "
                f"a peer never reached it"
            ) from None
        raise


class DistContext(_Collectives):
    """World handle: the ranks of this process on a mesh of named axes,
    their devices, streams, diagnostic buffers, epochs and symmetric
    buffers.

        ctx = initialize_distributed(4)            # on the card, axis "tp"
        outs = ctx.run(lambda: ctx.rank * 2)       # [0, 2, 4, 6]
        ctx = initialize_distributed(mesh_shape={"dp": 2, "tp": 2})
        ctx.run(lambda: (ctx.axis_index("dp"), ctx.group("tp").rank))
    """

    def __init__(self, world: int | None = None, device=None, *, mesh_shape=None):
        if mesh_shape is None:
            mesh_shape = {"tp": 1 if world is None else int(world)}
        mesh_shape = {str(k): int(v) for k, v in dict(mesh_shape).items()}
        total = math.prod(mesh_shape.values())
        if world is not None and int(world) != total:
            raise ValueError(f"world={world} does not match mesh_shape {mesh_shape} "
                             f"({total} ranks)")
        if not mesh_shape or min(mesh_shape.values()) < 1 or total > MAX_WORLD:
            raise ValueError(f"world must be 1..{MAX_WORLD} ranks, axes of size >= 1; got "
                             f"{mesh_shape}")
        self.world = world = total
        self.axis_names = tuple(mesh_shape)
        self.mesh_shape = dict(mesh_shape)
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            from triton_dist_tpu_torch.ops.common import create_stream

            n_dev = topology.device_count()
            self.devices = [torch.device("cuda", r % n_dev) for r in range(world)]
            _check_connections(sum(1 for d in self.devices if d == self.devices[0]))
            # created one after the other: distinct hardware queues
            pairs = [(create_stream(d, False), create_stream(d, True)) for d in self.devices]
            self.streams = [comp for comp, _ in pairs]
            self.comm_streams = [comm for _, comm in pairs]
            self.diag = [
                torch.zeros(records.DIAG_LEN, dtype=torch.int32, device=d)
                for d in self.devices
            ]
            topology.enable_peer_access(self.devices)
        else:
            self.devices = [torch.device("cpu")] * world
            self.streams = self.comm_streams = [None] * world
            self.diag = None
        self.full_mesh = topology.is_full_mesh(self.devices)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._broken = False
        self._state = _GroupState(world, False)
        self._epochs = [collections.Counter() for _ in range(world)]
        # per rank: the group (label, world) of each kernel family's last
        # launch, which names a timeout record's group
        self._launch_groups = [{} for _ in range(world)]
        # a group's membership tables by axes (plain data: a Group refers
        # to the runtime, and the runtime holds no Group, so no reference
        # cycle keeps a dropped runtime's buffers alive until a collection)
        self._tables: dict[tuple, tuple] = {}
        self._group_states: dict[tuple, _GroupState] = {}
        self._pool: ThreadPoolExecutor | None = None
        self._failed: str | None = None

    # -- where am I -------------------------------------------------------

    @property
    def rank(self) -> int:
        """This thread's rank; only inside :meth:`run`."""
        r = getattr(self._local, "rank", None)
        if r is None:
            raise RuntimeError("DistContext.rank is defined only inside ctx.run(...)")
        return r

    @property
    def rank_device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def comm_stream(self):
        return self.comm_streams[self.rank]

    @property
    def runtime(self) -> "DistContext":
        """The runtime a group belongs to: itself."""
        return self

    @property
    def label(self) -> str:
        """The group's name in timeout records: its axes."""
        return ",".join(self.axis_names)

    def next_epoch(self, family: str) -> int:
        """This rank's next launch number of a kernel family: its flags
        carry it, and its waits wait for flag >= it."""
        return self._next_epoch(self.rank, family, self)

    def _next_epoch(self, rank: int, family: str, group) -> int:
        """Rank `rank`'s next epoch of `family` over `group` (a group's
        counters are keyed by its axes too), noting the group for the
        timeout records."""
        key = family if group is self else f"{group.label}:{family}"
        counter = self._epochs[rank]
        counter[key] += 1
        self._launch_groups[rank][family] = (group.label, group.world)
        return counter[key]

    # -- axes and groups ----------------------------------------------------

    def coords(self, rank: int) -> tuple[int, ...]:
        """Rank `rank`'s index on each axis (outer-major layout)."""
        out = []
        for size in reversed(self.mesh_shape.values()):
            rank, i = divmod(rank, size)
            out.append(i)
        return tuple(reversed(out))

    def index_of(self, rank: int, axis) -> int:
        """Rank `rank`'s index on `axis` (a name, or a tuple flattened
        outer-major in its order)."""
        c = dict(zip(self.axis_names, self.coords(rank)))
        j = 0
        for a in self._check_axes(axis):
            j = j * self.mesh_shape[a] + c[a]
        return j

    def _check_axes(self, axis) -> tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if not axes or len(set(axes)) != len(axes):
            raise ValueError(f"axis {axis!r}: want a name or a tuple of distinct names")
        for a in axes:
            if a not in self.mesh_shape:
                raise ValueError(
                    f"axis {a!r} is not an axis of this runtime {self.axis_names} "
                    f"(initialize_distributed(mesh_shape={{..., {a!r}: n}}) makes one)")
        return axes

    def axis_size(self, axis) -> int:
        """The size of axis `axis` (a name, or the product over a tuple; ≙
        the mesh's ``axis_size``)."""
        return math.prod(self.mesh_shape[a] for a in self._check_axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's index on `axis` inside :meth:`run` (≙
        ``jax.lax.axis_index``; a tuple flattens outer-major)."""
        return self.group(axis).rank

    def group(self, axis):
        """The view of this rank's group over `axis` (a name, or a tuple
        flattened outer-major in its order): the ranks that share this
        rank's index on every other axis. The runtime over all its axes in
        their order is itself."""
        axes = self._check_axes(axis)
        if axes == self.axis_names:
            return self
        with self._lock:
            tables = self._tables.get(axes)
            if tables is None:
                tables = self._tables[axes] = self._group_tables(axes)
        return Group(self, axes, tables)

    def _group_tables(self, axes) -> tuple:
        """For every global rank its group rank over `axes` and its group's
        key (its indices on the other axes), and each group's members in
        group-rank order."""
        rank_of, key_of, members = [], [], {}
        size = math.prod(self.mesh_shape[a] for a in axes)
        for g in range(self.world):
            c = dict(zip(self.axis_names, self.coords(g)))
            j = 0
            for a in axes:
                j = j * self.mesh_shape[a] + c[a]
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            rank_of.append(j)
            key_of.append(key)
            members.setdefault(key, [None] * size)[j] = g
        return rank_of, key_of, members

    def _group_state(self, key: tuple, world: int) -> _GroupState:
        with self._lock:
            st = self._group_states.get(key)
            if st is None:
                st = self._group_states[key] = _GroupState(world, self._broken)
        return st

    def _break(self) -> None:
        """A rank failed: break every rendezvous, the runtime's and each
        group's (and any group's made later), so no peer waits on it."""
        with self._lock:
            self._broken = True
            states = [self._state, *self._group_states.values()]
        for st in states:
            st.barrier.abort()

    # -- the SPMD runner ----------------------------------------------------

    def run(self, fn, *args, grad: bool = False, check: bool = True) -> list:
        """Call ``fn(*args)`` once per rank, each on its own thread with
        ``ctx.rank`` set, the rank's device and compute stream current and
        inference mode on. Returns the ranks' results in rank order.

        ``grad=True`` runs a body that takes gradients (``train_step``):
        no inference mode, grad mode on, and the autograd engine's
        multithreading off, so each rank's backward runs on the rank's own
        thread. With it on, PyTorch runs every CUDA backward node on one
        worker thread per device, shared by the ranks: a node that meets
        its peers at a host collective would block the others' nodes
        behind it, and ``ctx.rank`` (thread-local) would not be set there.
        Tensors made in a ``grad=False`` run are inference tensors and
        cannot be saved for a backward: make parameters outside such runs.

        The ranks' streams first wait for the caller's current stream, and
        the caller's stream waits for theirs at the end. With ``check`` each
        rank then syncs its streams and reads its diagnostic buffer: a
        device wait that timed out raises
        :class:`~triton_dist_tpu_torch.resilience.records.DistTimeoutError`
        with its record. An exception on one rank breaks the host
        rendezvous for the others; the first such exception is raised, and
        the runtime refuses further runs (its ranks no longer agree on
        epochs)."""
        if getattr(self._local, "rank", None) is not None:
            raise RuntimeError("ctx.run(...) does not nest")
        if self._failed is not None:
            raise RuntimeError(
                f"this DistContext failed earlier ({self._failed}); its ranks "
                f"no longer agree on epochs — build a new one"
            )
        starts = {}
        if self.cuda:
            for d in set(self.devices):
                starts[d] = torch.cuda.Event()
                starts[d].record(torch.cuda.current_stream(d))
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.world, thread_name_prefix="tdt-rank")
        # a rank woken at a rendezvous waits for the interpreter lock while
        # its peers run Python: hand the lock over sooner during the run
        switch = sys.getswitchinterval()
        sys.setswitchinterval(min(switch, SWITCH_INTERVAL_S))
        try:
            futures = [
                self._pool.submit(self._body, r, fn, args, starts, grad, check)
                for r in range(self.world)
            ]
            results, diag_rows, errors = [], [], []
            for f in futures:
                try:
                    out, diag = f.result()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errors.append(e)
                    out = diag = None
                results.append(out)
                if diag is not None:
                    diag_rows.append(diag)
        finally:
            sys.setswitchinterval(switch)
        if self.cuda:
            for r, d in enumerate(self.devices):
                torch.cuda.current_stream(d).wait_stream(self.streams[r])
        if errors:
            first = next(
                (e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                errors[0],
            )
            self._failed = type(first).__name__
            raise first
        try:
            watchdog.check(diag_rows, self.world, groups=self._launch_groups)
        except records.DistTimeoutError:
            self._failed = "DistTimeoutError"
            raise
        return results

    def _body(self, r, fn, args, starts, grad, check):
        self._local.rank = r
        try:
            if not self.cuda:
                with _grad_mode(grad):
                    return fn(*args), None
            dev, s, comm = self.devices[r], self.streams[r], self.comm_streams[r]
            torch.cuda.set_device(dev)
            s.wait_event(starts[dev])
            comm.wait_event(starts[dev])
            with torch.cuda.stream(s), _grad_mode(grad):
                out = fn(*args)
                s.wait_stream(comm)
                if check:
                    # every rank has issued its work before any rank blocks
                    # on its diagnostic read: that blocking device-to-host
                    # copy can hold the other ranks' CUDA calls (a launch,
                    # an event record) until the card drains, so a late
                    # peer would decide when they issue their waits
                    self.rendezvous()
                diag = self.diag[r].cpu().tolist() if check else None
            return out, diag
        except BaseException:
            self._break()
            raise
        finally:
            self._local.rank = None

    def rendezvous(self) -> None:
        """All ranks meet on the host (the plain version of a barrier, the
        publish point of the host collectives, and the point between a
        signal's issue and its wait's). Bounded too: a rank that never
        comes breaks it for all."""
        _bounded_wait(self._state.barrier, self.rank)

    def _exchange(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self._exchange_in(self._state, x)

    # -- symmetric memory -------------------------------------------------

    def symmetric(self, name: str, nbytes: int):
        """The symmetric buffer `name` of at least `nbytes` bytes a rank
        (≙ ``shmem.host.create_symmetric_tensor``), grown collectively: every
        rank calls this at the same point of its body. A buffer never
        shrinks; a grow waits for every rank's issued work first, so no
        kernel still reads the buffer it replaces. Flags are buffers of a
        fixed size, so they are allocated once and never replaced."""
        return self._symmetric_in(self._state, self.devices, name, nbytes)

    def close(self) -> None:
        """Release the symmetric buffers and the rank threads. The streams
        stay: PyTorch's caching allocator keeps blocks and events tied to
        them for as long as the process runs."""
        if self.cuda:
            for d in set(self.devices):
                torch.cuda.synchronize(d)
        for st in [self._state, *self._group_states.values()]:
            st.symm.clear()
            st.slots = ([None] * len(st.seq), [None] * len(st.seq))
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class Group(_Collectives):
    """This rank's group over some axes of a runtime (``ctx.group(axis)``):
    the same surface as the runtime for the ops (``world``, ``rank``,
    ``devices``, ``rank_device``, ``cuda``, ``full_mesh``, ``diag``,
    ``comm_stream``, ``next_epoch``, ``rendezvous``, the host collectives
    and ``symmetric``), resolved for the calling rank inside ``ctx.run``.
    Group rank ``j`` is the rank whose indices on the group's axes flatten
    to ``j`` outer-major in the group's axis order; the other axes' indices
    are the calling rank's. Its rendezvous, collective slots, epochs and
    symmetric buffers are its own (keyed by its axes and members)."""

    def __init__(self, runtime: DistContext, axes: tuple[str, ...], tables: tuple):
        self.runtime = runtime
        self.axis_names = axes
        self.mesh_shape = {a: runtime.mesh_shape[a] for a in axes}
        self.world = math.prod(self.mesh_shape.values())
        self.device, self.cuda = runtime.device, runtime.cuda
        self.full_mesh = runtime.full_mesh
        self._rank_of, self._key_of, self._members = tables

    @property
    def label(self) -> str:
        return ",".join(self.axis_names)

    @property
    def members(self) -> list[int]:
        """The calling rank's group, as global ranks in group-rank order."""
        return self._members[self._key_of[self.runtime.rank]]

    @property
    def global_rank(self) -> int:
        return self.runtime.rank

    @property
    def rank(self) -> int:
        return self._rank_of[self.runtime.rank]

    @property
    def devices(self) -> list:
        return [self.runtime.devices[g] for g in self.members]

    @property
    def rank_device(self) -> torch.device:
        return self.runtime.rank_device

    @property
    def comm_stream(self):
        return self.runtime.comm_stream

    @property
    def diag(self):
        if self.runtime.diag is None:
            return None
        return [self.runtime.diag[g] for g in self.members]

    def _state(self) -> _GroupState:
        key = self._key_of[self.runtime.rank]
        return self.runtime._group_state((self.axis_names, key), self.world)

    def next_epoch(self, family: str) -> int:
        return self.runtime._next_epoch(self.runtime.rank, family, self)

    def rendezvous(self) -> None:
        _bounded_wait(self._state().barrier, self.rank)

    def _exchange(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self._exchange_in(self._state(), x)

    def symmetric(self, name: str, nbytes: int):
        """The group's symmetric buffer `name` (see
        :meth:`DistContext.symmetric`), one allocation per member."""
        return self._symmetric_in(self._state(), self.devices, name, nbytes)

    def group(self, axis):
        return self.runtime.group(axis)

    def axis_size(self, axis) -> int:
        return self.runtime.axis_size(axis)

    def axis_index(self, axis) -> int:
        return self.runtime.axis_index(axis)


@contextlib.contextmanager
def _grad_mode(grad: bool):
    """A rank body's autograd state: inference mode for serving; for
    training grad mode on and the backward on the calling thread (both
    thread-local)."""
    if not grad:
        with torch.inference_mode():
            yield
        return
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        yield


def _check_connections(ranks_per_device: int) -> None:
    """Each rank's two streams need hardware queues of their own: with
    fewer (CUDA_DEVICE_MAX_CONNECTIONS, 8 unless set before the process
    first touched the card), one rank's spinning kernel can sit in front of
    a peer's producer in a shared queue and hold it until the wait times
    out."""
    have = int(os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS", "8"))
    if 2 * ranks_per_device > have:
        raise RuntimeError(
            f"{ranks_per_device} ranks on one card need {2 * ranks_per_device} "
            f"hardware queues; set CUDA_DEVICE_MAX_CONNECTIONS={2 * ranks_per_device} "
            f"(or 32) in the environment before the process first uses the card"
        )


def initialize_distributed(world: int | None = None, device=None, *,
                           mesh_shape=None) -> DistContext:
    """Bootstrap (≙ ``initialize_distributed``, ``:111``): a runtime of
    `world` ranks on one axis ``"tp"``, or of the ranks of `mesh_shape`
    (axis name -> size, outer-major, e.g. ``{"dp": 2, "tp": 2}``), on the
    card (or the CPU, when asked for). No environment, no process group:
    every rank is a thread of this process."""
    return DistContext(world, device, mesh_shape=mesh_shape)

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
``all_gather``, ``psum_scatter`` in ``models/decode.py``) become
:meth:`all_gather`, :meth:`psum` and :meth:`psum_scatter`: each rank
publishes its tensor and a CUDA event at a thread rendezvous, waits on its
peers' events on its own stream, and concatenates or sums there, in rank
order, so every rank gets bitwise the same result. They are the twins of
XLA's collectives, not ports of Pallas kernels, and need no NCCL. On the
CPU the same runtime runs the plain versions with plain threads.
"""

from __future__ import annotations

import collections
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


class DistContext:
    """World handle: ``world`` ranks of this process, their devices,
    streams, diagnostic buffers, epochs and symmetric buffers.

        ctx = initialize_distributed(4)            # on the card
        outs = ctx.run(lambda: ctx.rank * 2)       # [0, 2, 4, 6]
    """

    def __init__(self, world: int, device=None):
        if not 1 <= world <= MAX_WORLD:
            raise ValueError(f"world must be 1..{MAX_WORLD}, got {world}")
        self.world = int(world)
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
        self._rendezvous = threading.Barrier(world)
        self._slots: tuple[list, list] = ([None] * world, [None] * world)
        self._seq = [0] * world
        self._epochs = [collections.Counter() for _ in range(world)]
        self._symm: dict[str, object] = {}
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

    def next_epoch(self, family: str) -> int:
        """This rank's next launch number of a kernel family: its flags
        carry it, and its waits wait for flag >= it."""
        counter = self._epochs[self.rank]
        counter[family] += 1
        return counter[family]

    # -- the SPMD runner ----------------------------------------------------

    def run(self, fn, *args, check: bool = True) -> list:
        """Call ``fn(*args)`` once per rank, each on its own thread with
        ``ctx.rank`` set, the rank's device and compute stream current and
        inference mode on. Returns the ranks' results in rank order.

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
                self._pool.submit(self._body, r, fn, args, starts, check)
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
            self._rendezvous.reset()
            first = next(
                (e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                errors[0],
            )
            self._failed = type(first).__name__
            raise first
        try:
            watchdog.check(diag_rows, self.world)
        except records.DistTimeoutError:
            self._failed = "DistTimeoutError"
            raise
        return results

    def _body(self, r, fn, args, starts, check):
        self._local.rank = r
        try:
            if not self.cuda:
                with torch.inference_mode():
                    return fn(*args), None
            dev, s, comm = self.devices[r], self.streams[r], self.comm_streams[r]
            torch.cuda.set_device(dev)
            s.wait_event(starts[dev])
            comm.wait_event(starts[dev])
            with torch.cuda.stream(s), torch.inference_mode():
                out = fn(*args)
                s.wait_stream(comm)
                diag = self.diag[r].cpu().tolist() if check else None
            return out, diag
        except BaseException:
            self._rendezvous.abort()
            raise
        finally:
            self._local.rank = None

    def rendezvous(self) -> None:
        """All ranks meet on the host (the plain version of a barrier, the
        publish point of the host collectives, and the point between a
        signal's issue and its wait's). Bounded too: a rank that never
        comes breaks it for all."""
        limit = 4 * config.wait_timeout_s + 60
        t0 = time.monotonic()
        try:
            self._rendezvous.wait(timeout=limit)
        except threading.BrokenBarrierError:
            if time.monotonic() - t0 >= limit:
                raise TimeoutError(
                    f"rank {self.rank} waited {limit:.0f} s at the host rendezvous: "
                    f"a peer never reached it"
                ) from None
            raise

    # -- host collectives (the twins of XLA's) -------------------------------

    def _exchange(self, x: torch.Tensor) -> list[torch.Tensor]:
        r = self.rank
        slot = self._slots[self._seq[r] % 2]
        self._seq[r] += 1
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
        parts = self._exchange(x)
        acc = parts[0].float()
        for t in parts[1:]:
            acc = acc + t.float()
        return acc.to(x.dtype)

    def psum_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's `dim` slice of the sum over ranks (≙
        ``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``)."""
        if self.world == 1:
            return x
        if x.shape[dim] % self.world:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} over {self.world}")
        m = x.shape[dim] // self.world
        parts = [t.narrow(dim, self.rank * m, m) for t in self._exchange(x)]
        acc = parts[0].float()
        for t in parts[1:]:
            acc = acc + t.float()
        return acc.to(x.dtype)

    # -- symmetric memory -------------------------------------------------

    def symmetric(self, name: str, nbytes: int):
        """The symmetric buffer `name` of at least `nbytes` bytes a rank
        (≙ ``shmem.host.create_symmetric_tensor``), grown collectively: every
        rank calls this at the same point of its body. A buffer never
        shrinks; a grow waits for every rank's issued work first, so no
        kernel still reads the buffer it replaces. Flags are buffers of a
        fixed size, so they are allocated once and never replaced."""
        from triton_dist_tpu_torch.shmem.host import SymmetricTensor

        buf = self._symm.get(name)
        if buf is not None and buf.nbytes >= nbytes:
            return buf
        self.rendezvous()
        if self.rank == 0:
            if self.cuda:
                for d in set(self.devices):
                    torch.cuda.synchronize(d)
            old = self._symm.get(name)
            size = max(nbytes, 0 if old is None else old.nbytes)
            self._symm[name] = SymmetricTensor(self.devices, size)
        self.rendezvous()
        return self._symm[name]

    def close(self) -> None:
        """Release the symmetric buffers and the rank threads. The streams
        stay: PyTorch's caching allocator keeps blocks and events tied to
        them for as long as the process runs."""
        if self.cuda:
            for d in set(self.devices):
                torch.cuda.synchronize(d)
        self._symm.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


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


def initialize_distributed(world: int = 1, device=None) -> DistContext:
    """Bootstrap (≙ ``initialize_distributed``): a runtime of `world` ranks
    on the card (or the CPU, when asked for). No environment, no process
    group: every rank is a thread of this process."""
    return DistContext(world, device)

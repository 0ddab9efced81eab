"""Bounded waits: the host half (≙ ``triton_dist_tpu/resilience/
watchdog.py``: ``kernel_scope`` at ``:95``, ``bounded_wait`` at ``:122``).

The wait itself is device code (``csrc/shmem.cuh::wait_until_ge``): it
spins on ``%globaltimer`` up to the timeout of :mod:`config` and, on
expiry, writes a record into the rank's diagnostic buffer and returns, so
the kernel still issues its later signals and no peer is stalled by it.
This module is what every launch wrapper passes to that code
(:func:`wait_args`) and what the runtime does with the buffer once the
rank's streams have synced (:func:`check`): decode it and raise. A lost
peer is an error with a record naming the rank and the wait site, never a
hang.
"""

from __future__ import annotations

from triton_dist_tpu_torch import config
from triton_dist_tpu_torch.resilience import records as R
from triton_dist_tpu_torch.resilience import sites


def wait_args(diag, family: str) -> tuple[int, int, int]:
    """``(diag pointer, timeout ns, family code)``: the bounded-wait
    arguments of one launch (≙ entering ``kernel_scope``)."""
    return diag.data_ptr(), config.wait_timeout_ns(), sites.FAMILIES[family]


def records(diag_rows, world: int, groups=None) -> list[dict]:
    """The timeout records among the ranks' host copies of their buffers.
    ``groups[r]`` (optional) maps each kernel family rank ``r`` launched to
    the ``(label, world)`` of the group it launched over: a record then
    decodes its sites in that group's world and names the global rank and
    the group."""
    out = []
    for r, row in enumerate(diag_rows):
        if int(row[R.F_STATUS]) == R.STATUS_OK:
            continue
        label, w = None, world
        if groups is not None:
            family = sites.family_name(int(row[R.F_FAMILY]))
            launched = groups[r]
            hit = launched.get(family) or next(
                (v for k, v in launched.items() if family.startswith(k)), None)
            if hit is not None:
                label, w = hit
        rec = R.decode_record(row, w)
        if label is not None:
            rec["rank"], rec["group"] = r, label
        out.append(rec)
    return out


def check(diag_rows, world: int, groups=None) -> None:
    """Raise :class:`~records.DistTimeoutError` if any rank recorded a
    timeout (``groups`` as in :func:`records`)."""
    recs = records(diag_rows, world, groups)
    if recs:
        raise R.DistTimeoutError(recs, world)

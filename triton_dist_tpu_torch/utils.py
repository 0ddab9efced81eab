"""Host-side helpers (own copies of ``triton_dist_tpu.utils``), the world
queries the ops share, and the launch counter every kernel wrapper bumps."""

from __future__ import annotations

import threading

_count_lock = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_block(dim: int, block: int) -> int:
    """Largest divisor of `dim` that is <= `block` and power-of-2-shrinkable
    from it."""
    block = min(block, dim)
    while dim % block != 0:
        block //= 2
    return max(block, 1)


def axis_size(ctx) -> int:
    """The world of a rank runtime (≙ ``utils.axis_size`` of a mesh axis);
    ``None`` is world 1."""
    return 1 if ctx is None else ctx.world


def axis_index(ctx) -> int:
    """This rank inside ``ctx.run`` (≙ ``jax.lax.axis_index``); 0 at world
    1."""
    return 0 if ctx is None else ctx.rank


def count_launch(fn, key: str = "launches", by: int = 1) -> None:
    """``fn.launches += by`` (or the counter `key`, e.g. a wrapper's
    ``scaled_launches`` of its int8/fp8 kernel) under a lock: the ranks'
    threads launch concurrently, and the read-modify-write would lose
    counts."""
    with _count_lock:
        setattr(fn, key, getattr(fn, key) + by)


def count_rows(fn, key: str, rank: int, value) -> None:
    """``fn.<key>[rank] += value``: a per-rank tally (a dict) whose value
    may be a device scalar, added on the rank's own stream, so counting
    adds no host sync; read it once the work is done (:func:`tally`)."""
    tallies = getattr(fn, key)
    tallies[rank] = tallies.get(rank, 0) + value


def tally(tallies: dict) -> int:
    """A per-rank tally of :func:`count_rows`, summed on the host (a sync
    where the values lie on the card)."""
    return int(sum(int(v) for v in tallies.values()))


def count_call(fn) -> None:
    """``fn.calls += 1`` for a plain version, under the same lock."""
    with _count_lock:
        fn.calls += 1

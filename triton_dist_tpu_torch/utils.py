"""Host-side helpers (own copies of ``triton_dist_tpu.utils``), the world
queries the ops share, and the launch counter every kernel wrapper bumps."""

from __future__ import annotations

import functools
import threading

_count_lock = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (the persistent
    grids' and the split plans' width)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def pick_block(dim: int, block: int) -> int:
    """Largest divisor of `dim` that is <= `block` and power-of-2-shrinkable
    from it."""
    block = min(block, dim)
    while dim % block != 0:
        block //= 2
    return max(block, 1)


def axis_size(ctx, axis=None) -> int:
    """The size of `axis` (a name, or the product over a tuple) of a rank
    runtime or group (≙ ``utils.axis_size``); ``axis=None`` is the
    runtime's or group's whole world, and ``ctx=None`` is world 1."""
    if ctx is None:
        return 1
    return ctx.world if axis is None else ctx.axis_size(axis)


def axis_index(ctx, axis=None) -> int:
    """This rank's index on `axis` inside ``ctx.run`` (≙
    ``jax.lax.axis_index``; a tuple flattens outer-major); ``axis=None``
    is its rank in the runtime or group, and 0 at world 1."""
    if ctx is None:
        return 0
    return ctx.rank if axis is None else ctx.axis_index(axis)


def group_of(ctx, axis=None):
    """The ranks an op runs over: `ctx` itself when `axis` is None, else
    its group over `axis` (``ctx.group``); ``None`` stays world 1."""
    if ctx is None or axis is None:
        return ctx
    return ctx.group(axis)


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

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


def count_launch(fn) -> None:
    """``fn.launches += 1`` under a lock: the ranks' threads launch
    concurrently, and the read-modify-write would lose counts."""
    with _count_lock:
        fn.launches += 1


def count_call(fn) -> None:
    """``fn.calls += 1`` for a plain version, under the same lock."""
    with _count_lock:
        fn.calls += 1

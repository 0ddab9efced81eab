"""Host-side integer helpers (own copies of ``triton_dist_tpu.utils``)."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_block(dim: int, block: int) -> int:
    """Largest divisor of `dim` that is <= `block` and power-of-2-shrinkable
    from it."""
    block = min(block, dim)
    while dim % block != 0:
        block //= 2
    return max(block, 1)

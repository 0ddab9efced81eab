"""Which ranks reach which (≙ ``triton_dist_tpu/parallel/topology.py``),
re-keyed for NVLink: the TPU question "does this axis wrap around into a
ring" (``has_wraparound``, ``:85``) becomes "can every rank store into
every other rank's memory" — a full mesh. Ranks that share one card
always can; ranks on different cards can when each pair has peer access
(NVLink or PCIe P2P). The CPU runtime is a full mesh by construction.
:func:`torus_factor` is the JAX package's own (``:258``): the ``torus2d``
span policy sizes its chunk count by it, so the port's spans equal the
reference's on any card.
"""

from __future__ import annotations

import itertools

import torch


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def peer_access(a: torch.device, b: torch.device) -> bool:
    """Whether device `a` can address device `b`'s memory."""
    if a == b:
        return True
    return bool(torch.cuda.can_device_access_peer(a.index, b.index))


def is_full_mesh(devices) -> bool:
    """Every rank can store into every other rank's buffers (≙
    ``has_wraparound``, the question that steers method choice)."""
    devs = sorted({d for d in devices}, key=str)
    if all(d.type == "cpu" for d in devs):
        return True
    return all(peer_access(a, b) for a, b in itertools.permutations(devs, 2))


def torus_factor(n: int) -> tuple[int, int]:
    """Most-square 2-D torus factorization ``(outer, inner)`` of an axis of
    `n` ranks (≙ ``torus_factor``, ``:258``): ``inner`` is the largest
    divisor of `n` at most its square root (``inner <= outer``, ``outer *
    inner == n``); primes and n <= 2 give ``(n, 1)``, a line."""
    n = int(n)
    if n < 1:
        raise ValueError(f"torus_factor: world must be >= 1, got {n}")
    inner = 1
    d = 2
    while d * d <= n:
        if n % d == 0:
            inner = d
        d += 1
    return n // inner, inner


def enable_peer_access(devices) -> None:
    """Enable peer access between every pair of the ranks' distinct cards
    (nothing to do when they share one)."""
    devs = sorted({d.index for d in devices})
    if len(devs) < 2:
        return
    from triton_dist_tpu_torch import _build
    from triton_dist_tpu_torch.ops.common import dist_lib

    lib = dist_lib()
    for a, b in itertools.permutations(devs, 2):
        _build.check(lib, lib.tdt_enable_peer_access(a, b), f"peer access {a} -> {b}")

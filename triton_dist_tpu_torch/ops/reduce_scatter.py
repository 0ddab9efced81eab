"""Reduce-scatter method choice and its plain version (≙
``triton_dist_tpu/ops/reduce_scatter.py``: ``get_auto_reduce_scatter_method``
at ``:68``, ``_reduce_scatter_xla`` at ``:45``).

The standalone reduce-scatter kernels (``_scatter_reduce_kernel`` and the
rings, ROADMAP B12) are a later slice; the fused GEMM-RS
(``gemm_reduce_scatter.py``) is what the served path runs.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.utils import count_call


def _reduce_scatter_xla(x: torch.Tensor, ctx) -> torch.Tensor:
    """Plain version (≙ ``jax.lax.psum_scatter(x, axis, tiled=True)``):
    this rank's row slice of the ranks' sum, in f32, on the host
    rendezvous."""
    count_call(_reduce_scatter_xla)
    return ctx.psum_scatter(x, 0)


_reduce_scatter_xla.calls = 0


def get_auto_reduce_scatter_method(chunk_bytes: int, n_pes: int, full_mesh: bool = True) -> str:
    """Topology-based choice (≙ ``get_auto_reduce_scatter_method``): on a
    full mesh each chunk goes straight to its owner ("scatter_reduce",
    which ``gemm_rs`` calls "scatter"); without one a ring would (not
    ported). No TPU crossover is carried over."""
    del chunk_bytes, n_pes
    return "scatter_reduce" if full_mesh else "ring"

"""Row-parallel projection ``psum_scatter(a @ b)`` (≙
``triton_dist_tpu/ops/gemm_reduce_scatter.py::gemm_rs``), world-1 path
only."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.common import gemm_only


def gemm_rs(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    world: int = 1,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """a ``[M, k_loc]``, b ``[k_loc, N]`` → this rank's ``[M / world, N]``
    slice of the reduced product. At world 1 the reduce-scatter is the
    identity and this is :func:`gemm_only`."""
    if world != 1:
        raise NotImplementedError(
            "gemm_rs at world > 1 needs the fused GEMM reduce-scatter "
            "(ROADMAP A4); this port runs world 1 only"
        )
    return gemm_only(a, b, out_dtype=out_dtype)

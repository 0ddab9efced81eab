"""Column-parallel projection ``all_gather(a) @ b`` (≙
``triton_dist_tpu/ops/allgather_gemm.py::ag_gemm``), world-1 path only."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.common import gemm_only


def ag_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    world: int = 1,
    gather_output: bool = False,
    out_dtype: torch.dtype | None = None,
):
    """a ``[m_loc, K]`` token shard, b ``[K, n_loc]`` column shard →
    ``[world * m_loc, n_loc]`` (plus the gathered A if `gather_output`). At
    world 1 the gather is the identity and this is :func:`gemm_only`."""
    if world != 1:
        raise NotImplementedError(
            "ag_gemm at world > 1 needs the fused all-gather GEMM "
            "(ROADMAP A4); this port runs world 1 only"
        )
    out = gemm_only(a, b, out_dtype=out_dtype)
    return (out, a) if gather_output else out

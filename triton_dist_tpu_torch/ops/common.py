"""The world-1 GEMM shared by the projection ops (≙
``triton_dist_tpu/ops/common.py::gemm_only``, whose Pallas body is
``gemm_add_pipeline`` at ``:468`` launched as ``gemm_only._kernel`` at
``:523``)."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.gemm import matmul


def gemm_only(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """The degenerate world-1 path of ``ag_gemm`` and ``gemm_rs``: no
    gather, no reduction, just ``A @ B`` through the K1 kernel (the JAX
    body's fused epilogue adds are unused on this path, ``n_adds = 0``)."""
    return matmul(a, b, out_dtype=out_dtype)

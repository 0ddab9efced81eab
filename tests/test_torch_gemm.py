"""The PyTorch port's GEMM core (``triton_dist_tpu_torch/ops/gemm.py``,
``common.gemm_only``, world-1 ``ag_gemm``/``gemm_rs``) against the JAX
package's ``matmul``, ``ag_gemm_op`` and ``gemm_rs_op`` on a 1-device mesh,
same numpy inputs. On the CPU the port runs its plain version; the CUDA
kernel itself is held against that plain version in
``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig, ag_gemm_op
from triton_dist_tpu.ops.gemm import matmul as jax_matmul
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig, gemm_rs_op
from triton_dist_tpu_torch.ops import gemm as tgemm
from triton_dist_tpu_torch.ops.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.ops.common import gemm_only
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import gemm_rs

# f32 products and f32 sums on both sides over K <= 128 terms of O(1/sqrt(K))
# size; only the summation order differs, a few f32 ulps of O(1) outputs
TOL = 1e-5


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("m,k,n", [(16, 128, 128), (24, 40, 48)])
def test_matmul_matches_jax(m, k, n):
    a, b = _operands(0, m, k, n)
    want = jax_matmul(jnp.asarray(a), jnp.asarray(b), block_m=8, block_n=16, block_k=8)
    got = tgemm.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        gemm_only(torch.from_numpy(a), torch.from_numpy(b)).numpy(), got.numpy()
    )


def test_world1_ag_gemm_and_gemm_rs_match_jax():
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("tp",))
    a, b = _operands(1, 16, 32, 48)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want_ag = ag_gemm_op(jnp.asarray(a), jnp.asarray(b), mesh1, config=AGGemmConfig(8, 16, 16))
    out, gathered = ag_gemm(ta, tb, gather_output=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_ag), rtol=TOL, atol=TOL)
    assert gathered is ta  # world 1: the gather is the identity
    want_rs = gemm_rs_op(jnp.asarray(a), jnp.asarray(b), mesh1, config=GemmRSConfig(8, 16, 16))
    np.testing.assert_allclose(gemm_rs(ta, tb).numpy(), np.asarray(want_rs), rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError, match="A4"):
        ag_gemm(ta, tb, world=2)
    with pytest.raises(NotImplementedError, match="A4"):
        gemm_rs(ta, tb, world=2)


def test_matmul_bf16_out_and_shape_check():
    """bf16 in, f32 accumulation, one rounding to the output dtype."""
    a, b = _operands(2, 8, 64, 16)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = tgemm.matmul(ta, tb)
    assert got.dtype == torch.bfloat16
    want = (ta.double() @ tb.double()).to(torch.bfloat16)
    # f32 vs f64 sums of 64 bf16 products: at most one bf16 rounding apart
    np.testing.assert_allclose(
        got.float().numpy(), want.float().numpy(), rtol=2**-8, atol=2**-8
    )
    with pytest.raises(ValueError, match="shapes"):
        tgemm.matmul(ta, tb.T)

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
from triton_dist_tpu_torch.ops.allgather_gemm import ag_gemm, ag_gemm_plan
from triton_dist_tpu_torch.ops.common import gemm_only
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import gemm_rs
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

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
    # world 2 (no longer refused): the gathered product and the reduced
    # one are the world-1 products, split over the two CPU ranks
    ctx = initialize_distributed(2, device="cpu")
    ag_outs = ctx.run(lambda: ag_gemm(ta[8 * ctx.rank:8 * ctx.rank + 8], tb, ctx=ctx))
    for got in ag_outs:
        np.testing.assert_allclose(got.numpy(), out.numpy(), rtol=TOL, atol=TOL)
    rs_outs = ctx.run(lambda: gemm_rs(ta[:, 16 * ctx.rank:16 * ctx.rank + 16].contiguous(),
                                      tb[16 * ctx.rank:16 * ctx.rank + 16], ctx=ctx))
    np.testing.assert_allclose(torch.cat(rs_outs).numpy(), np.asarray(want_rs),
                               rtol=TOL, atol=TOL)
    # the epilogue adds of gemm_add_pipeline: O = A @ B + sum(adds)
    adds = [torch.ones(16, 48), torch.full((16, 48), 2.0)]
    np.testing.assert_allclose(tgemm.matmul(ta, tb, adds=adds).numpy(), out.numpy() + 3.0,
                               rtol=TOL, atol=TOL)


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


# ------------------------------------------- K1's engine choice (pure) ----

@pytest.mark.parametrize("m,n,k,dtype,aligned,engine,config", [
    (2048, 6144, 4096, torch.bfloat16, True, "wgmma", 0),     # prefill wqkv: 384 tiles
    (2048, 128256, 4096, torch.bfloat16, True, "wgmma", 0),   # prefill LM head
    (256, 4096, 4096, torch.bfloat16, True, "wgmma", 1),      # one wave either way
    (1024, 6144, 4096, torch.bfloat16, True, "wgmma", 1),     # 2 wide waves against 3 narrow
    (1024, 4096, 4096, torch.bfloat16, True, "wgmma", 0),     # 1 wide wave against 2 narrow
    (512, 28672, 4096, torch.bfloat16, True, "wgmma", 0),     # 4 wide waves against 7 narrow
    (8, 6144, 4096, torch.bfloat16, True, "wgmma", 2),        # M = batch x a short bucket
    (64, 136, 72, torch.bfloat16, True, "wgmma", 2),
    (65, 136, 72, torch.bfloat16, True, "wgmma", 1),
    (100, 136, 41, torch.bfloat16, True, "mma_sync", -1),     # K % 8: TMA cannot stride
    (100, 130, 40, torch.bfloat16, True, "mma_sync", -1),     # N % 8
    (100, 136, 40, torch.bfloat16, False, "mma_sync", -1),    # a misaligned base
    (300, 500, 700, torch.float32, True, "f32", -1),
])
def test_gemm_plan_engine_choice(m, n, k, dtype, aligned, engine, config):
    """The engine and tile K1 runs on the card, by dtype, shape and
    alignment only (csrc/gemm.cu's three engines)."""
    p = tgemm.plan(m, n, k, dtype, aligned=aligned, sms=132)
    assert (p.engine, p.config) == (engine, config)
    assert tgemm.tma_ok(n, k, aligned) == (engine == "wgmma") or dtype == torch.float32


@pytest.mark.parametrize("m_loc,n,k,world,dtype,aligned,engine,config", [
    # a 4-way Llama-3.1-70B prefill, 512 rows a rank, on 31 blocks a rank:
    (512, 2560, 8192, 4, torch.bfloat16, True, "wgmma", 0),   # 6 wide waves against 11
    (512, 14336, 8192, 4, torch.bfloat16, True, "wgmma", 0),  # 29 against 58
    (512, 32064, 8192, 4, torch.bfloat16, True, "wgmma", 0),  # 66 against 131
    (2, 2560, 8192, 4, torch.bfloat16, True, "wgmma", 1),     # decode: 2 wide waves against 3
    (2, 32064, 8192, 4, torch.bfloat16, True, "wgmma", 0),
    (100, 296, 512, 2, torch.bfloat16, True, "wgmma", 1),     # one wave either way
    (100, 300, 512, 2, torch.bfloat16, True, "mma_sync", -1),  # N % 8: TMA cannot stride
    (100, 296, 500, 2, torch.bfloat16, True, "mma_sync", -1),  # K % 8
    (100, 296, 512, 2, torch.bfloat16, False, "mma_sync", -1),  # a misaligned operand
    (100, 300, 512, 2, torch.float32, True, "f32", -1),
])
def test_ag_gemm_plan_engine_choice(m_loc, n, k, world, dtype, aligned, engine, config):
    """K6's engine and tile on the card, by dtype, shape and alignment:
    K1's wave rule counted over the consumer's grid (31 blocks a rank at
    world 4 on one H100) and each shard's rows rounded to whole tiles; a
    forced engine is taken where it can run and refused where not."""
    p = ag_gemm_plan(m_loc, n, k, world, dtype, aligned=aligned, blocks=31)
    assert (p.engine, p.config) == (engine, config)
    if engine == "wgmma":
        bm, bn = tgemm.SM90_TILES[config]
        assert p.tiles == world * -(-m_loc // bm) * -(-n // bn)
        assert p.grid == min(p.tiles, 31)
    if dtype == torch.bfloat16:
        assert ag_gemm_plan(m_loc, n, k, world, dtype, aligned=aligned,
                            engine="mma_sync").engine == "mma_sync"
    if engine != "wgmma":
        with pytest.raises(ValueError, match="no wgmma engine"):
            ag_gemm_plan(m_loc, n, k, world, dtype, aligned=aligned, engine="wgmma")


@pytest.mark.parametrize("m,n,k,sms", [(2048, 4096, 14336, 132), (8, 128256, 4096, 132),
                                       (129, 136, 200, 4), (1, 8, 8, 132)])
def test_gemm_plan_tma_arguments(m, n, k, sms):
    """The tensor maps of the wgmma engine: A [M, K] as {K, M} with a 2K-byte
    row stride and a [BM rows][64 k] box, B [K, N] as {N, K} with a 2N-byte
    stride and [64 k][64 n] boxes, both 16-byte strides; the persistent
    grid covers min(tiles, SMs) and the boxes tile the product."""
    p = tgemm.plan(m, n, k, torch.bfloat16, sms=sms)
    bm, bn = tgemm.SM90_TILES[p.config]
    assert p.map_a == (k, m, 2 * k, 64, bm)
    assert p.map_b == (n, k, 2 * n, 64, 64)
    assert p.map_a[2] % 16 == 0 and p.map_b[2] % 16 == 0
    assert bn % p.map_b[3] == 0 and p.map_a[3] == p.map_b[4] == tgemm.SM90_BK
    assert p.tiles == -(-m // bm) * -(-n // bn) and p.grid == min(p.tiles, sms)
    # a forced engine: the mma.sync one always, wgmma only where TMA can load
    assert tgemm.plan(m, n, k, torch.bfloat16, engine="mma_sync").engine == "mma_sync"
    with pytest.raises(ValueError, match="wgmma"):
        tgemm.plan(m, n, k + 1, torch.bfloat16, engine="wgmma")

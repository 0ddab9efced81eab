"""The engine routes of the grouped GEMM (K8/K24/K29), the full-mesh
GEMM-RS (K7) and the ring GEMMs (K15, K16/K17) on the card, decided on the
host by ``group_gemm_plan``, ``gemm_rs_plan`` and ``ring_gemm_plan``: bf16
that TMA can load goes to K1's ``wgmma`` + TMA mainloop, f32, one-byte
banks and operands TMA cannot load to the earlier engines; and the CPU paths of ``group_gemm`` and ``gemm_rs`` (the plain
twins every engine is held to) against the JAX package's XLA goldens
(``_group_gemm_xla``, ``_gemm_rs_xla``), with no interpreted kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.ops.gemm_reduce_scatter import _gemm_rs_xla
from triton_dist_tpu.ops.group_gemm import _group_gemm_xla
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as tgrs
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.ops import moe_utils as tmu
from triton_dist_tpu_torch.ops.common import ring_gemm_plan, ring_spans
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

BF16, F32 = torch.bfloat16, torch.float32

# (t_pad, n, k, dtype, scaled, aligned) -> the routed engine
GROUP_ROUTES = {
    "mixtral_up": ((5120, 14336, 4096, BF16, False, True), "wgmma"),
    "mixtral_down": ((5120, 4096, 14336, BF16, False, True), "wgmma"),
    "n_off_rule": ((512, 300, 256, BF16, False, True), "mma_sync"),
    "k_off_rule": ((512, 304, 100, BF16, False, True), "mma_sync"),
    "unaligned": ((512, 304, 256, BF16, False, False), "mma_sync"),
    "one_byte_bank": ((5120, 14336, 4096, BF16, True, True), "mma_sync"),
    "too_many_row_tiles": ((128 * (tgg.MAX_ROW_TILES + 1), 304, 256, BF16, False, True),
                           "mma_sync"),
    "f32": ((512, 304, 256, F32, False, True), "f32"),
}


@pytest.mark.parametrize("name", sorted(GROUP_ROUTES))
def test_group_gemm_plan_routes(name):
    (t_pad, n, k, dtype, scaled, aligned), engine = GROUP_ROUTES[name]
    p = tgg.group_gemm_plan(t_pad, n, k, dtype, scaled=scaled, aligned=aligned)
    assert p.engine == engine
    if engine == "wgmma":
        # K1's tiles, every row tile of the layout counted, one block an SM at most
        bm, bn = tgg.SM90_TILES[p.config]
        assert bm == tgg.TILE_M and p.tiles == (t_pad // bm) * -(-n // bn)
        assert p.grid == min(p.tiles, 132)
    else:
        with pytest.raises(ValueError):
            tgg.group_gemm_plan(t_pad, n, k, dtype, scaled=scaled, aligned=aligned,
                                engine="wgmma")


def test_group_gemm_plan_weighs_waves():
    """The tile rule weighs waves over the layout's row tiles: 128x256 at
    the Mixtral prefill's up-projection, and 128x128 where it finishes in
    fewer weighted waves (at 132 SMs: 44 x 2 = 88 wide tiles, one wave
    weighing 1.6 narrow ones, against 44 x 3 = 132 narrow tiles, one
    wave)."""
    assert tgg.group_gemm_plan(5120, 14336, 4096, BF16).config == 0
    assert tgg.group_gemm_plan(128 * 44, 384, 4096, BF16).config == 1
    # a forced engine: the earlier one always takes bf16
    assert tgg.group_gemm_plan(5120, 14336, 4096, BF16, engine="mma_sync").engine == "mma_sync"


# (m_loc, n, k, world, dtype, aligned) -> the routed engine
RS_ROUTES = {
    "llama70b_wo": ((512, 8192, 2048, 4, BF16, True), "wgmma"),
    "llama70b_down_world2": ((1024, 8192, 14336, 2, BF16, True), "wgmma"),
    "n_off_rule": ((64, 300, 256, 2, BF16, True), "mma_sync"),
    "unaligned": ((64, 296, 256, 4, BF16, False), "mma_sync"),
    "f32": ((64, 296, 256, 4, F32, True), "f32"),
}


@pytest.mark.parametrize("name", sorted(RS_ROUTES))
def test_gemm_rs_plan_routes(name):
    (m_loc, n, k, world, dtype, aligned), engine = RS_ROUTES[name]
    p = tgrs.gemm_rs_plan(m_loc, n, k, world, dtype, aligned=aligned, blocks=31)
    assert p.engine == engine
    if engine == "wgmma":
        # the consumer's grid under the spinning cap, the producer's two more
        # blocks (floor(SMs / ranks)) over the n-1 peer chunks' tiles
        assert p.grid == min(p.tiles, 31)
        assert p.producer_grid == min((world - 1) * p.tiles, 33)
    else:
        with pytest.raises(ValueError):
            tgrs.gemm_rs_plan(m_loc, n, k, world, dtype, aligned=aligned, engine="wgmma")


# (spans, n, k, world, dtype, aligned) -> (the routed engine, the wgmma tile
# config): the 70B prefill's shards at two spans and one, a product of one
# row tile a step where the 128x128 tile finishes in fewer weighted waves
RING_ROUTES = {
    "llama70b_wqkv_two_spans": ((ring_spans(512, 2, 512), 2560, 8192, 4, BF16, True),
                                ("wgmma", 0)),
    "llama70b_wo_one_span": ((((0, 512),), 8192, 2048, 4, BF16, True), ("wgmma", 0)),
    "one_row_tile": ((((0, 40), (40, 24)), 384, 256, 2, BF16, True), ("wgmma", 1)),
    "n_off_rule": ((((0, 64),), 300, 256, 2, BF16, True), ("mma_sync", -1)),
    "k_off_rule": ((((0, 64),), 304, 100, 2, BF16, True), ("mma_sync", -1)),
    "unaligned": ((((0, 64),), 304, 256, 4, BF16, False), ("mma_sync", -1)),
    "f32": ((((0, 64),), 304, 256, 4, F32, True), ("f32", -1)),
}


@pytest.mark.parametrize("name", sorted(RING_ROUTES))
def test_ring_gemm_plan_routes(name):
    """K15 and K16/K17 route as K6 and K7 do; the wgmma tile weighs waves of
    the ring's tiles (world steps, each span's rows in whole 128-row tiles)
    over the capped grid; a forced engine that cannot take the operands
    raises."""
    (spans, n, k, world, dtype, aligned), (engine, config) = RING_ROUTES[name]
    p = ring_gemm_plan(spans, n, k, world, dtype, aligned=aligned, blocks=31)
    assert (p.engine, p.config) == (engine, config)
    if engine == "wgmma":
        bn = tgrs.SM90_TILES[config][1]
        assert p.tiles == world * sum(-(-rows // 128) for _, rows in spans) * -(-n // bn)
        assert p.grid == min(p.tiles, 31)
        assert ring_gemm_plan(spans, n, k, world, dtype, engine="mma_sync").engine == "mma_sync"
    else:
        with pytest.raises(ValueError):
            ring_gemm_plan(spans, n, k, world, dtype, aligned=aligned, engine="wgmma")
    if dtype == F32:
        with pytest.raises(ValueError):
            ring_gemm_plan(spans, n, k, world, dtype, engine="mma_sync")


def _routing(rng, tokens, n_exp, topk):
    ids = np.argsort(rng.random((tokens, n_exp)), axis=1)[:, :topk].astype(np.int32)
    return torch.from_numpy(ids.reshape(-1).copy())


@pytest.mark.parametrize("ragged", [False, True], ids=["padded", "ragged"])
def test_group_gemm_cpu_matches_xla(ragged):
    """The CPU path (K8/K29's plain twin) with the GELU fused, bf16 rows
    over a bf16 bank, against ``_group_gemm_xla`` on the same inputs: both
    round an f32 sum to bf16 once, so at most one ulp apart; the ragged map's
    dead rows exact zeros."""
    n_exp, bm, hid, ffn = 4, 8, 32, 48
    rng = np.random.default_rng(19)
    al = tmu.moe_align_block_size(_routing(rng, 20, n_exp, 2), n_exp, bm, ragged=ragged)
    t_pad = al.sorted_token_ids.shape[0]
    a = torch.from_numpy(rng.standard_normal((t_pad, hid)).astype(np.float32)).bfloat16()
    b = torch.from_numpy((rng.standard_normal((n_exp, hid, ffn)) / np.sqrt(hid))
                         .astype(np.float32)).bfloat16()
    valid = al.valid_rows if ragged else None
    got = tgg.group_gemm(a, b, al.expert_ids, valid_rows=valid,
                         config=tgg.GroupGemmConfig(bm, ragged=ragged), act_fn=tgg.gelu)
    want = _group_gemm_xla(
        jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(b.float().numpy(), jnp.bfloat16),
        jnp.asarray(al.expert_ids.numpy()),
        valid_rows=None if valid is None else jnp.asarray(valid.numpy()), scale=None,
        ragged=ragged, bm=bm, out_dtype=jnp.bfloat16, act_fn=jax.nn.gelu)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-6)
    if ragged:
        dead = (np.arange(t_pad) % bm) >= np.repeat(valid.numpy(), bm)
        assert dead.any() and not got.float().numpy()[dead].any()


@pytest.mark.parametrize("world", [2, 4])
def test_gemm_rs_cpu_matches_xla(world):
    """The CPU path (K7's plain twin) against ``_gemm_rs_xla`` under
    ``shard_map`` on the virtual CPU devices, f32 (1e-4)."""
    m_loc, k_loc, n = 8, 16, 24
    rng = np.random.default_rng(20 + world)
    a = rng.standard_normal((world * m_loc, world * k_loc)).astype(np.float32)
    b = rng.standard_normal((world * k_loc, n)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    want = jax.jit(jax.shard_map(lambda x, y: _gemm_rs_xla(x, y, axis="tp"), mesh=mesh,
                                 in_specs=(P(None, "tp"), P("tp", None)),
                                 out_specs=P("tp", None), check_vma=False))(
        jnp.asarray(a), jnp.asarray(b))
    ctx = initialize_distributed(world, device="cpu")
    got = torch.cat(ctx.run(lambda: tgrs.gemm_rs(
        torch.from_numpy(a[:, ctx.rank * k_loc:(ctx.rank + 1) * k_loc].copy()),
        torch.from_numpy(b[ctx.rank * k_loc:(ctx.rank + 1) * k_loc]), ctx=ctx,
        method="scatter"))).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)

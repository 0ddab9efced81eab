"""The PyTorch port's tensor-parallel model against the JAX package on the
CPU: ``shard_params`` against the JAX package's per-device shards at world
2 and 4, and at world 2 the per-rank ``TPTransformer`` forward, a bulk
``prefill_cache`` and one ragged ``decode_step`` over the sequence-sharded
cache. The port's two ranks are threads of one CPU
``DistContext`` running the plain versions; the JAX side runs under
``shard_map`` on two virtual CPU devices with its Pallas kernels
interpreted. One decoder block, hidden 32, whole-operand tiles, so the
interpreter stays fast.

Tolerance 1e-4: f32 throughout on both sides, the packages differ only in
summation order. Shards are copies and must be exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import init_params as jax_init_params
from triton_dist_tpu.models.tp_transformer import (
    TPTransformer as JaxTPTransformer,
    TransformerConfig as JaxConfig,
    param_specs,
)
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

TOL = 1e-4
WORLD = 2
DIMS = dict(vocab=64, hidden=32, ffn=64, n_layers=1, n_q_heads=8, n_kv_heads=4,
            head_dim=8, batch=2, seq=16)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


@pytest.fixture(scope="module")
def models():
    # whole-operand tiles: the fewest interpreted grid steps
    jcfg = JaxConfig(**DIMS, ag_config=AGGemmConfig(16, 128, 128),
                     rs_config=GemmRSConfig(16, 128, 128))
    # the JAX init's tree and shapes, filled from numpy (no jax.random
    # program to compile): unit-scale rows over sqrt(fan-in), norms at one
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jax_init_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) / np.sqrt(x.shape[0]), x.dtype),
        shapes)
    tcfg = ttm.TransformerConfig(**DIMS)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                    torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("world", [2, 4])
def test_shard_params_matches_jax_shards(models, world):
    jcfg, jparams, _, tparams = models
    mesh = _mesh(world)
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                          jparams, param_specs(jcfg))
    shards = ttm.shard_params(tparams, world)

    def device_shard(arr, r):
        by_dev = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        return by_dev[mesh.devices.flat[r].id]

    for r in range(world):
        got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), shards[r]))
        want = jax.tree_util.tree_leaves(jax.tree.map(lambda a: device_shard(a, r), placed))
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("paged", [False])
def test_forward_prefill_and_decode_step_match_jax(models, paged):
    """The per-rank forward over a 2-sequence prompt (every logit), the
    bulk prefill of it (slot 1 only, as a batcher admission writes it), then
    one ragged decode step over the two ranks' cache shards: row 1's
    position crosses into rank 1's shard (and with ``paged`` row 0 is parked
    at s_max, a position no rank owns). One JAX program computes the
    forward, the prefill and the decode step, to pay its compile once. The paged cache at world 2
    runs end to end in tests/test_torch_dist_serving.py; here it is left
    out to keep the interpreter's time in budget."""
    jcfg, jparams, tcfg, tparams = models
    s_max, L = 32, 8
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab, (jcfg.batch, L)).astype(np.int32)
    mask = np.array([False, True])
    pick = np.array([0, L - 1], np.int32)
    tokens = rng.integers(0, jcfg.vocab, jcfg.batch).astype(np.int32)
    pos = np.array([s_max if paged else 5, 17], np.int32)

    mesh = _mesh(WORLD)
    jspec = (jdec.PagedKVCacheSpec(s_max, 8, static_table=True) if paged
             else jdec.KVCacheSpec(s_max))
    pcfg_j = dataclasses.replace(jcfg, seq=L)
    cspecs = jspec.specs(jcfg)
    place = lambda tree, specs: jax.tree.map(  # noqa: E731
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)

    def jprogram(p, c, t, m, k, tok, q):
        shard = jdec._prompt_shard(t, jcfg.batch, L, jcfg)
        forward = JaxTPTransformer(pcfg_j)(shard, p)
        c, last = jdec.prefill_cache(pcfg_j, p, c, shard, jspec, s_max, slot_mask=m, pick=k)
        logits, c = jdec.decode_step(jcfg, p, c, tok, q, spec=jspec)
        return forward, last, logits, c

    jforward, jlast, jlogits, jcache = _shard(
        jprogram, mesh,
        (param_specs(jcfg), cspecs, P(None), P(None), P(None), P(None), P(None)),
        (P(None, "tp"), P(None, None), P(None, None), cspecs),
    )(place(jparams, param_specs(jcfg)), place(jspec.init(jcfg, WORLD), cspecs),
      jnp.asarray(prompt.reshape(-1)), jnp.asarray(mask), jnp.asarray(pick),
      jnp.asarray(tokens), jnp.asarray(pos))

    ctx = initialize_distributed(WORLD, device="cpu")
    tspec = (tdec.PagedKVCacheSpec(s_max, 8, static_table=True) if paged
             else tdec.KVCacheSpec(s_max))
    shards = ttm.shard_params(tparams, WORLD)
    caches = [tspec.init(tcfg, "cpu", WORLD) for _ in range(WORLD)]

    m_loc = jcfg.batch * L // WORLD

    def rank():
        r = ctx.rank
        forward = ttm.TPTransformer(dataclasses.replace(tcfg, seq=L), ctx=ctx)(
            torch.from_numpy(prompt.reshape(-1)[r * m_loc:(r + 1) * m_loc]), shards[r])
        cache, last = tdec.prefill_cache(
            dataclasses.replace(tcfg, seq=L), shards[r], caches[r],
            torch.from_numpy(prompt.reshape(-1)), tspec, s_max,
            slot_mask=mask, pick=torch.from_numpy(pick), ctx=ctx,
        )
        logits, cache = tdec.decode_step(tcfg, shards[r], cache, torch.from_numpy(tokens),
                                         pos, spec=tspec, ctx=ctx)
        return forward, last, logits, cache

    outs = ctx.run(rank)
    forward = torch.cat([f for f, *_ in outs], dim=1)  # vocab shards, rank-major
    np.testing.assert_allclose(forward.numpy(), np.asarray(jforward), rtol=TOL, atol=TOL)
    outs = [o[1:] for o in outs]
    for last, logits, _ in outs:  # replicated on every rank
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    # the sequence-sharded cache: rank r's shard is the JAX cache's r-th
    # block along the sharded dim
    for name in ("k", "v"):
        want = np.split(np.asarray(jcache[name]), WORLD, axis=1 if paged else 3)
        for r, (_, _, cache) in enumerate(outs):
            np.testing.assert_allclose(cache[name].numpy(), want[r], rtol=TOL, atol=TOL)
    if paged:
        for r, (_, _, cache) in enumerate(outs):
            np.testing.assert_array_equal(cache["block_table"].numpy(),
                                          np.asarray(jcache["block_table"])[r:r + 1])

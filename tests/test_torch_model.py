"""The PyTorch port's dense model and decode (``triton_dist_tpu_torch/
models``) against the JAX package at world 1: the ``TPTransformer``
forward, ``prefill_cache`` and one ragged ``decode_step`` (contiguous and
paged caches), on the JAX ``init_params`` weights carried over with
``params_from_numpy``. JAX runs inside ``shard_map`` on a 1-device mesh
with its Pallas kernels interpreted, as its own tests run them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.models import init_params as jax_init_params
from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models.tp_transformer import (
    TPTransformer as JaxTPTransformer,
    TransformerConfig as JaxConfig,
    param_specs,
)
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import presets as tpresets
from triton_dist_tpu_torch.models import tp_transformer as ttm

# f32 throughout on both sides, two decoder blocks: the packages differ
# only in summation order (XLA vs PyTorch CPU kernels)
TOL = 1e-4

DIMS = dict(vocab=64, hidden=32, ffn=64, n_layers=2, n_q_heads=8,
            n_kv_heads=4, head_dim=8, batch=2, seq=16)


@pytest.fixture(scope="module")
def models():
    # whole-operand tiles: the fewest interpreted grid steps (the tiling
    # changes only the f32 summation order, well inside the tolerance)
    jcfg = JaxConfig(**DIMS, ag_config=AGGemmConfig(32, 128, 128),
                     rs_config=GemmRSConfig(32, 128, 128))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ttm.TransformerConfig(**DIMS)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                    torch.float32)
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("tp",))
    return jcfg, jparams, tcfg, tparams, mesh1


def _shard(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def test_forward_matches_jax(models):
    jcfg, jparams, tcfg, tparams, mesh1 = models
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, jcfg.batch * jcfg.seq)
    model = JaxTPTransformer(jcfg)
    want = _shard(lambda t, p: model(t, p), mesh1,
                  (P("tp"), param_specs(jcfg)), P(None, "tp"))(
        jnp.asarray(tokens, jnp.int32), jparams)
    got = ttm.TPTransformer(tcfg)(torch.from_numpy(tokens), tparams)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_step_match_jax(models, paged):
    """Bulk prefill of a 2-sequence prompt (slot 1 only, as a batcher
    admission writes it), then one ragged decode step over the cache the
    prefill left."""
    jcfg, jparams, tcfg, tparams, mesh1 = models
    s_max, L = 32, 8
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab, (jcfg.batch, L)).astype(np.int32)
    mask = np.array([False, True])
    pick = np.array([0, L - 1], np.int32)
    tokens = rng.integers(0, jcfg.vocab, jcfg.batch).astype(np.int32)
    # the paged case parks row 0 at s_max, a position no rank owns: its
    # write must drop while it still attends the whole cache
    pos = np.array([s_max if paged else 5, L], np.int32)

    jspec = (jdec.PagedKVCacheSpec(s_max, 8, static_table=True) if paged
             else jdec.KVCacheSpec(s_max))
    pcfg_j = dataclasses.replace(jcfg, seq=L)
    cspecs = jspec.specs(jcfg)
    prefill = _shard(
        lambda p, c, t, m, k: jdec.prefill_cache(pcfg_j, p, c, t, jspec, s_max,
                                                 slot_mask=m, pick=k),
        mesh1, (param_specs(jcfg), cspecs, P(None), P(None), P(None)),
        (cspecs, P(None, None)),
    )
    jcache, jlast = prefill(jparams, jspec.init(jcfg, 1), jnp.asarray(prompt.reshape(-1)),
                            jnp.asarray(mask), jnp.asarray(pick))
    step = _shard(
        lambda p, c, t, q: jdec.decode_step(jcfg, p, c, t, q, spec=jspec),
        mesh1, (param_specs(jcfg), cspecs, P(None), P(None)), (P(None, None), cspecs),
    )
    jlogits, jcache = step(jparams, jcache, jnp.asarray(tokens), jnp.asarray(pos))

    tspec = (tdec.PagedKVCacheSpec(s_max, 8, static_table=True) if paged
             else tdec.KVCacheSpec(s_max))
    tcache = tspec.init(tcfg, "cpu")
    tcache, tlast = tdec.prefill_cache(
        dataclasses.replace(tcfg, seq=L), tparams, tcache,
        torch.from_numpy(prompt.reshape(-1)), tspec, s_max,
        slot_mask=torch.from_numpy(mask), pick=torch.from_numpy(pick),
    )
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=TOL, atol=TOL)
    tlogits, tcache = tdec.decode_step(
        tcfg, tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(pos),
        spec=tspec,
    )
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=TOL, atol=TOL)
    if paged:
        np.testing.assert_array_equal(tcache["block_table"].numpy(),
                                      np.asarray(jcache["block_table"]))


def test_presets_and_seeded_init():
    cfg = tpresets.preset("llama-3.1-8b", n_layers=32, batch=8)
    assert (cfg.hidden, cfg.ffn, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.vocab, cfg.n_layers, cfg.dtype) == (
        4096, 14336, 32, 8, 128, 128256, 32, torch.bfloat16)
    assert isinstance(tpresets.preset("mixtral-8x7b"), ttm.MoETransformerConfig)
    ep = tpresets.preset("mixtral-8x7b:ep")
    assert isinstance(ep, ttm.EPMoETransformerConfig)
    assert (ep.hidden, ep.ffn, ep.n_q_heads, ep.n_kv_heads, ep.vocab, ep.n_experts,
            ep.topk) == (4096, 14336, 32, 8, 32000, 8, 2)
    hier = tpresets.preset("mixtral-8x7b:ep-hier")
    assert isinstance(hier, ttm.EPMoETransformerConfig) and hier.ep_outer == "dcn"
    with pytest.raises(KeyError):
        tpresets.preset("no-such-model")
    # CPU only on request: the seeded init is reproducible there
    small = ttm.TransformerConfig(**DIMS)
    a = ttm.init_params(small, seed=3, device="cpu")
    b = ttm.init_params(small, seed=3, device="cpu")
    assert torch.equal(a["layers"][1]["wqkv"], b["layers"][1]["wqkv"])
    assert a["layers"][0]["wqkv"].shape == (32, 4, (2 + 2) * 8)
    assert a["layers"][0]["w_gate_up"].shape == (32, 64, 2)

"""The PyTorch port's ranged prefill against the JAX package on the CPU.

- **Ops**: the plain multi-position verify (``flash_verify``,
  ``paged_flash_verify``) against JAX's ``flash_verify`` (its XLA golden,
  ``block_s=0``) and ``paged_flash_verify`` (Pallas interpreted, one span
  of every page), with ``soft_cap``, a non-power-of-2 head dim and empty
  rows; the ranged entries at world 2 (the port's ranks threads of one CPU
  ``DistContext``, JAX under ``shard_map``), a range straddling the shard
  boundary and a row parked at ``s_max``.
- **Model**: one ``prefill_cache_ranged`` pass over a cache that already
  holds KV — every logit and the written K/V of every rank — against
  JAX's at world 1 and 2, contiguous and paged; and on the port's plain
  path, two ranges composed against one whole range.

Tolerances: 1e-5 against JAX (f32 on both sides, the same products summed
in another order); 1e-6 relative L2 for composition (the same program on
other row counts: CPU ``torch.matmul`` may block by M, so bits are not
pinned here; the CUDA kernels are held to bits in
``test_torch_cuda_kernels.py``). One decoder block, hidden 32.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import init_params as jax_init_params
from triton_dist_tpu.models.tp_transformer import TransformerConfig as JaxConfig, param_specs
import triton_dist_tpu.ops.flash_decode  # noqa: F401
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

# the JAX package's ops/__init__ re-exports functions under submodule names
jfd = sys.modules["triton_dist_tpu.ops.flash_decode"]

TOL = 1e-5
DIMS = dict(vocab=64, hidden=32, ffn=64, n_layers=1, n_q_heads=8, n_kv_heads=4,
            head_dim=8, batch=2, seq=8)
S_MAX, PAGE = 16, 4


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------- ops ----

VERIFY_CASES = {
    # name: (b, S, hq, h_kv, s, d, soft_cap, page)
    "g4_ragged": (2, 3, 8, 2, 32, 16, 0.0, 8),
    "g1_softcap": (2, 4, 2, 2, 16, 16, 3.0, 4),
    "d96_g2": (1, 3, 4, 2, 16, 96, 0.0, 8),
}


def _verify_inputs(name, seed=0):
    b, S, hq, h_kv, s, d, cap, page = VERIFY_CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, S, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    lens = rng.integers(1, s + 1, (b, S)).astype(np.int32)
    lens[0, 0], lens[-1, -1] = 0, s
    pps = s // page
    table = rng.permutation(b * pps).reshape(b, pps).astype(np.int32)
    kp = np.zeros((b * pps, h_kv, page, d), np.float32)
    vp = np.zeros_like(kp)
    for bi in range(b):
        for ci in range(pps):
            kp[table[bi, ci]] = k[bi, :, ci * page:(ci + 1) * page]
            vp[table[bi, ci]] = v[bi, :, ci * page:(ci + 1) * page]
    return q, k, v, lens, kp, vp, table, cap


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_matches_jax(name):
    q, k, v, lens, kp, vp, table, cap = _verify_inputs(name)
    j = jnp.asarray
    t = torch.from_numpy
    want = jfd.flash_verify(j(q), j(k), j(v), j(lens), return_lse=True,
                            config=jfd.FlashDecodeConfig(block_s=0, soft_cap=cap))
    got = tfd.flash_verify(t(q), t(k), t(v), t(lens), return_lse=True,
                           config=tfd.FlashDecodeConfig(soft_cap=cap))
    pwant = jfd.paged_flash_verify(j(q), j(kp), j(vp), j(lens), j(table), soft_cap=cap,
                                   pages_per_step=table.shape[1], return_lse=True)
    pgot = tfd.paged_flash_verify(t(q), t(kp), t(vp), t(lens), t(table), soft_cap=cap,
                                  return_lse=True)
    for (o, lse), (wo, wl) in ((got, want), (pgot, pwant)):
        _close(o, wo)
        _close(lse, wl)
        empty = lens == 0
        assert (o.numpy()[empty] == 0).all() and np.isneginf(lse.numpy()[empty]).all()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_ranged_entries_world2_match_jax(paged):
    """Rank r holds positions [8r, 8r + 8): the rows of sequence 0 start at
    6, so the range straddles the boundary; sequence 1 is parked at
    s_max (every row attends each whole shard)."""
    b, S, hq, h_kv, d, world = 2, 4, 8, 2, 16, 2
    s_shard = S_MAX // world
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, S, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, S_MAX, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, S_MAX, d)).astype(np.float32)
    pos0 = np.array([6, S_MAX], np.int32)
    mesh = _mesh(world)
    pps = s_shard // PAGE
    # per-rank pools: rank r's pages of sequence bi are [bi * pps, ...)
    pools = [
        [x[:, :, r * s_shard:(r + 1) * s_shard].reshape(b, h_kv, pps, PAGE, d)
         .transpose(0, 2, 1, 3, 4).reshape(b * pps, h_kv, PAGE, d) for x in (k, v)]
        for r in range(world)
    ]
    table = np.arange(b * pps, dtype=np.int32).reshape(b, pps)
    if paged:
        kp = np.concatenate([p[0] for p in pools])
        vp = np.concatenate([p[1] for p in pools])
        want = _shard(
            lambda q, kp, vp, p0, bt: jfd.paged_flash_ranged_prefill_distributed(
                q, kp, vp, p0, bt, pages_per_step=pps),
            mesh, (P(), P("tp"), P("tp"), P(), P()), P(),
        )(q, kp, vp, pos0, table)
    else:
        sp = P(None, None, "tp", None)
        want = _shard(
            lambda q, k, v, p0: jfd.flash_ranged_prefill_distributed(q, k, v, p0),
            mesh, (P(), sp, sp, P()), P(),
        )(q, k, v, pos0)
    ctx = initialize_distributed(world, device="cpu")

    def rank():
        r = ctx.rank
        if paged:
            return tfd.paged_flash_ranged_prefill_distributed(
                torch.from_numpy(q), torch.from_numpy(pools[r][0]),
                torch.from_numpy(pools[r][1]), pos0, torch.from_numpy(table), ctx=ctx)
        sl = slice(r * s_shard, (r + 1) * s_shard)
        return tfd.flash_ranged_prefill_distributed(
            torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(k[:, :, sl])),
            torch.from_numpy(np.ascontiguousarray(v[:, :, sl])), pos0, ctx=ctx)

    for got in ctx.run(rank):
        _close(got, want)


# ----------------------------------------------------------------- model ----


@pytest.fixture(scope="module")
def models():
    # whole-operand tiles; the JAX init's tree filled from numpy (no
    # jax.random program to compile): rows over sqrt(fan-in), norms at one
    jcfg = JaxConfig(**DIMS, ag_config=AGGemmConfig(16, 128, 128),
                     rs_config=GemmRSConfig(16, 128, 128))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jax_init_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) / np.sqrt(x.shape[0]), x.dtype),
        shapes)
    tcfg = ttm.TransformerConfig(**DIMS)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tcfg, tparams


def _filled_cache(spec, cfg_init, world, seed):
    """A cache (the JAX package's global layout) whose K/V already hold
    random values: the range's prior."""
    cache = jax.tree.map(np.asarray, spec.init(cfg_init, world))
    rng = np.random.default_rng(seed)
    for name in ("k", "v"):
        cache[name] = rng.standard_normal(cache[name].shape).astype(np.float32)
    return cache


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_prefill_cache_ranged_matches_jax(models, world, paged):
    """Sequence 0's range [5, 9) crosses the world-2 shard boundary;
    sequence 1 is parked at s_max: its rows write nothing and attend each
    whole shard."""
    jcfg, jparams, tcfg, tparams = models
    S = 4
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (jcfg.batch, S)).astype(np.int32)
    pos0 = np.array([5, S_MAX], np.int32)
    jspec = (jdec.PagedKVCacheSpec(S_MAX, PAGE, static_table=True) if paged
             else jdec.KVCacheSpec(S_MAX))
    cache0 = _filled_cache(jspec, jcfg, world, seed=2)
    mesh = _mesh(world)
    cspecs = jspec.specs(jcfg)
    place = lambda tree, specs: jax.tree.map(  # noqa: E731
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)
    jlogits, jcache = _shard(
        lambda p, c, t, p0: jdec.prefill_cache_ranged(jcfg, p, c, t, p0, spec=jspec),
        mesh, (param_specs(jcfg), cspecs, P(), P()), (P(), cspecs),
    )(place(jparams, param_specs(jcfg)), place(cache0, cspecs), tokens, pos0)

    tspec = (tdec.PagedKVCacheSpec(S_MAX, PAGE, static_table=True) if paged
             else tdec.KVCacheSpec(S_MAX))
    axis = 1 if paged else 3
    caches = [
        {name: torch.from_numpy(np.ascontiguousarray(part))
         for name, part in zip(("k", "v"), (np.split(cache0["k"], world, axis)[r],
                                            np.split(cache0["v"], world, axis)[r]))}
        for r in range(world)
    ]
    if paged:
        for r, c in enumerate(caches):
            c["block_table"] = torch.from_numpy(cache0["block_table"][r:r + 1].copy())
    if world == 1:
        outs = [tdec.prefill_cache_ranged(tcfg, tparams, caches[0], torch.from_numpy(tokens),
                                          pos0, spec=tspec)]
    else:
        ctx = initialize_distributed(world, device="cpu")
        shards = ttm.shard_params(tparams, world)
        outs = ctx.run(lambda: tdec.prefill_cache_ranged(
            tcfg, shards[ctx.rank], caches[ctx.rank], torch.from_numpy(tokens), pos0,
            spec=tspec, ctx=ctx))
    for r, (logits, cache) in enumerate(outs):
        _close(logits, jlogits)   # replicated on every rank
        for name in ("k", "v"):
            _close(cache[name], np.split(np.asarray(jcache[name]), world, axis)[r])


def _rel_l2(a, b):
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_ranged_composition_on_the_plain_path(models, paged):
    """Ranges [0, 3) + [3, 8) against one [0, 8) pass over an empty cache:
    the same logits rows and the same written K/V."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab, (tcfg.batch, 8)))
    spec = (tdec.PagedKVCacheSpec(S_MAX, PAGE, static_table=True) if paged
            else tdec.KVCacheSpec(S_MAX))

    def run(splits):
        cache, lo, rows = spec.init(tcfg, "cpu"), 0, []
        for hi in splits:
            logits, cache = tdec.prefill_cache_ranged(tcfg, tparams, cache, tokens[:, lo:hi],
                                                      lo, spec=spec)
            rows.append(logits)
            lo = hi
        return torch.cat(rows, dim=1), cache

    whole, wcache = run([8])
    parts, pcache = run([3, 8])
    assert _rel_l2(parts, whole) <= 1e-6
    for name in ("k", "v"):
        assert _rel_l2(pcache[name], wcache[name]) <= 1e-6
    # and the same rows as the token-by-token decode chain
    cache, chain = spec.init(tcfg, "cpu"), []
    for i in range(8):
        logits, cache = tdec.decode_step(tcfg, tparams, cache, tokens[:, i], i, spec=spec)
        chain.append(logits)
    _close(whole, torch.stack(chain, dim=1))

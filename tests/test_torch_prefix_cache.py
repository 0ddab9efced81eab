"""The PyTorch port's radix prefix cache, chunked prefill and their serving
modes against the JAX package on the CPU.

- **Prefix cache unit**: one seeded script of acquire / publish / release
  (with strikes and eviction under pool pressure) drives the JAX
  ``PagePrefixCache`` and the port's; every return value, the block table,
  ``stats()`` and ``audit()`` must be equal after each operation.
- **Batcher** (the cases of the JAX package's own ranged-prefill tests):
  prefix-cache admission under ``prefill=True`` (trie hit: a ranged suffix
  pass; miss: a whole-prompt ranged pass) and token-fed, greedy and
  seeded-sampled; chunked admission against bulk and token-fed, with its
  swept-work counter; chunked x paged x prefix cache; armed but never
  triggered; decode interleaving; validation. Every class must give the
  JAX package's token-fed tokens, and the port's classes must agree among
  themselves.
- **Engine**: a ``FakeClock`` serve of a ``shared_prefix_mix`` trace with
  the prefix cache, chunked prefill and the prefill work charge, at world
  1 and 2, against the JAX engine: per-request tokens, lifecycle
  timestamps, ``snapshot()`` (its ``prefix_cache`` section included) and
  the trace fingerprint; and the long-prompt traffic stream.

f32 on both sides, one decoder block, hidden 32, so the interpreter stays
fast; sampling draws from the same numpy streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import init_params as jax_init_params
from triton_dist_tpu.models import prefix_cache as jpx
from triton_dist_tpu.models.tp_transformer import TransformerConfig as JaxConfig
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.resilience import retry as jretry
from triton_dist_tpu.serving import engine as jeng
from triton_dist_tpu.serving import traffic as jtraffic
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import prefix_cache as tpx
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.resilience import retry as tretry
from triton_dist_tpu_torch.serving import engine as teng
from triton_dist_tpu_torch.serving import traffic as ttraffic

DIMS = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=8, n_kv_heads=4,
            head_dim=8, batch=2, seq=8)
S_MAX = 32


# -------------------------------------------------------- prefix cache unit --


def _px_script(mod, seed):
    """Seeded acquire / publish / release (strike) script over 3 slots and a
    pool of 4 pages a rank on 2 ranks; prompts share prefixes from a small
    pool, so hits, dedups and evictions all happen. Returns every
    operation's result with the table, stats and audit after it."""
    rng = np.random.default_rng(seed)
    cache = mod.PagePrefixCache(mod.PrefixCacheConfig(), n_slots=3, page=2, pps_local=4,
                                n_pes=2)
    bases = [[int(t) for t in rng.integers(0, 5, 12)] for _ in range(2)]
    prompts: dict[int, list] = {}
    trail = []
    for _ in range(120):
        slot = int(rng.integers(0, 3))
        if slot not in prompts:
            base = bases[int(rng.integers(0, 2))]
            cut = int(rng.integers(1, 9))
            prompt = base[:cut] + [int(t) for t in rng.integers(0, 5, int(rng.integers(1, 4)))]
            max_new = int(rng.integers(1, 16 - len(prompt) + 1))
            prompts[slot] = prompt
            out = ("acquire", slot, cache.acquire(slot, prompt, max_new))
        else:
            prompt, pg = prompts[slot], cache.page
            g = cache.next_publish(slot)
            if rng.random() < 0.6 and (g + 1) * pg <= len(prompt):
                out = ("publish", slot, cache.publish(slot, g, prompt[g * pg:(g + 1) * pg]))
            else:
                strike = bool(rng.random() < 0.15)
                readers = cache.release(slot, strike=strike)
                for j in readers:
                    cache.release(j)
                    prompts.pop(j)
                prompts.pop(slot)
                out = ("release", slot, strike, list(readers))
        cache.audit()
        trail.append((out, cache.table.tolist(), cache.stats()))
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_script_matches_jax(seed):
    got, want = _px_script(tpx, seed), _px_script(jpx, seed)
    assert got == want
    stats = got[-1][2]
    assert stats["hits"] > 0 and stats["published_pages"] > 0


def test_prefix_cache_eviction_and_validation_match_jax():
    for mod in (tpx, jpx):
        with pytest.raises(ValueError, match="min_hit_pages"):
            mod.PrefixCacheConfig(min_hit_pages=0).validate()
    results = []
    for mod in (tpx, jpx):
        c = mod.PagePrefixCache(mod.PrefixCacheConfig(min_hit_pages=2), n_slots=2, page=2,
                                pps_local=3, n_pes=1)
        trail = [c.acquire(0, [1, 2, 3, 4, 5], 1)]
        for g in range(2):
            trail.append(c.publish(0, g, [1, 2, 3, 4][2 * g:2 * g + 2]))
        c.release(0)
        trail.append(c.acquire(1, [1, 2, 9], 3))       # one page: below min_hit_pages
        trail.append(c.acquire(0, [1, 2, 3, 4, 7], 1))  # two pages: a hit
        c.release(0)
        c.release(1)
        trail.append(c.acquire(0, [8, 8, 8, 8, 8], 1))  # a cold prompt
        trail.append(c.acquire(1, [6, 6, 6, 6, 6], 1))  # pool pressure: evicts the trie
        c.audit()
        results.append((trail, c.table.tolist(), c.stats()))
    assert results[0] == results[1]
    assert results[0][2]["evicted_pages"] > 0


# ------------------------------------------------------------------ batcher --


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


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    p1 = [int(x) for x in rng.integers(0, 32, 8)]
    p2 = p1[:6] + [int(x) for x in rng.integers(0, 32, 2)]  # shares page 0
    return p1, p2


def _mk(mod, uid, prompt, **kw):
    return mod.Request(list(prompt), max_new_tokens=6, uid=uid, **kw)


def _greedy(mod, p1, p2):
    return [_mk(mod, "a", p1), _mk(mod, "b", p1), _mk(mod, "c", p2)]


def _sampled(mod, p1, _p2):
    return [_mk(mod, "a", p1, temperature=0.8, seed=3),
            _mk(mod, "b", p1, temperature=0.8, seed=3)]


def _run(batcher, reqs):
    out = {}
    for r in reqs:
        batcher.submit(r)
        out.update(dict(batcher.run()))
    return out


@pytest.fixture(scope="module")
def jax_tokens(models, prompts):
    """The JAX package's token-fed streams (paged cache, world 1), one
    batcher per request list. Token-fed streams do not depend on which
    requests share a step, so each list is submitted at once and its
    requests decode side by side: fewer interpreted steps."""
    jcfg, jparams, _, _ = models
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("tp",))
    out = {}
    for name, reqs in (("greedy", _greedy), ("sampled", _sampled)):
        bt = jdec.ContinuousBatcher(jcfg, jparams, mesh1, s_max=S_MAX, page_size=4)
        for r in reqs(jdec, *prompts):
            bt.submit(r)
        out[name] = dict(bt.run())
    return out


def _port(models, reqs, **kw):
    _, _, tcfg, tparams = models
    bt = tdec.ContinuousBatcher(tcfg, tparams, s_max=S_MAX, device="cpu", **kw)
    return _run(bt, reqs), bt


def test_px_prefill_admission_matches_jax(models, prompts, jax_tokens):
    """Trie hit (a ranged suffix pass), miss (a whole-prompt ranged pass)
    and token-fed prefix-cache admission give the JAX token-fed stream, and
    the hits skipped fed tokens."""
    px = dict(page_size=4, prefix_cache=tpx.PrefixCacheConfig())
    o_pxp, bt = _port(models, _greedy(tdec, *prompts), prefill=True, **px)
    o_pxt, _ = _port(models, _greedy(tdec, *prompts), **px)
    o_tok, _ = _port(models, _greedy(tdec, *prompts), page_size=4)
    assert o_pxp == o_pxt == o_tok == jax_tokens["greedy"]
    stats = bt.prefix_cache_stats()
    assert stats["hits"] >= 2 and stats["prefill_tokens_saved"] > 0
    bt.prefix_cache.audit()


def test_px_prefill_sampled_matches_jax(models, prompts, jax_tokens):
    px = dict(page_size=4, prefix_cache=tpx.PrefixCacheConfig())
    s_pxp, _ = _port(models, _sampled(tdec, *prompts), prefill=True, **px)
    s_pxt, _ = _port(models, _sampled(tdec, *prompts), **px)
    assert s_pxp == s_pxt == jax_tokens["sampled"]
    assert s_pxp["a"] == s_pxp["b"]  # the hit's tokens are the miss's


def test_chunked_prefill_matches_bulk_and_token_fed(models, prompts, jax_tokens):
    """Chunked admission (3-token chunks) against token-fed and bulk: one
    class, the JAX stream; the swept-work counter prices the chunk strips
    (4*3 + 4*6 + 2*8 = 52 pairs a prompt) below the bulk 8 x 8 rectangle."""
    p1, p2 = prompts
    reqs = lambda: [_mk(tdec, "a", p1), _mk(tdec, "c", p2)]  # noqa: E731
    c_on, bt_on = _port(models, reqs(), prefill=True, prefill_chunk_tokens=3)
    c_tok, _ = _port(models, reqs())
    c_off, bt_off = _port(models, reqs(), prefill=True)
    want = {u: jax_tokens["greedy"][u] for u in ("a", "c")}
    assert c_on == c_tok == c_off == want
    assert bt_on.prefill_work_total == 2 * 52
    assert bt_off.prefill_work_total == 2 * 64
    assert bt_on.prefill_tokens_total == bt_off.prefill_tokens_total == 16


def test_chunked_composes_with_paged_and_px(models, prompts, jax_tokens):
    p1, _ = prompts
    cp_on, _ = _port(models, [_mk(tdec, "a", p1)], prefill=True, prefill_chunk_tokens=3,
                     page_size=4)
    assert cp_on["a"] == jax_tokens["greedy"]["a"]
    cpx_on, bt = _port(models, _greedy(tdec, *prompts), page_size=4,
                       prefix_cache=tpx.PrefixCacheConfig(), prefill=True,
                       prefill_chunk_tokens=2)
    assert cpx_on == jax_tokens["greedy"]
    bt.prefix_cache.audit()


def test_chunked_armed_untriggered_is_bulk(models, prompts):
    p1, _ = prompts
    u_on, bt_u = _port(models, [_mk(tdec, "a", p1)], prefill=True, prefill_chunk_tokens=16)
    u_off, bt_d = _port(models, [_mk(tdec, "a", p1)], prefill=True)
    assert u_on == u_off
    assert bt_u.prefill_work_total == bt_d.prefill_work_total


def test_chunked_interleaves_decode(models, prompts, jax_tokens):
    """A long prompt chunking at 2 tokens while a neighbour decodes: the
    neighbour progresses during the chunk steps, and the long request's
    tokens stay the JAX token-fed ones."""
    _, _, tcfg, tparams = models
    p1, _ = prompts
    bt = tdec.ContinuousBatcher(tcfg, tparams, s_max=S_MAX, device="cpu", prefill=True,
                                prefill_chunk_tokens=2)
    bt.submit(_mk(tdec, "short", p1[:2]))
    bt.step()
    bt.submit(_mk(tdec, "long", p1))
    progress = []
    for _ in range(16):
        if bt.idle:
            break
        had_chunk = 1 in bt._chunk
        before = len(bt.slot_out[0]) if bt.slot_req[0] else None
        bt.step()
        after = len(bt.slot_out[0]) if bt.slot_req[0] else None
        if had_chunk and before is not None and after is not None:
            progress.append(after > before)
    done = dict(bt.drain_finished())
    assert sorted(done) == ["long", "short"]
    assert done["long"] == jax_tokens["greedy"]["a"]
    assert any(progress), "the neighbour never decoded during chunking"


def test_ranged_modes_validate(models):
    _, _, tcfg, tparams = models
    kw = dict(s_max=S_MAX, device="cpu")
    with pytest.raises(ValueError, match="prefill=True"):
        tdec.ContinuousBatcher(tcfg, tparams, prefill_chunk_tokens=4, **kw)
    with pytest.raises(ValueError, match=">= 1"):
        tdec.ContinuousBatcher(tcfg, tparams, prefill=True, prefill_chunk_tokens=0, **kw)
    with pytest.raises(ValueError, match="paged cache"):
        tdec.ContinuousBatcher(tcfg, tparams, prefix_cache=tpx.PrefixCacheConfig(), **kw)
    with pytest.raises(ValueError, match="min_hit_pages"):
        tdec.ContinuousBatcher(tcfg, tparams, page_size=4,
                               prefix_cache=tpx.PrefixCacheConfig(min_hit_pages=0), **kw)
    with pytest.raises(NotImplementedError, match="static_table"):
        tdec.prefill_cache_ranged(
            tcfg, tparams, tdec.PagedKVCacheSpec(S_MAX, 4).init(tcfg, "cpu"),
            torch.zeros((2, 2), dtype=torch.long), 0, spec=tdec.PagedKVCacheSpec(S_MAX, 4))


# ------------------------------------------------------------------- engine --


def _trace(traffic_mod):
    spec = traffic_mod.shared_prefix_mix(
        s_max=S_MAX, rate_rps=6.0, n_requests=5, n_prefixes=2, prefix_tokens=8,
        suffix_len=("uniform", 2, 6), output_len=("uniform", 2, 3), vocab=DIMS["vocab"],
        seed=5,
    )
    return traffic_mod.generate_trace(spec)


@pytest.mark.parametrize("world", [1, 2])
def test_engine_px_chunked_serve_matches_jax(models, world):
    jcfg, jparams, tcfg, tparams = models
    serving = dict(virtual_step_s=0.01, virtual_prefill_work_s=1e-3, max_queue=8,
                   prefill_chunk_tokens=4)
    kw = dict(page_size=4, prefill=True)
    jtrace, ttrace = _trace(jtraffic), _trace(ttraffic)
    assert ttraffic.trace_fingerprint(ttrace) == jtraffic.trace_fingerprint(jtrace)
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    jeng_ = jeng.ServingEngine(
        jcfg, jparams, mesh, s_max=S_MAX, clock=jretry.FakeClock(),
        serving=jeng.ServingConfig(prefix_cache=jpx.PrefixCacheConfig(), **serving), **kw,
    )
    jdone = jeng_.serve(jtrace)
    teng_ = teng.ServingEngine(
        tcfg, tparams, s_max=S_MAX, clock=tretry.FakeClock(), device="cpu",
        ctx=initialize_distributed(world, device="cpu") if world > 1 else None,
        serving=teng.ServingConfig(prefix_cache=tpx.PrefixCacheConfig(), **serving), **kw,
    )
    tdone = teng_.serve(ttrace)
    assert sorted(tdone) == sorted(jdone)
    for uid, want in jdone.items():
        got = tdone[uid]
        assert got.tokens == want.tokens, uid
        assert (got.t_enqueue, got.t_admitted, got.t_first_token, got.t_finished) == (
            want.t_enqueue, want.t_admitted, want.t_first_token, want.t_finished), uid
    jsnap, tsnap = jeng_.snapshot(), teng_.snapshot()
    for key in ("requests", "tokens", "latency_ms", "load", "slo", "engine", "prefix_cache"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["prefix_cache"]["hits"] > 0
    teng_._batcher.prefix_cache.audit()


def test_long_prompt_stream_matches_jax():
    """The long-prompt traffic stream: an armed spec replaces only the
    long prompts, the prefix pool prepends after the replacement, and the
    fingerprints equal the JAX package's; validation is as loud."""
    base = dict(rate_rps=4.0, n_requests=24, prompt_len=("uniform", 2, 6),
                output_len=("fixed", 4), vocab=32, seed=11)
    armed = dict(long_prompt_frac=0.3, long_prompt_len=("fixed", 20))
    px = dict(prefix_pool=1, prefix_len=("fixed", 4), prefix_share=1.0)
    traces = {}
    for name, mod in (("port", ttraffic), ("jax", jtraffic)):
        traces[name] = [mod.generate_trace(mod.TrafficSpec(**base, **over))
                        for over in ({}, armed, {**armed, **px})]
        with pytest.raises(ValueError, match="long_prompt_len"):
            mod.TrafficSpec(**base, long_prompt_frac=0.5).validate()
        with pytest.raises(ValueError, match="long_prompt_frac"):
            mod.TrafficSpec(**base, long_prompt_len=("fixed", 20)).validate()
    for got, want in zip(traces["port"], traces["jax"]):
        assert ttraffic.trace_fingerprint(got) == jtraffic.trace_fingerprint(want)
    plain, long_, pxt = traces["port"]
    n_long = 0
    for a, b in zip(plain, long_):
        assert a.t_s == b.t_s
        if len(b.request.prompt) == 20:
            n_long += 1
        else:
            assert a.request.prompt == b.request.prompt
    assert 0 < n_long < len(plain)
    for a, b in zip(long_, pxt):
        assert b.request.prompt[4:] == a.request.prompt
    with pytest.raises(ValueError, match="exceeds s_max"):
        ttraffic.shared_prefix_mix(s_max=16, rate_rps=1.0, n_requests=2, prefix_tokens=12)

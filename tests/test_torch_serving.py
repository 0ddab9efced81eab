"""The PyTorch port's serving slice against the JAX package at world 1:
``ContinuousBatcher``, greedy ``generate``, and a ``FakeClock``
``ServingEngine`` serve of a seeded trace plus one seeded-sampled request,
on the contiguous cache and on the paged cache with bulk prefill. Tokens,
lifecycle timestamps, ``snapshot()`` and ``trace_fingerprint`` must be
identical — both packages run f32 on the same weights, and sampling draws
from the same numpy streams.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import init_params as jax_init_params
from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models.tp_transformer import TransformerConfig as JaxConfig
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.resilience import retry as jretry
from triton_dist_tpu.serving import engine as jeng
from triton_dist_tpu.serving import metrics as jmetrics
from triton_dist_tpu.serving import traffic as jtraffic
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models.prefix_cache import PrefixCacheConfig
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.resilience import retry as tretry
from triton_dist_tpu_torch.serving import engine as teng
from triton_dist_tpu_torch.serving import metrics as tmetrics
from triton_dist_tpu_torch.serving import traffic as ttraffic

DIMS = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=4,
            n_kv_heads=2, head_dim=8, batch=2, seq=8)
S_MAX = 16


@pytest.fixture(scope="module")
def tiny():
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


def _spec(traffic_mod, **over):
    base = dict(rate_rps=8.0, n_requests=5, prompt_len=("uniform", 2, 6),
                output_len=("uniform", 2, 5), vocab=DIMS["vocab"], seed=3)
    base.update(over)
    return traffic_mod.TrafficSpec(**base)


def _sampled(dec_mod, traffic_mod):
    req = dec_mod.Request([4, 5, 6], max_new_tokens=5, temperature=0.8, top_k=6,
                          seed=77, uid="sampled")
    return traffic_mod.Arrival(t_s=0.05, request=req, deadline_ms=200)


def test_trace_fingerprint_matches_jax():
    for over in ({}, dict(process="burst", deadline_ms=("uniform", 50, 400),
                          priority_mix=((3, "interactive"), (1, "batch")),
                          prefix_pool=2, client_pool=3,
                          long_prompt_frac=0.5, long_prompt_len=("fixed", 9))):
        jt = jtraffic.generate_trace(_spec(jtraffic, **over))
        tt = ttraffic.generate_trace(_spec(ttraffic, **over))
        assert ttraffic.trace_fingerprint(tt) == jtraffic.trace_fingerprint(jt)
    jp = jtraffic.preset_mix("llama-3.1-8b", s_max=64, rate_rps=4.0, n_requests=6, vocab=32)
    tp = ttraffic.preset_mix("llama-3.1-8b", s_max=64, rate_rps=4.0, n_requests=6, vocab=32)
    assert ttraffic.trace_fingerprint(ttraffic.generate_trace(tp)) == (
        jtraffic.trace_fingerprint(jtraffic.generate_trace(jp)))


def _metrics_readout(mod):
    h = mod.StreamingHistogram(lo=1.0, hi=1e4)
    for v in (2.0, 3.0, 50.0, 700.0):
        h.record(v)
    m = mod.ServingMetrics(slo=mod.SLOTargets(ttft_ms=10.0))
    m.observe_finished(ttft_ms=5.0, e2e_ms=9.0, tpot_ms=None, n_tokens=3)
    m.observe_finished(ttft_ms=50.0, e2e_ms=90.0, tpot_ms=2.0, n_tokens=4)
    return h.snapshot(), h.fraction_le(60.0), m.snapshot()


def test_histogram_and_slo_copy_match_jax():
    assert _metrics_readout(tmetrics) == _metrics_readout(jmetrics)


@pytest.mark.parametrize("kw", [dict(), dict(page_size=8, prefill=True)],
                         ids=["contiguous", "paged_prefill"])
def test_engine_serve_matches_jax(tiny, kw):
    jcfg, jparams, tcfg, tparams, mesh1 = tiny
    serving = dict(virtual_step_s=0.01, virtual_prefill_work_s=1e-4, max_queue=3)
    jeng_ = jeng.ServingEngine(
        jcfg, jparams, mesh1, s_max=S_MAX, clock=jretry.FakeClock(),
        serving=jeng.ServingConfig(slo=jmetrics.SLOTargets(ttft_ms=80.0), **serving),
        **kw,
    )
    jdone = jeng_.serve(jtraffic.generate_trace(_spec(jtraffic))
                        + (_sampled(jdec, jtraffic),))
    teng_ = teng.ServingEngine(
        tcfg, tparams, s_max=S_MAX, clock=tretry.FakeClock(), device="cpu",
        serving=teng.ServingConfig(slo=tmetrics.SLOTargets(ttft_ms=80.0), **serving),
        **kw,
    )
    tdone = teng_.serve(ttraffic.generate_trace(_spec(ttraffic))
                        + (_sampled(tdec, ttraffic),))
    assert sorted(tdone) == sorted(jdone)
    for uid, want in jdone.items():
        got = tdone[uid]
        assert got.tokens == want.tokens, uid
        assert (got.t_enqueue, got.t_admitted, got.t_first_token, got.t_finished) == (
            want.t_enqueue, want.t_admitted, want.t_first_token, want.t_finished), uid
    jsnap, tsnap = jeng_.snapshot(), teng_.snapshot()
    for key in ("requests", "tokens", "latency_ms", "load", "slo"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["engine"] == jsnap["engine"]


def test_batcher_and_generate_match_jax(tiny):
    jcfg, jparams, tcfg, tparams, mesh1 = tiny
    reqs = lambda mod: [  # noqa: E731
        mod.Request([1, 2, 3], max_new_tokens=4, uid="a"),
        mod.Request([7, 1], max_new_tokens=1, uid="one"),
        mod.Request([5, 4, 3, 2, 1], max_new_tokens=3, temperature=0.9, seed=5, uid="s"),
        mod.Request([9], max_new_tokens=4, eos_id=2, uid="eos"),
    ]
    jb = jdec.ContinuousBatcher(jcfg, jparams, mesh1, s_max=S_MAX)
    tb = tdec.ContinuousBatcher(tcfg, tparams, s_max=S_MAX, device="cpu")
    for j, t in zip(reqs(jdec), reqs(tdec)):
        jb.submit(j)
        tb.submit(t)
    assert tb.run(max_steps=100) == jb.run(max_steps=100)

    prompt = np.array([[3, 1, 4, 1], [5, 9, 2, 6]], np.int32)
    for kw in (dict(), dict(page_size=8)):  # page_size alone: the bump allocator
        want = jdec.generate(jcfg, jparams, prompt, 5, mesh1, s_max=S_MAX, **kw)
        got = tdec.generate(tcfg, tparams, prompt, 5, s_max=S_MAX, device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_later_slices_refuse_loudly(tiny):
    _, _, tcfg, tparams, _ = tiny
    for name in ("overload", "speculative"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            teng.ServingConfig(**{name: 1}).validate()
    # the ranged-prefill modes are ported: accepted, validated, passed on
    px = teng.ServingConfig(prefix_cache=PrefixCacheConfig(), prefill_chunk_tokens=4).validate()
    armed = teng.ServingEngine(tcfg, tparams, s_max=S_MAX, clock=tretry.FakeClock(),
                               device="cpu", page_size=4, prefill=True, serving=px)
    assert armed._batcher.prefill_chunk_tokens == 4
    assert armed._batcher.prefix_cache is not None
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        teng.ServingConfig(prefill_chunk_tokens=0).validate()
    eng = teng.ServingEngine(tcfg, tparams, s_max=S_MAX, clock=tretry.FakeClock(),
                             device="cpu", serving=teng.ServingConfig(max_queue=1))
    uids = [eng.submit(tdec.Request([1, 2], max_new_tokens=2, uid=i)) for i in range(4)]
    assert uids[:3] == [0, 1, 2] and isinstance(uids[3], teng.Rejected)
    with pytest.raises(ValueError, match="exceeds s_max"):
        eng.submit(tdec.Request([1] * 10, max_new_tokens=10, uid="big"))
    assert sorted(eng.run_until_idle()) == [0, 1, 2]

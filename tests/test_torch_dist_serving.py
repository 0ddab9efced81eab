"""The PyTorch port's serving engine at world 2 against the JAX engine on
a 2-device mesh, on the CPU: one seeded ``FakeClock`` serve of a traffic
trace plus one seeded-sampled request, paged cache with bulk prefill. Per
request the tokens and the lifecycle timestamps must be identical, and so
must the trace fingerprint and the snapshot (``world_size`` 2 on both).
Both run f32 on the same weights, and sampling draws from the same numpy
streams; the port's two ranks are threads of one CPU ``DistContext``, the
JAX side interprets its Pallas kernels under ``shard_map``. One decoder
block, hidden 32, few requests, so the interpreter stays fast.
"""

import jax
import numpy as np
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import init_params as jax_init_params
from triton_dist_tpu.models.tp_transformer import TransformerConfig as JaxConfig
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.resilience import retry as jretry
from triton_dist_tpu.serving import engine as jeng
from triton_dist_tpu.serving import metrics as jmetrics
from triton_dist_tpu.serving import traffic as jtraffic
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.resilience import retry as tretry
from triton_dist_tpu_torch.serving import engine as teng
from triton_dist_tpu_torch.serving import metrics as tmetrics
from triton_dist_tpu_torch.serving import traffic as ttraffic

DIMS = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=4,
            n_kv_heads=2, head_dim=8, batch=2, seq=8)
S_MAX = 16
WORLD = 2


def _spec(traffic_mod):
    return traffic_mod.TrafficSpec(
        rate_rps=8.0, n_requests=2, prompt_len=("uniform", 5, 8),
        output_len=("uniform", 2, 4), vocab=DIMS["vocab"], seed=11,
    )


def _sampled(dec_mod, traffic_mod):
    req = dec_mod.Request([4, 5, 6, 7, 8], max_new_tokens=3, temperature=0.8, top_k=6,
                          seed=77, uid="sampled")
    return traffic_mod.Arrival(t_s=0.05, request=req, deadline_ms=200)


def test_engine_serve_world2_matches_jax():
    # whole-operand tiles: the fewest interpreted grid steps
    jcfg = JaxConfig(**DIMS, ag_config=AGGemmConfig(16, 128, 128),
                     rs_config=GemmRSConfig(16, 128, 128))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ttm.TransformerConfig(**DIMS)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                    torch.float32)
    mesh2 = Mesh(np.array(jax.devices()[:WORLD]), ("tp",))
    serving = dict(virtual_step_s=0.01, virtual_prefill_work_s=1e-4, max_queue=3)
    kw = dict(page_size=4, prefill=True)

    jtrace = jtraffic.generate_trace(_spec(jtraffic)) + (_sampled(jdec, jtraffic),)
    ttrace = ttraffic.generate_trace(_spec(ttraffic)) + (_sampled(tdec, ttraffic),)
    assert ttraffic.trace_fingerprint(ttrace) == jtraffic.trace_fingerprint(jtrace)

    jeng_ = jeng.ServingEngine(
        jcfg, jparams, mesh2, s_max=S_MAX, clock=jretry.FakeClock(),
        serving=jeng.ServingConfig(slo=jmetrics.SLOTargets(ttft_ms=80.0), **serving),
        **kw,
    )
    jdone = jeng_.serve(jtrace)
    teng_ = teng.ServingEngine(
        tcfg, tparams, s_max=S_MAX, clock=tretry.FakeClock(), device="cpu",
        ctx=initialize_distributed(WORLD, device="cpu"),
        serving=teng.ServingConfig(slo=tmetrics.SLOTargets(ttft_ms=80.0), **serving),
        **kw,
    )
    tdone = teng_.serve(ttrace)
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
    assert tsnap["engine"]["world_size"] == WORLD

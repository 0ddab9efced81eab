"""The PyTorch port's ring collectives against the JAX package on the CPU:
the span schedule, ``ag_gemm`` (the ring AG-GEMM, chunks 1/2/3),
``gemm_rs(method="ring")`` (chunks 1/2/3) and ``reduce_scatter(method=
"ring")`` at world 2 and 4, the differentiable pair with ring configs
against ``jax.vjp``, and at world 2 a one-block dense model on a ring
context — its forward, one ``train_step`` and a greedy serve — against the
JAX model with the same ``ag_config``/``rs_config``.

A ring context is a CPU ``DistContext`` declared so (``ctx.full_mesh =
False``): its ranks are threads running the ring kernels' plain versions,
which follow the ring's hop order and round once per hop. The JAX side
runs its ring kernels interpreted under ``shard_map`` on the virtual CPU
devices of ``tests/conftest.py``; payloads stay at a few KiB.

f32 throughout; the packages differ in summation order only: 1e-5 (the
model's gradients and parameters 1e-4). Gathers are copies and must be
exact, greedy tokens identical.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops import common as jcommon
from triton_dist_tpu.ops import grads as jgrads
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig as JaxAGConfig
from triton_dist_tpu.ops.allgather_gemm import ag_gemm as jax_ag_gemm
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig as JaxRSConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import gemm_rs as jax_gemm_rs
from triton_dist_tpu.ops.reduce_scatter import ReduceScatterConfig as JaxRSCConfig
from triton_dist_tpu.ops.reduce_scatter import reduce_scatter as jax_reduce_scatter
from triton_dist_tpu.utils import pick_block as jax_pick_block
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import allgather_gemm as tagg
from triton_dist_tpu_torch.ops import common as tcommon
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as tgrs
from triton_dist_tpu_torch.ops import grads as tgrads
from triton_dist_tpu_torch.ops import reduce_scatter as trs
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

TOL, GRAD_TOL, LR = 1e-5, 1e-4, 0.5
WORLDS = [2, 4]
CHUNKS = [1, 2, 3]


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _ring(world):
    ctx = initialize_distributed(world, device="cpu")
    ctx.full_mesh = False
    return ctx


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_chunk_schedule_matches_jax():
    """The spans of every (rows, chunks, quantum) of a sweep, and the
    quantized spans the three ring ops take, equal JAX's."""
    for rows in range(1, 41):
        for chunks in range(1, 7):
            for quantum in (1, 2, 3, 4, 8, 64):
                assert tcommon.chunk_schedule(rows, chunks, quantum) == \
                    jcommon.chunk_schedule(rows, chunks, quantum), (rows, chunks, quantum)
            for block_m in (1, 8, 256, 512):
                want = jcommon.chunk_schedule(
                    rows, chunks,
                    quantum=jax_pick_block(rows, min(block_m, max(1, rows // chunks))))
                assert tcommon.ring_spans(rows, chunks, block_m) == want
    with pytest.raises(ValueError, match="rows"):
        tcommon.chunk_schedule(0, 1)
    with pytest.raises(ValueError, match="at most 16"):
        tcommon.ring_spans(64, 17, 1)


def test_configs_map_field_by_field():
    """The port's ``AGGemmConfig``, ``GemmRSConfig`` and
    ``ReduceScatterConfig`` carry the JAX package's fields, defaults
    included, so a JAX config maps onto the port's by its fields; the
    model config and the presets carry them to every projection."""
    pairs = ((JaxAGConfig, tagg.AGGemmConfig), (JaxRSConfig, tgrs.GemmRSConfig),
             (JaxRSCConfig, trs.ReduceScatterConfig))
    for jcls, tcls in pairs:
        assert [(f.name, f.default) for f in dataclasses.fields(jcls)] == \
            [(f.name, f.default) for f in dataclasses.fields(tcls)]
        jcfg = jcls(chunks_per_shard=3)
        assert dataclasses.asdict(tcls(**dataclasses.asdict(jcfg))) == dataclasses.asdict(jcfg)
    jcfg = jtm.TransformerConfig(**DENSE, **JAX_RING)
    tcfg = ttm.TransformerConfig(**DENSE, **{
        k: tcls(**dataclasses.asdict(getattr(jcfg, k)))
        for k, tcls in (("ag_config", tagg.AGGemmConfig), ("rs_config", tgrs.GemmRSConfig))})
    assert tcfg == ttm.TransformerConfig(**DENSE, **PORT_RING)


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_ag_gemm_matches_jax(world, chunks):
    """The ring AG-GEMM on a ring context (spans (8), (4, 4), (4, 2, 2)
    of 8 rows) against JAX's ring kernel with the same config; the gathered
    A exact; chunks 1 bit-equal to the ring schedule run as one span."""
    m_loc, k, n_loc = 8, 64, 32
    rng = np.random.default_rng(10 * world + chunks)
    a = rng.standard_normal((world * m_loc, k)).astype(np.float32)
    b = rng.standard_normal((k, world * n_loc)).astype(np.float32)
    want, want_ag = _shard(
        lambda a, b: jax_ag_gemm(a, b, axis="tp", gather_output=True,
                                 config=JaxAGConfig(8, 32, 64, chunks_per_shard=chunks)),
        world, (P("tp", None), P(None, "tp")), (P(None, "tp"), P(None, None)),
    )(jnp.asarray(a), jnp.asarray(b))
    ctx = _ring(world)
    cfg = tagg.AGGemmConfig(8, 32, 64, chunks_per_shard=chunks)

    def rank():
        r = ctx.rank
        ta, tb = _t(a[r * m_loc:(r + 1) * m_loc]), _t(b[:, r * n_loc:(r + 1) * n_loc])
        got = tagg.ag_gemm(ta, tb, ctx=ctx, config=cfg, gather_output=True)
        one = tagg._ag_gemm_ring_plain(ta, tb, ctx, False, torch.float32, ((0, m_loc),))
        return got, one

    calls = tagg._ag_gemm_ring_plain.calls
    outs = ctx.run(rank)
    assert tagg._ag_gemm_ring_plain.calls == calls + 2 * world  # the ring, not the gather
    _close(torch.cat([o for (o, _), _ in outs], dim=1), want)
    for (_, ag), one in outs:
        np.testing.assert_array_equal(ag.numpy(), np.asarray(want_ag))
    if chunks == 1:
        for (got, _), one in outs:
            assert torch.equal(got, one)


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_gemm_rs_matches_jax(world, chunks):
    """``gemm_rs(method="ring")`` against JAX's ring kernel with the same
    config (K16 at chunks 1, K17's spans at 2 and 3); ``auto`` on a ring
    context picks the ring; chunks 1 bit-equal to the one-span schedule."""
    m_loc, k_loc, n = 8, 32, 64
    rng = np.random.default_rng(20 * world + chunks)
    a = rng.standard_normal((world * m_loc, world * k_loc)).astype(np.float32)
    b = rng.standard_normal((world * k_loc, n)).astype(np.float32)
    want = _shard(
        lambda a, b: jax_gemm_rs(a, b, axis="tp", method="ring",
                                 config=JaxRSConfig(8, 64, 32, chunks_per_shard=chunks)),
        world, (P(None, "tp"), P("tp", None)), P("tp", None),
    )(jnp.asarray(a), jnp.asarray(b))
    ctx = _ring(world)
    cfg = tgrs.GemmRSConfig(8, 64, 32, chunks_per_shard=chunks)

    def rank():
        r = ctx.rank
        ta = _t(a[:, r * k_loc:(r + 1) * k_loc])
        tb = _t(b[r * k_loc:(r + 1) * k_loc])
        ring = tgrs.gemm_rs(ta, tb, ctx=ctx, method="ring", config=cfg)
        auto = tgrs.gemm_rs(ta, tb, ctx=ctx, config=cfg)
        one = tgrs._gemm_rs_ring_plain(ta, tb, ctx, torch.float32, ((0, m_loc),))
        return ring, auto, one

    outs = ctx.run(rank)
    _close(torch.cat([o[0] for o in outs]), want)
    for ring, auto, one in outs:
        assert torch.equal(ring, auto)
        if chunks == 1:
            assert torch.equal(ring, one)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_reduce_scatter_matches_jax(world):
    """``reduce_scatter(method="ring")`` (and ``auto`` on a ring context)
    against JAX's ring kernel; the chunked ring (two spans) gives the same
    result bit for bit (``tests/test_torch_layers.py`` holds it to JAX's
    chunked kernel)."""
    m_tot, n = 8 * world, 16
    x = np.random.default_rng(30 + world).standard_normal((world, m_tot, n)).astype(np.float32)
    want = _shard(lambda xs: jax_reduce_scatter(xs[0], axis="tp", method="ring",
                                                config=JaxRSCConfig(8, 16)),
                  world, (P("tp", None, None),), P("tp", None))(x)
    ctx = _ring(world)
    outs = ctx.run(lambda: (trs.reduce_scatter(_t(x[ctx.rank]), ctx=ctx, method="ring"),
                            trs.reduce_scatter(_t(x[ctx.rank]), ctx=ctx)))
    _close(torch.cat([o[0] for o in outs]), want)
    for ring, auto in outs:
        assert torch.equal(ring, auto)
    chunked = ctx.run(lambda: trs.reduce_scatter(
        _t(x[ctx.rank]), ctx=ctx, config=trs.ReduceScatterConfig(2, chunks_per_shard=2)))
    for (ring, _), got in zip(outs, chunked):
        assert torch.equal(got, ring)


@pytest.mark.parametrize("op", ["ag_gemm_grad", "gemm_rs_grad"])
def test_ring_grads_match_jax_vjp(op):
    """The differentiable pair on a ring context at world 2, ``ag_config``
    and ``rs_config`` with two spans: forward, dA and dB against
    ``jax.vjp`` of the JAX ops with the same configs; each backward runs
    the other op's config."""
    world, m_loc, k, n = 2, 8, 32, 16
    rng = np.random.default_rng(40 + len(op))
    jag, jrs = JaxAGConfig(8, 64, 64, chunks_per_shard=2), JaxRSConfig(8, 64, 64, chunks_per_shard=2)
    tag_, trs_ = (tagg.AGGemmConfig(8, 64, 64, chunks_per_shard=2),
                  tgrs.GemmRSConfig(8, 64, 64, chunks_per_shard=2))
    if op == "ag_gemm_grad":
        a = rng.standard_normal((world * m_loc, k)).astype(np.float32)
        b = rng.standard_normal((k, world * n)).astype(np.float32)
        dout = rng.standard_normal((world * m_loc, world * n)).astype(np.float32)
        specs = (P("tp", None), P(None, "tp"), P(None, "tp"))
        jfn = lambda a, b: jgrads.ag_gemm_grad(a, b, "tp", jag, jrs)  # noqa: E731
        a_part = lambda r: a[r * m_loc:(r + 1) * m_loc]  # noqa: E731
        b_part = lambda r: b[:, r * n:(r + 1) * n]  # noqa: E731
        d_part = lambda r: dout[:, r * n:(r + 1) * n]  # noqa: E731
        tfn = lambda a, b, ctx: tgrads.ag_gemm_grad(a, b, ctx=ctx, ag_config=tag_,  # noqa: E731
                                                    rs_config=trs_)
        cat = (lambda xs: torch.cat(xs, 1), lambda xs: torch.cat(xs, 0),
               lambda xs: torch.cat(xs, 1))
    else:
        a = rng.standard_normal((world * m_loc, world * k)).astype(np.float32)
        b = rng.standard_normal((world * k, n)).astype(np.float32)
        dout = rng.standard_normal((world * m_loc, n)).astype(np.float32)
        specs = (P(None, "tp"), P("tp", None), P("tp", None))
        jfn = lambda a, b: jgrads.gemm_rs_grad(a, b, "tp", jrs, jag)  # noqa: E731
        a_part = lambda r: a[:, r * k:(r + 1) * k]  # noqa: E731
        b_part = lambda r: b[r * k:(r + 1) * k]  # noqa: E731
        d_part = lambda r: dout[r * m_loc:(r + 1) * m_loc]  # noqa: E731
        tfn = lambda a, b, ctx: tgrads.gemm_rs_grad(a, b, ctx=ctx, rs_config=trs_,  # noqa: E731
                                                    ag_config=tag_)
        cat = (lambda xs: torch.cat(xs, 0), lambda xs: torch.cat(xs, 1),
               lambda xs: torch.cat(xs, 0))

    def jprog(a, b, d):
        out, vjp = jax.vjp(jfn, a, b)
        return (out, *vjp(d))

    want = _shard(jprog, world, specs, (specs[2], specs[0], specs[1]))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(dout))
    ctx = _ring(world)

    def rank():
        r = ctx.rank
        ta, tb = _t(a_part(r)).requires_grad_(), _t(b_part(r)).requires_grad_()
        out = tfn(ta, tb, ctx)
        da, db = torch.autograd.grad(out, (ta, tb), _t(d_part(r)))
        return out.detach(), da, db

    outs = ctx.run(rank, grad=True)
    for i, (join, w) in enumerate(zip(cat, want)):
        _close(join([o[i] for o in outs]), w)


# ---------------------------------------------------- the model on a ring ----

DENSE = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=4, n_kv_heads=2,
             head_dim=8, batch=2, seq=8)
JAX_RING = dict(ag_config=JaxAGConfig(16, 128, 128, chunks_per_shard=2),
                rs_config=JaxRSConfig(16, 128, 128, chunks_per_shard=2))
PORT_RING = dict(ag_config=tagg.AGGemmConfig(16, 128, 128, chunks_per_shard=2),
                 rs_config=tgrs.GemmRSConfig(16, 128, 128, chunks_per_shard=2))
WORLD = 2


@pytest.fixture(scope="module")
def ring_model():
    """The JAX model (ring configs, two spans a hop), its weights on the
    port, a token batch, and one JAX program's forward logits, loss, each
    rank's raw gradients and the parameters after one ``train_step``
    (the raw gradients taken from inside ``train_step``'s own trace)."""
    jcfg = jtm.TransformerConfig(**DENSE, **JAX_RING)
    # the JAX init's tree filled from numpy (no jax.random program to
    # compile): rows over sqrt(fan-in), norms at one
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(lambda key: jtm.init_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) / np.sqrt(x.shape[0]), x.dtype),
        shapes)
    tcfg = ttm.TransformerConfig(**DENSE, **PORT_RING)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    m = DENSE["batch"] * DENSE["seq"]
    tokens = rng.integers(0, DENSE["vocab"], m).astype(np.int32)
    targets = rng.integers(0, DENSE["vocab"], m).astype(np.int32)

    mesh = _mesh(WORLD)
    specs = jtm.specs_for(jcfg)
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                          jparams, specs)
    model = jtm.TPTransformer(jcfg)
    seen = []
    value_and_grad = jax.value_and_grad
    forward = jtm.TPTransformer.__call__

    def spy(f):
        # train_step's own value_and_grad, with the loss's call of the
        # forward recorded and returned as an aux output: the program
        # traces the model once for the logits, the loss and its gradients
        def run(p):
            logits = []

            def record(self, *args):
                logits.append(forward(self, *args))
                return logits[-1]

            def loss_and_logits(q):
                with mock.patch.object(jtm.TPTransformer, "__call__", record):
                    return f(q), logits[-1]

            (loss, out), grads = value_and_grad(loss_and_logits, has_aux=True)(p)
            seen.append((out, loss, grads))
            return loss, grads
        return run

    def fn(t, y, p):
        with mock.patch.object(jtm.jax, "value_and_grad", spy):
            p1, loss1 = jtm.train_step(model, p, t, y, lr=LR, dp_axis=None)
        (logits, loss, g), = seen
        return logits, loss, jax.tree.map(lambda x: x[None], g), p1, loss1

    stacked = jax.tree.map(lambda s: P("tp", *([None] * len(tuple(s)))), specs,
                           is_leaf=lambda s: isinstance(s, P))
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("tp"), P(None), specs),
                                out_specs=(P(None, "tp"), P(), stacked, specs, P()),
                                check_vma=False))(
        jnp.asarray(tokens), jnp.asarray(targets), placed)
    return jcfg, jparams, tcfg, tparams, tokens, targets, jax.tree.map(np.asarray, out)


def test_ring_forward_matches_jax(ring_model):
    """The per-rank forward on a ring context (the spans' ring AG-GEMM and
    GEMM-RS) against the JAX model's vocab-sharded logits."""
    _, _, tcfg, tparams, tokens, _, (want, *_) = ring_model
    ctx = _ring(WORLD)
    shards = ttm.shard_params(tparams, WORLD)
    m_loc = tokens.size // WORLD
    calls = (tagg._ag_gemm_ring_plain.calls, tgrs._gemm_rs_ring_plain.calls)
    outs = ctx.run(lambda: ttm.TPTransformer(tcfg, ctx=ctx)(
        _t(tokens[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]), shards[ctx.rank]))
    # 2 column projections a block and the LM head, 2 row projections, each rank
    assert (tagg._ag_gemm_ring_plain.calls - calls[0],
            tgrs._gemm_rs_ring_plain.calls - calls[1]) == (3 * WORLD, 2 * WORLD)
    _close(torch.cat(outs, dim=1), want)


def test_ring_train_step_matches_jax(ring_model):
    """One ``train_step`` at world 2 on a ring context: the loss (1e-5),
    each rank's raw gradients and the updated parameters (1e-4) against the
    JAX model with the same configs."""
    _, _, tcfg, tparams, tokens, targets, (_, want_loss, want_raw, want_p1, want_loss1) = \
        ring_model
    ctx = _ring(WORLD)
    shards = ttm.shard_params(tparams, WORLD)
    m_loc = tokens.size // WORLD
    y = torch.from_numpy(targets)

    def body():
        r = ctx.rank
        model = ttm.TPTransformer(tcfg, ctx=ctx)
        t = _t(tokens[r * m_loc:(r + 1) * m_loc])
        work = ttm._tree_map(lambda p: p.detach().requires_grad_(), shards[r])
        loss = model.loss(t, y, work)
        flat = iter(torch.autograd.grad(loss, ttm._tree_leaves(work)))
        raw = ttm._tree_map(lambda _: next(flat), work)
        return loss.detach(), raw, ttm.train_step(model, shards[r], t, y, lr=LR, dp_axis=None)

    outs = ctx.run(body, grad=True)
    splits = ttm.specs_for(tcfg)
    for r, (loss, raw, (_, loss1)) in enumerate(outs):
        np.testing.assert_allclose(loss.item(), want_loss, rtol=TOL)
        np.testing.assert_allclose(loss1.item(), want_loss1, rtol=TOL)
        ttm._tree_map(lambda got, want, r=r: np.testing.assert_allclose(
            got.numpy(), want[r], rtol=GRAD_TOL, atol=GRAD_TOL), raw, want_raw)
    new = ttm._tree_map(
        lambda first, dim, *rest: first if dim is None else torch.cat([first, *rest], dim),
        outs[0][2][0], splits, *[o[2][0] for o in outs[1:]])
    ttm._tree_map(lambda got, want: np.testing.assert_allclose(
        got.numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL), new, want_p1)


def test_ring_serve_greedy_tokens_match_jax(ring_model):
    """A tiny greedy serve at world 2 on a ring context (bulk prefill
    through the ring AG-GEMM and GEMM-RS with two spans, paged decode)
    gives the JAX batcher's tokens at world 2 with the same configs; the
    JAX side feeds the prompts token by token (the class every admission
    mode must equal), so it traces only its decode step."""
    jcfg, jparams, tcfg, tparams, *_ = ring_model
    lengths, max_new, s_max = [5, 7, 3], 4, 16
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, DENSE["vocab"], n).tolist() for n in lengths]

    jb = jdec.ContinuousBatcher(jcfg, jparams, _mesh(WORLD), s_max=s_max, page_size=4)
    for i, p in enumerate(prompts):
        jb.submit(jdec.Request(p, max_new_tokens=max_new, uid=f"r{i}"))
    want = dict(jb.run())
    ctx = _ring(WORLD)
    tb = tdec.ContinuousBatcher(tcfg, tparams, s_max=s_max, page_size=4, prefill=True,
                                device="cpu", ctx=ctx)
    for i, p in enumerate(prompts):
        tb.submit(tdec.Request(p, max_new_tokens=max_new, uid=f"r{i}"))
    calls = (tagg._ag_gemm_ring_plain.calls, tgrs._gemm_rs_ring_plain.calls)
    got = dict(tb.run())
    assert tagg._ag_gemm_ring_plain.calls > calls[0]
    assert tgrs._gemm_rs_ring_plain.calls > calls[1]
    assert got == want
    assert sorted(got) == ["r0", "r1", "r2"]
    assert all(len(v) == max_new for v in got.values())

"""Training of the PyTorch port on the 2-D rank runtime against the JAX
package on the CPU.

- **Optimizers** (``triton_dist_tpu_torch.optim``, the twins of the optax
  transforms the reference's ``train_step(opt=)`` takes): Adam (plain and
  Nesterov) and SGD (momentum, Nesterov momentum, none) steps against optax
  0.2.6 on the same gradients, params and state within 1e-6; the state's
  split (``opt_state_specs``) against JAX's.
- **``train_step(opt=adam)``** against JAX's ``train_step(opt=optax.adam(
  1e-2))``, two steps at world 4 with ``dp_axis=None`` and on ``{"dp": 2,
  "tp": 2}``: the f32 loss within 1e-5 relative, every rank's parameters
  and Adam moments within 1e-4 relative L2; with ``skip_nonfinite`` a
  poisoned step returns parameters and state bit for bit.
- **Expert-parallel training**: one flat EP step at world 4 (≙
  ``tests/test_models.py:383``) and one hierarchical step with
  ``ep_outer="dp"`` on ``{"dp": 2, "tp": 2}`` (≙ ``:466``: the dp-sharded
  banks take the exact gradient of the dp-mean loss), each against JAX's
  ``train_step`` at the same tolerances; the router moves; ``ep_quant`` is
  refused with the reference's words.
- **``usp_attention``** on ``{"sp": 2, "tp": 2}``: forward and dq, dk, dv
  against ``jax.vjp`` of JAX's, its ring kernel swapped for the dense
  golden as ``tests/test_torch_sp_model.py`` does (an interpreted world-4
  ring call costs ~8-11 s); the zigzag layout composes.
- **``all_gather_op``** and **``reduce_scatter_op``** against JAX's
  host-level entries at world 4.

The JAX weights are the JAX init's tree filled from numpy, carried over
with ``params_from_numpy``. JAX runs under ``shard_map``; in the training
cells (fixture ``goldens``) every guarded JAX op (``resilience.guarded_call``:
AG-GEMM, GEMM-RS, the grouped GEMMs, the all-to-all) takes its XLA golden,
as it does where its fused kernel cannot run: an interpreted EP train step
costs ~60 s of the JAX interpreter on a CPU against ~2 s for the goldens,
and each fused kernel is held to its interpreted Pallas twin in its own
file (``test_torch_ep.py``, ``test_torch_grads.py``, ...). The host-level
collective cells run the interpreted kernels.
"""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from test_torch_ring_attention import _dense_ring
from triton_dist_tpu import resilience as jresilience
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.ulysses import usp_attention as jax_usp
from triton_dist_tpu_torch import optim as toptim
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.ops import reduce_scatter as trs
from triton_dist_tpu_torch.ops import ring_attention as tra
from triton_dist_tpu_torch.ops import ulysses as tuly
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

jgg = importlib.import_module("triton_dist_tpu.ops.group_gemm")
jra = importlib.import_module("triton_dist_tpu.ops.ring_attention")
jag = importlib.import_module("triton_dist_tpu.ops.allgather")
jrs = importlib.import_module("triton_dist_tpu.ops.reduce_scatter")

LOSS_TOL, TOL = 1e-5, 1e-4
DENSE = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=8, n_kv_heads=4,
             head_dim=8, batch=2, seq=8)
M = DENSE["batch"] * DENSE["seq"]
JAX_TILES = dict(ag_config=AGGemmConfig(8, 128, 128), rs_config=GemmRSConfig(8, 128, 128))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check_tree(got, want, what):
    """Every leaf of the port tree `got` within TOL relative L2 of `want`."""
    ttm._tree_map(lambda a, b: _assert_rel(a, b, what), got, want)


def _assert_rel(a, b, what):
    err = _rel_l2(a.detach().float().numpy(), b.detach().float().numpy())
    assert err <= TOL, (what, err)


def _numpy_params(init, jcfg, seed):
    """The JAX init's tree filled from numpy at its scales (no jax.random
    program compiles)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init(key, jcfg), jax.random.PRNGKey(0))

    def leaf(path, x):
        name = str(path[-1])
        if "norm" in name:
            return jnp.ones(x.shape, x.dtype)
        std = 0.02 if "embed" in name else 1 / np.sqrt(
            jcfg.ffn if "w_down" in name else jcfg.hidden)
        return jnp.asarray(rng.standard_normal(x.shape) * std, x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture
def goldens():
    """Route every guarded JAX op to its XLA golden for one test."""
    with mock.patch.object(jresilience, "guarded_call",
                           lambda family, primary, golden, *a, **k: golden(*a, **k)):
        yield


def _mesh(shape):
    names, sizes = tuple(shape), tuple(shape.values())
    return Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), names)


def _to_port(tree):
    return ttm.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


# ------------------------------------------------------------ optimizers


def _opt_pairs():
    return {
        "adam": (optax.adam(1e-2), toptim.adam(1e-2)),
        "adam_rates": (optax.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6),
                       toptim.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6)),
        "sgd_momentum": (optax.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)),
        "sgd_momentum_half": (optax.sgd(0.1, momentum=0.5), toptim.sgd(0.1, momentum=0.5)),
        "sgd": (optax.sgd(0.05), toptim.sgd(0.05)),
    }


@pytest.mark.parametrize("name", ["adam", "adam_rates", "sgd_momentum", "sgd_momentum_half",
                                  "sgd"])
def test_optimizer_steps_match_optax(name):
    """Three steps on the same gradients (a dict of a matrix and a list of
    vectors, f32): updated parameters and every state leaf within 1e-6."""
    jopt, topt = _opt_pairs()[name]
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(7).astype(np.float32)}]}
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        tp = toptim.apply_updates(tp, tu)
    got, want = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), (tp, ts))), jax.tree.leaves(
        (jp, js))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    if name.startswith("adam"):
        assert ts[0].count.dtype == torch.int32 and int(ts[0].count) == 3


def test_opt_state_specs_match_jax():
    """Subtrees mirroring the parameters take their split, counts are
    replicated, for Adam and momentum SGD over the EP tree (banks split on
    the expert dim)."""
    kw = dict(DENSE, n_experts=4, topk=2)
    jcfg = jtm.EPMoETransformerConfig(**kw)
    tcfg = ttm.EPMoETransformerConfig(**kw)
    params = _numpy_params(jtm.init_moe_params, jcfg, 1)
    tparams = _to_port(params)
    specs, tspecs = jtm.ep_moe_param_specs(jcfg), ttm.specs_for(tcfg, tparams)
    (jadam, tadam), (jsgd, tsgd) = _opt_pairs()["adam"], _opt_pairs()["sgd_momentum"]
    want, got = jtm.opt_state_specs(jadam, params, specs), toptim.opt_state_specs(
        tadam, tparams, tspecs)
    assert want[0].count == P() and got[0].count is None
    assert want[0].mu == specs and want[0].nu == specs
    assert got[0].mu == tspecs and got[0].nu == tspecs
    assert type(got[1]).__name__ == type(want[1]).__name__ == "EmptyState"
    want, got = jtm.opt_state_specs(jsgd, params, specs), toptim.opt_state_specs(
        tsgd, tparams, tspecs)
    assert want[0].trace == specs and got[0].trace == tspecs
    # the port's split names a bank's expert dim where JAX's spec shards it
    assert tspecs["layers"][0]["w_up"] == 0 and specs["layers"][0]["w_up"] == P("tp", None, None)


# ----------------------------------------------------- train_step(opt=adam)


@pytest.fixture(scope="module")
def dense():
    jcfg = jtm.TransformerConfig(**DENSE, **JAX_TILES)
    jparams = _numpy_params(jtm.init_params, jcfg, 21)
    rng = np.random.default_rng(22)
    tokens = rng.integers(0, DENSE["vocab"], 2 * M).astype(np.int32)
    targets = rng.integers(0, DENSE["vocab"], 2 * M).astype(np.int32)
    return jcfg, jparams, ttm.TransformerConfig(**DENSE), _to_port(jparams), tokens, targets


def _jax_adam_steps(jcfg, jparams, tokens, targets, shape, steps=2):
    """JAX's ``train_step(opt=optax.adam(1e-2))`` on a mesh of `shape`."""
    mesh = _mesh(shape)
    dp = "dp" in shape
    specs = jtm.param_specs(jcfg)
    opt = optax.adam(1e-2)
    sspecs = jtm.opt_state_specs(opt, jparams, specs)
    model = jtm.TPTransformer(jcfg)
    step = jax.jit(jax.shard_map(
        lambda t, y, p, s: jtm.train_step(model, p, t, y.reshape(-1), opt=opt, opt_state=s,
                                          dp_axis="dp" if dp else None),
        mesh=mesh, in_specs=(P(("dp", "tp")) if dp else P("tp"), P("dp") if dp else P(None),
                             specs, sspecs),
        out_specs=(specs, sspecs, P()), check_vma=False))
    place = lambda tree, sp: jax.tree.map(  # noqa: E731
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, sp)
    p, s = place(jparams, specs), place(opt.init(jparams), sspecs)
    t = jnp.asarray(tokens if dp else tokens[:M])
    y = jnp.asarray(targets.reshape(2, M) if dp else targets[:M])
    out = []
    for _ in range(steps):
        p, s, loss = step(t, y, p, s)
        out.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), float(loss)))
    return out


def _port_adam_steps(tcfg, tparams, tokens, targets, ctx, steps=2, poison=None, **kw):
    """Each rank's (params, state, loss[, skipped]) after every step."""
    dp = "dp" in ctx.axis_names
    shards = ttm.shard_params(tparams, cfg=tcfg, ctx=ctx)
    m_loc = M // ctx.axis_size("tp")
    states = [toptim.adam(1e-2).init(s) for s in shards]
    history = []
    for _ in range(steps):
        def body():
            r = ctx.rank
            d = ctx.axis_index("dp") if dp else 0
            return ttm.train_step(ttm.TPTransformer(tcfg, ctx=ctx), shards[r],
                                  torch.from_numpy(tokens[r * m_loc:(r + 1) * m_loc]),
                                  torch.from_numpy(targets[d * M:(d + 1) * M]),
                                  dp_axis="dp" if dp else None, opt=toptim.adam(1e-2),
                                  opt_state=states[r], **kw)

        outs = ctx.run(body, grad=True)
        shards, states = [o[0] for o in outs], [o[1] for o in outs]
        history.append(outs)
    return history


@pytest.mark.parametrize("shape", [{"tp": 4}, {"dp": 2, "tp": 2}], ids=["tp4", "dp2xtp2"])
def test_train_step_adam_matches_jax(dense, shape, goldens):
    jcfg, jparams, tcfg, tparams, tokens, targets = dense
    want = _jax_adam_steps(jcfg, jparams, tokens, targets, shape)
    ctx = initialize_distributed(mesh_shape=shape, device="cpu")
    history = _port_adam_steps(tcfg, tparams, tokens, targets, ctx)
    for (jp, js, jloss), outs in zip(want, history):
        p_sh = ttm.shard_params(_to_port(jp), cfg=tcfg, ctx=ctx)
        mu_sh = ttm.shard_params(_to_port(js[0].mu), cfg=tcfg, ctx=ctx)
        nu_sh = ttm.shard_params(_to_port(js[0].nu), cfg=tcfg, ctx=ctx)
        for r, (p, s, loss) in enumerate(outs):
            np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_TOL)
            _check_tree(p, p_sh[r], "params")
            _check_tree(s[0].mu, mu_sh[r], "mu")
            _check_tree(s[0].nu, nu_sh[r], "nu")
            assert int(s[0].count) == int(js[0].count)
    assert want[1][2] < want[0][2]


def test_skip_nonfinite_with_adam_keeps_params_and_state():
    """A poisoned step with ``opt=`` returns every parameter and every
    state leaf bit for bit (world 1), and a clean step under the flag is
    the same step as without it; momentum SGD too."""
    cfg = ttm.TransformerConfig(**dict(DENSE, n_layers=1))
    params = ttm.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.integers(0, DENSE["vocab"], M))
    y = torch.from_numpy(rng.integers(0, DENSE["vocab"], M))
    model = ttm.TPTransformer(cfg)
    for opt in (toptim.adam(1e-2), toptim.sgd(0.1, momentum=0.9)):
        state = opt.init(params)
        p1, s1, _ = ttm.train_step(model, params, t, y, dp_axis=None, opt=opt, opt_state=state)
        q1, r1, _, skipped = ttm.train_step(model, params, t, y, dp_axis=None, opt=opt,
                                            opt_state=state, skip_nonfinite=True)
        assert skipped.item() == 0
        toptim.tree_map(lambda a, b: None if a is None else torch.testing.assert_close(
            a, b, rtol=0, atol=0), (p1, s1), (q1, r1))
        poisoned = dict(p1, embed=p1["embed"].clone())
        poisoned["embed"][int(t[0])] = float("nan")
        p2, s2, loss, skipped = ttm.train_step(model, poisoned, t, y, dp_axis=None, opt=opt,
                                               opt_state=s1, skip_nonfinite=True)
        assert skipped.item() == 1 and not torch.isfinite(loss)
        toptim.tree_map(lambda a, b: None if a is None else torch.testing.assert_close(
            a, b, rtol=0, atol=0, equal_nan=True), (p2, s2), (poisoned, s1))
    with pytest.raises(ValueError, match="opt= and opt_state= together"):
        ttm.train_step(model, params, t, y, dp_axis=None, opt=toptim.adam(1e-2))


# ------------------------------------------------------------ EP training

EP = dict(vocab=64, hidden=32, ffn=64, n_layers=1, n_q_heads=8, n_kv_heads=4, head_dim=8,
          batch=2, seq=16, topk=2)
EP_LR, BM = 0.1, 8
M_EP = EP["batch"] * EP["seq"]


def _ep_setup(n_experts, ep_outer=None):
    kw = dict(EP, n_experts=n_experts, ep_outer=ep_outer)
    jcfg = jtm.EPMoETransformerConfig(**kw, **JAX_TILES,
                                      gg_config=jgg.GroupGemmConfig(BM, 16, 16))
    tcfg = ttm.EPMoETransformerConfig(**kw, gg_config=tgg.GroupGemmConfig(BM))
    jparams = _numpy_params(jtm.init_moe_params, jcfg, 30 + n_experts)
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, EP["vocab"], 2 * M_EP).astype(np.int32)
    targets = rng.integers(0, EP["vocab"], 2 * M_EP).astype(np.int32)
    return jcfg, tcfg, jparams, _to_port(jparams), tokens, targets


@pytest.mark.parametrize("layout", ["flat", "hier"])
def test_ep_train_step_matches_jax(layout, goldens):
    """One SGD step of the EP model: flat at world 4 (4 experts, dp_axis
    None) and hierarchical on ``{"dp": 2, "tp": 2}`` (8 experts over (dp,
    tp), the dp axis the EP outer axis): the loss, every rank's updated
    shard (the banks split over the EP axes) against JAX's; the router
    moves."""
    hier = layout == "hier"
    shape = {"dp": 2, "tp": 2} if hier else {"tp": 4}
    jcfg, tcfg, jparams, tparams, tokens, targets = _ep_setup(8 if hier else 4,
                                                              "dp" if hier else None)
    mesh = _mesh(shape)
    specs = jtm.ep_moe_param_specs(jcfg)
    model = jtm.EPMoETransformer(jcfg)
    step = jax.jit(jax.shard_map(
        lambda t, y, p: jtm.train_step(model, p, t, y.reshape(-1), lr=EP_LR,
                                       dp_axis="dp" if hier else None),
        mesh=mesh, in_specs=(P(("dp", "tp")) if hier else P("tp"),
                             P("dp") if hier else P(None), specs),
        out_specs=(specs, P()), check_vma=False))
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jparams, specs)
    jp, jloss = step(jnp.asarray(tokens if hier else tokens[:M_EP]),
                     jnp.asarray(targets.reshape(2, M_EP) if hier else targets[:M_EP]), placed)
    jp = jax.tree.map(np.asarray, jp)

    ctx = initialize_distributed(mesh_shape=shape, device="cpu")
    shards = ttm.shard_params(tparams, cfg=tcfg, ctx=ctx)
    m_loc = M_EP // ctx.axis_size("tp")

    def body():
        r = ctx.rank
        d = ctx.axis_index("dp") if hier else 0
        return ttm.train_step(ttm.EPMoETransformer(tcfg, ctx=ctx), shards[r],
                              torch.from_numpy(tokens[r * m_loc:(r + 1) * m_loc]),
                              torch.from_numpy(targets[d * M_EP:(d + 1) * M_EP]), lr=EP_LR,
                              dp_axis="dp" if hier else None)

    outs = ctx.run(body, grad=True)
    want = ttm.shard_params(_to_port(jp), cfg=tcfg, ctx=ctx)
    for r, (p, loss) in enumerate(outs):
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
        _check_tree(p, want[r], f"{layout} rank {r}")
        moved = (p["layers"][0]["router"] - shards[r]["layers"][0]["router"]).abs().max()
        assert moved > 0
    if hier:  # the dp replicas of a replicated leaf stay bitwise equal
        for r in range(2):
            assert torch.equal(outs[r][0]["embed"], outs[2 + r][0]["embed"])


def test_ep_quant_training_is_refused_as_in_jax():
    kw = dict(EP, n_experts=4, ep_quant="int8")
    with pytest.raises(ValueError) as want:
        jtm.train_step(jtm.EPMoETransformer(jtm.EPMoETransformerConfig(**kw)), {}, None, None)
    with pytest.raises(ValueError) as got:
        ttm.train_step(ttm.EPMoETransformer(ttm.EPMoETransformerConfig(**kw)), {}, None, None)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------- USP, two axes

B, H, D = 1, 4, 16
USP_SPEC = P(None, None, ("sp", "tp"), None)


@pytest.mark.parametrize("layout", ["contig", "zigzag"])
def test_usp_attention_over_two_axes_matches_jax(layout):
    """Forward and dq, dk, dv on ``{"sp": 2, "tp": 2}``: the head exchange
    over tp (the port's on the host twin of K27), ring attention over sp;
    under zigzag the global sequence is permuted with
    ``zigzag_permutation(2, S)`` first, as the reference composes it."""
    s_tot, world = 32, 4
    rng = np.random.default_rng(50)
    q, k, v, dout = (rng.standard_normal((B, H, s_tot, D)).astype(np.float32)
                     for _ in range(4))
    if layout == "zigzag":
        perm = tra.zigzag_permutation(2, s_tot)[0]
        q, k, v, dout = (x[:, :, perm] for x in (q, k, v, dout))
    mesh = _mesh({"sp": 2, "tp": 2})

    def jax_side(q, k, v, dout):
        out, vjp = jax.vjp(lambda q, k, v: jax_usp(q, k, v, "sp", "tp", True, None, layout),
                           q, k, v)
        return (out, *vjp(dout))

    with mock.patch.object(jra, "ring_attention", _dense_ring):
        want = jax.jit(jax.shard_map(jax_side, mesh=mesh, in_specs=(USP_SPEC,) * 4,
                                     out_specs=(USP_SPEC,) * 4, check_vma=False))(
            q, k, v, dout)
    ctx = initialize_distributed(mesh_shape={"sp": 2, "tp": 2}, device="cpu")
    s_loc = s_tot // world

    def body():
        rows = slice(ctx.rank * s_loc, (ctx.rank + 1) * s_loc)
        leaves = [torch.from_numpy(np.ascontiguousarray(x[:, :, rows])).requires_grad_()
                  for x in (q, k, v)]
        out = tuly.usp_attention(*leaves, ctx=ctx, outer="sp", inner="tp", layout=layout)
        g = torch.autograd.grad(out, leaves, torch.from_numpy(
            np.ascontiguousarray(dout[:, :, rows])))
        return out.detach(), *g

    outs = ctx.run(body, grad=True)
    for i in range(4):
        np.testing.assert_allclose(torch.cat([o[i] for o in outs], 2).numpy(),
                                   np.asarray(want[i]), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="3 heads over an inner axis of 2"):
        x = torch.zeros(B, 3, s_loc, D)
        ctx2 = initialize_distributed(mesh_shape={"sp": 2, "tp": 2}, device="cpu")
        ctx2.run(lambda: tuly.usp_attention(x, x, x, ctx=ctx2, outer="sp", inner="tp"))


# --------------------------------------------------- host-level collectives


@pytest.mark.parametrize("method,chunks", [("full_mesh_push", 1), ("ring_bidir", 2),
                                          ("ring_1d", 1)])
def test_all_gather_op_matches_jax(method, chunks):
    world = 4
    x = np.random.default_rng(60).standard_normal((world * 6, 8)).astype(np.float32)
    want = np.asarray(jag.all_gather_op(jnp.asarray(x), _mesh({"tp": world}), method=method,
                                        chunks_per_shard=chunks))
    ctx = initialize_distributed(world, device="cpu")
    got = tag.all_gather_op(torch.from_numpy(x), ctx=ctx, method=method,
                            chunks_per_shard=chunks)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tag.all_gather_op(torch.from_numpy(x)), torch.from_numpy(x))


@pytest.mark.parametrize("method,chunks", [("scatter_reduce", 1), ("ring", 2)])
def test_reduce_scatter_op_matches_jax(method, chunks):
    world = 4
    rng = np.random.default_rng(61)
    for shape in ((world, 32, 8), (world, 32)):
        x = rng.standard_normal(shape).astype(np.float32)
        jcfg = jrs.ReduceScatterConfig(8, 8, method, chunks_per_shard=chunks)
        want = np.asarray(jrs.reduce_scatter_op(jnp.asarray(x), _mesh({"tp": world}),
                                                method=method, config=jcfg))
        ctx = initialize_distributed(world, device="cpu")
        got = trs.reduce_scatter_op(torch.from_numpy(x), ctx=ctx, method=method,
                                    config=trs.ReduceScatterConfig(8, 8, method,
                                                                   chunks_per_shard=chunks))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="must be the world 4"):
        trs.reduce_scatter_op(torch.zeros(2, 8), ctx=ctx)

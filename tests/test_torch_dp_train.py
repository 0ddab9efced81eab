"""Data-parallel x tensor-parallel training of the PyTorch port on a 2-D
rank runtime (``{"dp": 2, "tp": 2}`` on the CPU) against the JAX package's
``train_step`` on a 2 x 2 mesh (≙ ``test_models.py:118``): two SGD steps
of the dense decoder with ``dp_axis="dp"`` (the default), tokens sharded
over ``(dp, tp)`` and each dp group's targets; then, on the port alone,
the replicas of every parameter stay bit-equal across the dp groups,
``skip_nonfinite`` over tp and dp drops a step poisoned in one dp group
on every rank, and an axis the runtime lacks is named.

The JAX weights are the JAX init's tree filled from numpy, carried over
with ``params_from_numpy``; JAX traces ``train_step`` under ``shard_map``
once (its Pallas AG-GEMM / GEMM-RS interpreted) and runs it twice. f32:
the loss to 1e-5 relative, every updated parameter (replicated and
sharded) to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu_torch import optim as toptim
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

LOSS_TOL, TOL, LR = 1e-5, 1e-4, 0.5
DENSE = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=4, n_kv_heads=2,
             head_dim=8, batch=2, seq=8)
SHAPE = {"dp": 2, "tp": 2}
DP, TP = 2, 2
M = DENSE["batch"] * DENSE["seq"]


def _numpy_params(jcfg, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: jtm.init_params(key, jcfg), jax.random.PRNGKey(0))

    def leaf(path, x):
        name = str(path[-1])
        if "norm" in name:
            return jnp.ones(x.shape, x.dtype)
        std = 0.02 if "embed" in name else 1 / np.sqrt(
            DENSE["ffn"] if "w_down" in name else DENSE["hidden"])
        return jnp.asarray(rng.standard_normal(x.shape) * std, x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def dense():
    jcfg = jtm.TransformerConfig(**DENSE, ag_config=AGGemmConfig(16, 128, 128),
                                 rs_config=GemmRSConfig(16, 128, 128))
    jparams = _numpy_params(jcfg, 21)
    rng = np.random.default_rng(22)
    tokens = rng.integers(0, DENSE["vocab"], DP * M).astype(np.int32)
    targets = rng.integers(0, DENSE["vocab"], DP * M).astype(np.int32)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, ttm.TransformerConfig(**DENSE), tparams, tokens, targets


def _port_steps(tcfg, tparams, tokens, targets, steps, ctx=None, **kw):
    """Each rank's (params, loss) after every step on the 2-D runtime."""
    ctx = ctx or initialize_distributed(mesh_shape=SHAPE, device="cpu")
    shards = ttm.shard_params(tparams, cfg=tcfg, ctx=ctx)
    m_loc = M // TP
    history = []
    for _ in range(steps):
        def body():
            r, d = ctx.rank, ctx.axis_index(ctx.axis_names[0])
            return ttm.train_step(ttm.TPTransformer(tcfg, ctx=ctx), shards[r],
                                  torch.from_numpy(tokens[r * m_loc:(r + 1) * m_loc]),
                                  torch.from_numpy(targets[d * M:(d + 1) * M]), lr=LR, **kw)

        outs = ctx.run(body, grad=True)
        shards = [o[0] for o in outs]
        history.append(outs)
    return ctx, history


def test_dp_tp_train_steps_match_jax(dense):
    """Two ``train_step(dp_axis="dp")`` steps on 2 x 2: the dp-mean loss and
    every rank's updated shard equal JAX's."""
    jcfg, jparams, tcfg, tparams, tokens, targets = dense
    mesh = Mesh(np.array(jax.devices()[:DP * TP]).reshape(DP, TP), ("dp", "tp"))
    specs = jtm.param_specs(jcfg)
    model = jtm.TPTransformer(jcfg)
    step = jax.jit(jax.shard_map(
        lambda t, y, p: jtm.train_step(model, p, t, y.reshape(-1), lr=LR),
        mesh=mesh, in_specs=(P(("dp", "tp")), P("dp"), specs), out_specs=(specs, P()),
        check_vma=False))
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jparams, specs)
    want = []
    y = jnp.asarray(targets.reshape(DP, M))
    for _ in range(2):
        placed, loss = step(jnp.asarray(tokens), y, placed)
        want.append((jax.tree.map(np.asarray, placed), float(loss)))
    ctx, history = _port_steps(tcfg, tparams, tokens, targets, 2)
    for (jp, jloss), outs in zip(want, history):
        shards = ttm.shard_params(ttm.params_from_numpy(jp, "cpu", torch.float32), cfg=tcfg,
                                  ctx=ctx)
        for r, (p, loss) in enumerate(outs):
            np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_TOL)
            ttm._tree_map(lambda a, b: np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=TOL, atol=TOL), p, shards[r])
    assert want[1][1] < want[0][1]


def test_dp_replicas_stay_bit_equal_and_a_poisoned_group_skips_everywhere(dense):
    """Every parameter is bitwise the same on the two dp groups after each
    step; a non-finite embedding row touched only by dp group 1's tokens
    makes every rank of both groups drop the step (``skip_nonfinite`` over
    tp and dp), its parameters returned bit for bit."""
    _, _, tcfg, tparams, tokens, targets = dense
    _, history = _port_steps(tcfg, tparams, tokens, targets, 2)
    for outs in history:
        for r in range(TP):
            ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                          outs[r][0], outs[TP + r][0])
    poisoned = dict(tparams, embed=tparams["embed"].clone())
    only_dp1 = sorted(set(tokens[M:].tolist()) - set(tokens[:M].tolist()))
    poisoned["embed"][only_dp1[0]] = float("inf")
    ctx, history = _port_steps(tcfg, poisoned, tokens, targets, 1, skip_nonfinite=True)
    shards = ttm.shard_params(poisoned, cfg=tcfg, ctx=ctx)
    for r, (new, loss, skipped) in enumerate(history[0]):
        assert skipped.item() == 1
        ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), new,
                      shards[r])


def test_dp_axis_names_and_refusals(dense):
    """``dp_axis`` names any axis of the runtime (``"data"`` here, the same
    step as ``"dp"``); one the runtime lacks raises a ``ValueError`` naming
    it; an optimizer transform runs on the pair: ``opt=sgd(LR)`` is the
    SGD step bit for bit on every rank."""
    _, _, tcfg, tparams, tokens, targets = dense
    _, ref = _port_steps(tcfg, tparams, tokens, targets, 1)
    renamed = initialize_distributed(mesh_shape={"data": 2, "tp": 2}, device="cpu")
    _, got = _port_steps(tcfg, tparams, tokens, targets, 1, ctx=renamed, dp_axis="data")
    for (a, la), (b, lb) in zip(ref[0], got[0]):
        assert la.item() == lb.item()
        ttm._tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)
    ctx = initialize_distributed(mesh_shape=SHAPE, device="cpu")
    with pytest.raises(ValueError, match="dp_axis='pp': the rank runtime has no axis 'pp'"):
        _port_steps(tcfg, tparams, tokens, targets, 1, ctx=ctx, dp_axis="pp")
    m_loc = M // TP
    sgd = toptim.sgd(LR)

    def body():
        r, d = ctx.rank, ctx.axis_index("dp")
        return ttm.train_step(ttm.TPTransformer(tcfg, ctx=ctx), shards[r],
                              torch.from_numpy(tokens[r * m_loc:(r + 1) * m_loc]),
                              torch.from_numpy(targets[d * M:(d + 1) * M]), opt=sgd,
                              opt_state=sgd.init(shards[r]))

    ctx = initialize_distributed(mesh_shape=SHAPE, device="cpu")
    shards = ttm.shard_params(tparams, cfg=tcfg, ctx=ctx)
    for (new, _, loss), (want, want_loss) in zip(ctx.run(body, grad=True), ref[0]):
        assert loss.item() == want_loss.item()
        ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), new, want)

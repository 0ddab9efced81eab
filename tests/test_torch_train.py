"""The PyTorch port's training path against the JAX package on the CPU: the
vocab-parallel ``loss``, its gradients and ``train_step`` (SGD, pure TP,
``dp_axis=None``) of the dense and the MoE decoder at world 1 and 2. The
JAX weights are carried over with ``params_from_numpy``; JAX runs
``jax.value_and_grad`` of ``TPTransformer.loss`` and ``train_step`` under
``shard_map`` (``check_vma=False``) with its Pallas kernels interpreted; the
port's ranks are threads of a CPU ``DistContext`` running ``ctx.run(...,
grad=True)``. The gradients compared are each rank's own (scaled by the
world, replicated leaves unsummed: the accounting ``train_step`` fixes),
so a collective with the wrong transpose shows. One block, hidden 32.
The JAX weights are the JAX init's tree filled from numpy (its shapes from
``jax.eval_shape``: no ``jax.random`` program to compile), made once a
model kind; each (kind, world) traces and compiles one JAX program.

f32 throughout; the packages differ in summation order: the loss to 1e-5
relative, gradients and updated parameters to 1e-4. Then, on the port
alone: three steps lower the loss, ``skip_nonfinite`` drops a poisoned
step bit for bit on every rank, and the refusals.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.group_gemm import GroupGemmConfig as JaxGGConfig
from triton_dist_tpu_torch import models as tmodels
from triton_dist_tpu_torch import optim as toptim
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

LOSS_TOL, TOL, LR = 1e-5, 1e-4, 0.5
DENSE = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=4, n_kv_heads=2,
             head_dim=8, batch=2, seq=8)
MOE = dict(DENSE, n_experts=4, topk=2)
JAX_TILES = dict(ag_config=AGGemmConfig(16, 128, 128), rs_config=GemmRSConfig(16, 128, 128))


def _numpy_params(init, jcfg, seed):
    """The JAX init's tree, filled from numpy at the init's scales: norms
    at one, the embedding at 0.02, every matrix at one over the square root
    of its fan-in (the FFN width for ``w_down``, the hidden width else)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init(key, jcfg), jax.random.PRNGKey(0))

    def leaf(path, x):
        name = str(path[-1])
        if "norm" in name:
            return jnp.ones(x.shape, x.dtype)
        std = 0.02 if "embed" in name else 1 / np.sqrt(
            DENSE["ffn"] if "w_down" in name else DENSE["hidden"])
        return jnp.asarray(rng.standard_normal(x.shape) * std, x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(JAX config, JAX params, port config, port model class), made once
    a kind."""
    if kind == "dense":
        jcfg = jtm.TransformerConfig(**DENSE, **JAX_TILES)
        jparams = _numpy_params(jtm.init_params, jcfg, 3)
        return jcfg, jparams, ttm.TransformerConfig(**DENSE), ttm.TPTransformer
    jcfg = jtm.MoETransformerConfig(**MOE, **JAX_TILES, gg_config=JaxGGConfig(8, 64, 64))
    jparams = _numpy_params(jtm.init_moe_params, jcfg, 4)
    return (jcfg, jparams, ttm.MoETransformerConfig(**MOE, gg_config=GroupGemmConfig(8)),
            ttm.TPMoETransformer)


@pytest.fixture(scope="module", params=["dense", "moe"])
def setup(request):
    kind = request.param
    jcfg, jparams, tcfg, tcls = _models(kind)
    rng = np.random.default_rng(7)
    m = DENSE["batch"] * DENSE["seq"]
    tokens = rng.integers(0, DENSE["vocab"], m).astype(np.int32)
    targets = rng.integers(0, DENSE["vocab"], m).astype(np.int32)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return kind, jcfg, jparams, tcfg, tcls, tparams, tokens, targets


def _jax_step(jcfg, jparams, tokens, targets, world):
    """JAX's loss, each rank's raw gradients (stacked over the ranks) and
    the params after one ``train_step``. The raw gradients are the ones
    ``train_step``'s own ``jax.value_and_grad`` computes, taken from inside
    its trace, so the model is traced and compiled once."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    specs = jtm.specs_for(jcfg)
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                          jparams, specs)
    model = (jtm.TPMoETransformer if isinstance(jcfg, jtm.MoETransformerConfig)
             else jtm.TPTransformer)(jcfg)

    seen = []
    value_and_grad = jax.value_and_grad

    def spy(f):
        def run(p):
            seen.append(value_and_grad(f)(p))
            return seen[-1]
        return run

    def fn(t, y, p):
        with mock.patch.object(jtm.jax, "value_and_grad", spy):
            p1, loss1 = jtm.train_step(model, p, t, y, lr=LR, dp_axis=None)
        (loss, g), = seen
        return loss, jax.tree.map(lambda x: x[None], g), p1, loss1

    stacked = jax.tree.map(lambda s: P("tp", *([None] * len(tuple(s)))), specs,
                           is_leaf=lambda s: isinstance(s, P))
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("tp"), P(None), specs),
                                out_specs=(P(), stacked, specs, P()), check_vma=False))(
        jnp.asarray(tokens), jnp.asarray(targets), placed)
    return jax.tree.map(np.asarray, out)


def _port_step(tcfg, tcls, tparams, tokens, targets, world, **kw):
    """Each rank's (loss, raw gradients, ``train_step`` result) of the
    port."""
    ctx = None if world == 1 else initialize_distributed(world, device="cpu")
    shards = ttm.shard_params(tparams, world)
    m_loc = tokens.size // world
    y = torch.from_numpy(targets)

    def body():
        r = 0 if ctx is None else ctx.rank
        model = tcls(tcfg, ctx=ctx)
        t = torch.from_numpy(tokens[r * m_loc:(r + 1) * m_loc])
        work = ttm._tree_map(lambda p: p.detach().requires_grad_(), shards[r])
        loss = model.loss(t, y, work)
        flat = iter(torch.autograd.grad(loss, ttm._tree_leaves(work)))
        raw = ttm._tree_map(lambda _: next(flat), work)
        return loss.detach(), raw, ttm.train_step(model, shards[r], t, y, lr=LR, dp_axis=None,
                                                  **kw)

    return [body()] if ctx is None else ctx.run(body, grad=True)


def _assemble(shards, splits):
    """The whole parameter tree from the ranks' shards."""
    return ttm._tree_map(
        lambda first, dim, *rest: first if dim is None else torch.cat([first, *rest], dim),
        shards[0], splits, *shards[1:])


def _check(got_tree, want_tree, what, pick=lambda w: w):
    ttm._tree_map(lambda got, want: np.testing.assert_allclose(
        got.detach().numpy(), pick(want), rtol=TOL, atol=TOL, err_msg=what), got_tree, want_tree)


@pytest.mark.parametrize("world", [1, 2])
def test_train_step_matches_jax(setup, world):
    kind, jcfg, jparams, tcfg, tcls, tparams, tokens, targets = setup
    want_loss, want_raw, want_p1, want_loss1 = _jax_step(jcfg, jparams, tokens, targets, world)
    outs = _port_step(tcfg, tcls, tparams, tokens, targets, world)
    for r, (loss, raw, (p1, loss1)) in enumerate(outs):
        np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_TOL)
        np.testing.assert_allclose(loss1.item(), want_loss1, rtol=LOSS_TOL)
        _check(raw, want_raw, f"{kind} world {world} rank {r} gradients",
               pick=lambda w, r=r: w[r])
    new = _assemble([o[2][0] for o in outs], ttm.specs_for(tcfg))
    _check(new, want_p1, f"{kind} world {world} updated params")
    if world == 2:  # a replicated leaf gets the same update on every rank
        assert torch.equal(outs[0][2][0]["embed"], outs[1][2][0]["embed"])


def test_three_steps_lower_the_loss(setup):
    """Three SGD steps at world 2 on one batch: the loss falls each step,
    and the MoE router moves (it trains through the routing weights)."""
    kind, _, _, tcfg, tcls, tparams, tokens, targets = setup
    ctx = initialize_distributed(2, device="cpu")
    shards = ttm.shard_params(tparams, 2)
    y = torch.from_numpy(targets)

    def body():
        r = ctx.rank
        model, p = tcls(tcfg, ctx=ctx), shards[r]
        t = torch.from_numpy(tokens[r * 8:(r + 1) * 8])
        losses = []
        for _ in range(3):
            p, loss = ttm.train_step(model, p, t, y, lr=LR, dp_axis=None)
            losses.append(loss.item())
        return losses, p

    (losses, p3), _ = ctx.run(body, grad=True)
    assert losses[0] > losses[1] > losses[2], losses
    if kind == "moe":
        assert not torch.equal(p3["layers"][0]["router"], tparams["layers"][0]["router"])


def test_skip_nonfinite_drops_a_poisoned_step():
    """An infinite embedding row on rank 0's tokens makes the loss NaN on
    every rank: with ``skip_nonfinite`` every rank drops the step and hands
    its parameters back bit for bit; a clean step under the flag is the
    ungated step, bit for bit."""
    _, jparams, tcfg, tcls = _models("moe")
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    tokens = np.arange(16, dtype=np.int32)
    poisoned = dict(tparams, embed=tparams["embed"].clone())
    poisoned["embed"][int(tokens[0])] = float("inf")
    ctx = initialize_distributed(2, device="cpu")
    y = torch.from_numpy(tokens[::-1].copy())

    def body(params, skip):
        r = ctx.rank
        shard = ttm.shard_params(params, 2)[r]
        return shard, ttm.train_step(tcls(tcfg, ctx=ctx), shard,
                                     torch.from_numpy(tokens[r * 8:(r + 1) * 8]), y, lr=LR,
                                     dp_axis=None, skip_nonfinite=skip)

    for shard, (new, loss, skipped) in ctx.run(lambda: body(poisoned, True), grad=True):
        assert skipped.item() == 1 and not torch.isfinite(loss)
        ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), new, shard)
    gated = ctx.run(lambda: body(tparams, True), grad=True)
    plain = ctx.run(lambda: body(tparams, False), grad=True)
    for (_, (new, loss, skipped)), (_, (want, want_loss)) in zip(gated, plain):
        assert skipped.item() == 0 and loss.item() == want_loss.item()
        ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), new, want)


def test_training_refusals(setup):
    """What the port refuses loudly: a data-parallel axis the runtime does
    not have (``dp_axis`` defaults to ``"dp"``, as the reference's), an
    optimizer without its state, a train step in an inference-mode run,
    and the card by default when there is none. Optimizer transforms run:
    ``opt=sgd(lr)`` is the SGD step bit for bit."""
    _, _, _, tcfg, tcls, tparams, tokens, targets = setup
    t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    model = tcls(tcfg)
    with pytest.raises(ValueError, match="dp_axis='dp': the rank runtime has no axis 'dp'"):
        ttm.train_step(model, tparams, t, y)
    with pytest.raises(ValueError, match="opt= and opt_state= together"):
        ttm.train_step(model, tparams, t, y, opt=toptim.sgd(0.1), dp_axis=None)
    sgd = toptim.sgd(0.1)
    new, state, loss = ttm.train_step(model, tparams, t, y, opt=sgd,
                                      opt_state=sgd.init(tparams), dp_axis=None)
    want, want_loss = ttm.train_step(model, tparams, t, y, lr=0.1, dp_axis=None)
    assert loss.item() == want_loss.item() and len(state) == 2
    ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), new, want)
    ctx = initialize_distributed(2, device="cpu")
    with pytest.raises(ValueError, match="no axis 'dp'"):
        ctx.run(lambda: tmodels.train_step(tcls(tcfg, ctx=ctx), tparams, t, y), grad=True)
    ctx = initialize_distributed(2, device="cpu")
    with pytest.raises(RuntimeError, match="grad=True"):
        ctx.run(lambda: tmodels.train_step(tcls(tcfg, ctx=ctx), tparams, t, y, dp_axis=None))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodels.init_params(tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            initialize_distributed(2)

"""Training with ragged expert rows (``GroupGemmConfig(ragged=True)``) in the
PyTorch port, against the JAX package on the CPU: the ragged weight
gradient ``group_gemm_dw(valid_rows=)`` (K34's plain twin) against the
interpreted Pallas site ``_group_gemm_dw_fused(ragged=True)`` called
directly (two 4-row panels a block); ``group_gemm_grad`` and
``tp_moe_mlp_grad`` with a ragged config against ``jax.vjp`` of their JAX
twins (the MLP at world 1, 2 and 4); ``train_step`` of the ragged MoE
decoder at world 1 and 2 (loss, each rank's raw gradients, the updated
parameters); and the refusals that are gone and those that remain.

Inputs come from numpy with a seed (hidden 32, ffn 64, 4 experts, top-2,
8-row blocks, one layer). JAX runs under ``shard_map`` (``check_vma=False``)
with its Pallas kernels interpreted; the port's ranks are threads of a CPU
``DistContext``. f32 throughout: the op outputs and gradients to 1e-5; the
MLP (two chained products with a GELU between) and the model's gradients
and parameters to 1e-4, its loss to 1e-5 relative. Dead rows of dA must be
exact zeros, and junk in the dead rows must change nothing.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_train import (JAX_TILES, LOSS_TOL, LR, MOE, _assemble, _check, _jax_step,
                              _numpy_params, _port_step)
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops import grads as jgrads
from triton_dist_tpu_torch import optim as toptim
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import grads as tgrads
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.ops import moe_utils as tmu
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

# the JAX package's ops/__init__ re-exports a function under this module's name
jgg = importlib.import_module("triton_dist_tpu.ops.group_gemm")

OP_TOL, MLP_TOL = 1e-5, 1e-4
E, TOPK, BM, HID, FFN = 4, 2, 8, 32, 64
# 13 assignments: expert 1 fills one block and a 1-row tail, expert 2 has none
CASE_IDS = np.asarray([0, 1, 3, 1, 0, 1, 1, 3, 1, 1, 1, 1, 1], np.int32)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _routing(rng, tokens):
    """Distinct top-k experts per token, and f32 weights summing to 1."""
    ids = np.argsort(rng.random((tokens, E)), axis=1)[:, :TOPK].astype(np.int32)
    w = rng.random((tokens, TOPK)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def aligned():
    """The ragged alignment of CASE_IDS, its live-row mask, and A and G
    with finite junk in the dead rows."""
    al = tmu.moe_align_block_size(_t(CASE_IDS), E, BM, ragged=True)
    t_pad = al.sorted_token_ids.shape[0]
    live = (np.arange(t_pad) % BM) < np.repeat(al.valid_rows.numpy(), BM)
    assert live.sum() == CASE_IDS.size
    rng = np.random.default_rng(11)
    a = rng.standard_normal((t_pad, HID)).astype(np.float32)
    g = rng.standard_normal((t_pad, FFN)).astype(np.float32)
    return al, live, a, g


def test_ragged_group_gemm_dw_matches_pallas(aligned, monkeypatch):
    """K34's plain twin against the interpreted ragged Pallas dW (4-row
    panels, so a block's second panel is skipped or masked); junk in the
    dead rows of A and of G (NaN included) changes nothing; an expert
    whose blocks are all dead is exactly zero."""
    monkeypatch.setattr(jgg, "_PANEL_ROWS", 4)
    al, live, a, g = aligned
    ids, valid = jnp.asarray(al.expert_ids.numpy()), jnp.asarray(al.valid_rows.numpy())
    want = jgg._group_gemm_dw_fused(
        jnp.asarray(a), jnp.asarray(g), ids, E, valid_rows=valid, ragged=True, bm=BM,
        cfg=jgg.GroupGemmConfig(BM, FFN, HID, ragged=True), interpret=None)
    cfg = tgg.GroupGemmConfig(BM, ragged=True)
    got = tgg.group_gemm_dw(_t(a), _t(g), al.expert_ids, E, valid_rows=al.valid_rows,
                            config=cfg, assume_sorted=True)
    _close(got, want, OP_TOL)
    assert torch.all(got[2] == 0)
    m = torch.from_numpy(live)[:, None]
    nan_a, nan_g = (torch.where(m, _t(x), float("nan")) for x in (a, g))
    assert torch.equal(tgg.group_gemm_dw(nan_a, nan_g, al.expert_ids, E,
                                         valid_rows=al.valid_rows, config=cfg), got)
    # the padded op on the zeroed rows is the same sum
    zeroed = [torch.where(m, _t(x), 0.0) for x in (a, g)]
    padded = tgg.group_gemm_dw(*zeroed, al.expert_ids, E, config=tgg.GroupGemmConfig(BM))
    np.testing.assert_allclose(got.numpy(), padded.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="valid_rows map"):
        tgg.group_gemm_dw(_t(a), _t(g), al.expert_ids, E, config=cfg)


@pytest.mark.parametrize("w8", [False, True], ids=["float", "w8"])
def test_ragged_group_gemm_grad_matches_jax(aligned, w8):
    """Forward (K29's twin), dA through the transposed bank (its dead rows
    exact zeros) and dB through the ragged dW, against ``jax.vjp`` of
    ``group_gemm_grad`` with the same map; under ``w8`` the forward runs on
    the quantized bank and the backward straight through the float one, as
    ``_gg_bwd`` strips the format."""
    al, live, a, _ = aligned
    rng = np.random.default_rng(12)
    b = (rng.standard_normal((E, HID, FFN)) / 4).astype(np.float32)
    dout = rng.standard_normal((a.shape[0], FFN)).astype(np.float32)
    ids, valid = jnp.asarray(al.expert_ids.numpy()), jnp.asarray(al.valid_rows.numpy())
    jcfg = jgg.GroupGemmConfig(BM, FFN, HID, ragged=True, w8=w8)
    out, vjp = jax.vjp(lambda a, b: jgrads.group_gemm_grad(a, b, ids, valid, jcfg, None, None,
                                                           True), jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(dout))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = tgrads.group_gemm_grad(ta, tb, al.expert_ids, valid_rows=al.valid_rows,
                                 config=tgg.GroupGemmConfig(BM, ragged=True, w8=w8),
                                 assume_sorted=True)
    got_da, got_db = torch.autograd.grad(got, (ta, tb), _t(dout))
    _close(got, out, OP_TOL)
    _close(got_da, want_da, OP_TOL)
    _close(got_db, want_db, OP_TOL)
    assert not got_da[torch.from_numpy(~live)].any()
    with pytest.raises(ValueError, match="valid_rows"):
        tgrads.group_gemm_grad(ta, tb, al.expert_ids, config=tgg.GroupGemmConfig(BM, ragged=True))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ragged_tp_moe_mlp_grad_matches_jax(world):
    """dx, dw_up, dw_down and d topk_weights of the ragged MoE MLP (world 1:
    the sequential composition; world > 1: the overlapped pair) against
    ``jax.vjp`` of ``tp_moe_mlp_grad`` with a ragged config, and equal to
    the port's padded MLP's gradients."""
    rng = np.random.default_rng(70 + world)
    m_loc = 8
    m_tot = world * m_loc
    x = rng.standard_normal((m_tot, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, FFN)) / 4).astype(np.float32)
    w_down = (rng.standard_normal((E, FFN, HID)) / 6).astype(np.float32)
    ids, tw = _routing(rng, m_tot)
    dout = rng.standard_normal((m_tot, HID)).astype(np.float32)
    jcfg = jgg.GroupGemmConfig(BM, FFN, FFN, ragged=True)
    specs = (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None),
             P("tp", None))

    def jax_side(x, wu, wd, ids, tw, dout):
        out, vjp = jax.vjp(lambda x, wu, wd, tw: jgrads.tp_moe_mlp_grad(
            x, wu, wd, ids, tw, "tp", jax.nn.gelu, jcfg, None, True), x, wu, wd, tw)
        return (out, *vjp(dout))

    want = _shard(jax_side, world, (*specs, P("tp", None)),
                  (P("tp", None), *[specs[i] for i in (0, 1, 2, 4)]))(
        x, w_up, w_down, ids, tw, dout)
    f_loc = FFN // world

    def run(ragged):
        cfg = tgg.GroupGemmConfig(BM, ragged=ragged)

        def body(ctx, r):
            rows = slice(r * m_loc, (r + 1) * m_loc)
            leaves = [_t(x[rows]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]),
                      _t(w_down[:, r * f_loc:(r + 1) * f_loc]), _t(tw[rows])]
            for leaf in leaves:
                leaf.requires_grad_()
            out = tgrads.tp_moe_mlp_grad(leaves[0], leaves[1], leaves[2], _t(ids[rows]),
                                         leaves[3], ctx=ctx, gg_config=cfg)
            return out, *torch.autograd.grad(out, leaves, _t(dout[rows]))

        if world == 1:
            return [body(None, 0)]
        ctx = initialize_distributed(world, device="cpu")
        return ctx.run(lambda: body(ctx, ctx.rank), grad=True)

    outs, padded = run(True), run(False)
    for i, dim in enumerate((0, 0, 2, 1, 0)):
        got = torch.cat([o[i] for o in outs], dim)
        _close(got, want[i], MLP_TOL)
        _close(got, torch.cat([o[i] for o in padded], dim).detach(), 1e-6)


@pytest.fixture(scope="module")
def ragged_moe():
    """The one-block MoE model of ``test_torch_train`` under a ragged
    config: JAX config and weights, the port's config and weights."""
    gg = dict(gg_config=jgg.GroupGemmConfig(8, 64, 64, ragged=True))
    jcfg = jtm.MoETransformerConfig(**MOE, **JAX_TILES, **gg)
    jparams = _numpy_params(jtm.init_moe_params, jcfg, 4)
    tcfg = ttm.MoETransformerConfig(**MOE, gg_config=tgg.GroupGemmConfig(8, ragged=True))
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    rng = np.random.default_rng(7)
    m = MOE["batch"] * MOE["seq"]
    tokens = rng.integers(0, MOE["vocab"], m).astype(np.int32)
    targets = rng.integers(0, MOE["vocab"], m).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, tokens, targets


@pytest.mark.parametrize("world", [1, 2])
def test_ragged_train_step_matches_jax(ragged_moe, world):
    """The loss, each rank's raw gradients and the updated parameters of a
    ragged ``train_step`` against JAX's (its ragged Pallas kernels
    interpreted), and bit-equal to the padded step's parameters."""
    jcfg, jparams, tcfg, tparams, tokens, targets = ragged_moe
    want_loss, want_raw, want_p1, want_loss1 = _jax_step(jcfg, jparams, tokens, targets, world)
    outs = _port_step(tcfg, ttm.TPMoETransformer, tparams, tokens, targets, world)
    for r, (loss, raw, (p1, loss1)) in enumerate(outs):
        np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_TOL)
        np.testing.assert_allclose(loss1.item(), want_loss1, rtol=LOSS_TOL)
        _check(raw, want_raw, f"ragged world {world} rank {r} gradients",
               pick=lambda w, r=r: w[r])
    new = _assemble([o[2][0] for o in outs], ttm.specs_for(tcfg))
    _check(new, want_p1, f"ragged world {world} updated params")
    padded_cfg = dataclasses.replace(tcfg, gg_config=tgg.GroupGemmConfig(8))
    padded = _port_step(padded_cfg, ttm.TPMoETransformer, tparams, tokens, targets, world)
    for (_, _, (p1, _)), (_, _, (q1, _)) in zip(outs, padded):
        ttm._tree_map(lambda a, b: np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                                              atol=1e-6), p1, q1)


def test_ragged_training_refusals(ragged_moe):
    """The ragged backward's refusal (once ROADMAP B16) is gone at every
    entry: a ragged ``train_step`` runs; what remains refuses — a
    data-parallel axis the runtime lacks. Optimizers (``opt=sgd(LR)``, the
    SGD step bit for bit) and expert-parallel training run ragged too: one
    ragged EP step at world 1 lowers nothing to NaN and moves the router."""
    _, _, tcfg, tparams, tokens, targets = ragged_moe
    t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    model = ttm.TPMoETransformer(tcfg)
    new, loss = ttm.train_step(model, tparams, t, y, lr=LR, dp_axis=None)
    assert torch.isfinite(loss) and not torch.equal(new["layers"][0]["w_up"],
                                                    tparams["layers"][0]["w_up"])
    with pytest.raises(ValueError, match="no axis 'dp'"):
        ttm.train_step(model, tparams, t, y, dp_axis="dp")
    sgd = toptim.sgd(LR)
    got, _, got_loss = ttm.train_step(model, tparams, t, y, opt=sgd, opt_state=sgd.init(tparams),
                                      dp_axis=None)
    assert got_loss.item() == loss.item()
    ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, new)
    ep_cfg = ttm.EPMoETransformerConfig(**MOE, gg_config=tgg.GroupGemmConfig(8, ragged=True))
    ep_new, ep_loss = ttm.train_step(ttm.EPMoETransformer(ep_cfg), tparams, t, y, lr=LR,
                                     dp_axis=None)
    assert torch.isfinite(ep_loss)
    assert not torch.equal(ep_new["layers"][0]["router"], tparams["layers"][0]["router"])

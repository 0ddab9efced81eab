"""The PyTorch port's sequence-parallel decoder (``models/sp_transformer.py``)
against the JAX package's on the CPU: ``SPTransformer`` logits of every
rank's sequence shard and two ``sp_train_step`` steps (the ranks' mean
loss, the updated replicated parameters) at world 4, contiguous and
zigzag, and at world 1.

The JAX model runs under ``shard_map`` (``check_vma=False``) with the JAX
package's ``ring_attention_grad``, whose forward kernel is swapped for the
dense golden of the rank's rows (``tests/test_torch_ring_attention.py``
holds the port's ring attention to the interpreted Pallas kernel); its
custom backward runs as it is. Weights come from the JAX init's tree,
filled from numpy with a seed, through ``params_from_numpy``: one layer,
hidden 64, 4 query heads and 2 kv heads of 128, 32 tokens a sequence. f32
throughout: logits and parameters to 1e-4, the loss to 1e-5 relative.
"""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_ring_attention import _dense_ring
from triton_dist_tpu.models import sp_transformer as jsp
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu_torch import models as tmodels
from triton_dist_tpu_torch.models import sp_transformer as tsp
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import ring_attention as tra
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

jra = importlib.import_module("triton_dist_tpu.ops.ring_attention")

TOL, LOSS_TOL, LR = 1e-4, 1e-5, 0.5
DIMS = dict(vocab=64, hidden=64, ffn=128, n_layers=1, n_q_heads=4, n_kv_heads=2, head_dim=128,
            batch=1, seq=32)


@pytest.fixture(scope="module")
def model():
    """The JAX weights (the init's tree filled from numpy: norms at one,
    the embedding at 0.02, matrices at one over the square root of their
    fan-in), the port's copy, and a batch."""
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda key: jtm.init_params(key, jtm.TransformerConfig(**DIMS)),
                            jax.random.PRNGKey(0))

    def leaf(path, x):
        name = str(path[-1])
        if "norm" in name:
            return jnp.ones(x.shape, x.dtype)
        std = 0.02 if "embed" in name else 1 / np.sqrt(DIMS["ffn"] if "w_down" in name
                                                       else DIMS["hidden"])
        return jnp.asarray(rng.standard_normal(x.shape) * std, x.dtype)

    jparams = jax.tree_util.tree_map_with_path(leaf, shapes)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    tokens = rng.integers(0, DIMS["vocab"], (DIMS["batch"], DIMS["seq"])).astype(np.int32)
    targets = rng.integers(0, DIMS["vocab"], (DIMS["batch"], DIMS["seq"])).astype(np.int32)
    return jparams, tparams, tokens, targets


def _jax_run(jparams, tokens, targets, world, zigzag):
    """JAX's logits of each rank's shard, then two ``sp_train_step`` steps:
    the losses and the parameters after them."""
    cfg = jsp.SPTransformerConfig(**DIMS, zigzag=zigzag)
    model = jsp.SPTransformer(cfg)

    def fn(t, y, p):
        logits = model(t, p)
        p1, loss1 = jsp.sp_train_step(model, p, t, y, lr=LR)
        p2, loss2 = jsp.sp_train_step(model, p1, t, y, lr=LR)
        return logits, loss1, loss2, p2

    specs = jax.tree.map(lambda _: P(), jparams)
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    with mock.patch.object(jra, "ring_attention", _dense_ring):
        out = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(P(None, "tp"), P(None, "tp"), specs),
            out_specs=(P(None, "tp", None), P(), P(), specs), check_vma=False))(
            jnp.asarray(tokens), jnp.asarray(targets), jparams)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("world,zigzag", [(4, False), (4, True), (1, False)],
                         ids=["world4-contig", "world4-zigzag", "world1"])
def test_sp_model_matches_jax(model, world, zigzag):
    """Logits of every rank's rows, the two steps' losses and the
    parameters after them; every rank ends with the same parameters."""
    jparams, tparams, tokens, targets = model
    if zigzag:
        perm, _ = tra.zigzag_permutation(world, DIMS["seq"])
        tokens, targets = tokens[:, perm], targets[:, perm]
    want_logits, want_l1, want_l2, want_p2 = _jax_run(jparams, tokens, targets, world, zigzag)
    cfg = tmodels.SPTransformerConfig(**DIMS, zigzag=zigzag)
    s_loc = DIMS["seq"] // world

    def body(ctx, r):
        m = tmodels.SPTransformer(cfg, ctx=ctx)
        t = torch.from_numpy(tokens[:, r * s_loc:(r + 1) * s_loc])
        y = torch.from_numpy(targets[:, r * s_loc:(r + 1) * s_loc])
        with torch.no_grad():
            logits = m(t, tparams)
        p1, l1 = tmodels.sp_train_step(m, tparams, t, y, lr=LR)
        p2, l2 = tsp.sp_train_step(m, p1, t, y, lr=LR)
        return logits, l1.item(), l2.item(), p2

    if world == 1:
        outs = [body(None, 0)]
    else:
        ctx = initialize_distributed(world, device="cpu")
        outs = ctx.run(lambda: body(ctx, ctx.rank), grad=True)
    np.testing.assert_allclose(torch.cat([o[0] for o in outs], 1).numpy(), want_logits,
                               rtol=TOL, atol=TOL)
    for _, l1, l2, p2 in outs:
        np.testing.assert_allclose([l1, l2], [want_l1, want_l2], rtol=LOSS_TOL)
        assert l2 < l1
        ttm._tree_map(lambda got, want: np.testing.assert_allclose(
            got.numpy(), want, rtol=TOL, atol=TOL), p2, want_p2)
    assert all(torch.equal(outs[0][3]["lm_head"], o[3]["lm_head"]) for o in outs)


def test_sp_train_step_needs_gradients(model):
    """Like ``train_step``, a step refuses an inference-mode run."""
    _, tparams, tokens, targets = model
    cfg = tsp.SPTransformerConfig(**DIMS)
    assert cfg.layout == "contig" and tsp.SPTransformerConfig(zigzag=True).layout == "zigzag"
    with torch.inference_mode(), pytest.raises(RuntimeError, match="grad=True"):
        tsp.sp_train_step(tsp.SPTransformer(cfg), tparams, torch.from_numpy(tokens),
                          torch.from_numpy(targets))

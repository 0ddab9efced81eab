"""Sequence-parallel attention in the PyTorch port against the JAX package on
the CPU: ``ring_attention`` (K35's plain twin: out and the per-row lse) at
world 1, 2 and 4, contiguous and zigzag, causal or not, against the dense
golden (the ``_ref_attn`` algebra in ``jnp``); in three cells also against
the interpreted Pallas ring kernel (``ring_attention`` under ``shard_map``
and ``ring_attention_op``); ``zigzag_permutation`` / ``zigzag_positions``
and the layout errors; ``ring_attention_grad`` against ``jax.vjp`` of the
JAX package's (its forward kernel swapped for the dense golden, so the JAX
backward ``_ring_attn_bwd`` runs as it is) at world 4; ``ulysses_attention``
forward and gradients at world 1 and 4 against JAX's (its all-to-all
kernel interpreted); ``usp_attention`` with an inner axis of one rank and
its refusal of a wider one.

Inputs come from numpy with a seed: b 1, 2-4 heads, head_dim 128 (the JAX
ring kernel's lane width), S <= 64. f32 throughout; the online softmax
sums in another order than the dense golden: 1e-5 (out, lse), 1e-4 for
gradients.
"""

import importlib
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.ops import grads as jgrads
from triton_dist_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from triton_dist_tpu_torch import ops as tops
from triton_dist_tpu_torch.ops import grads as tgrads
from triton_dist_tpu_torch.ops import ring_attention as tra
from triton_dist_tpu_torch.ops import ulysses as tuly
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

# the JAX package's ops/__init__ re-exports a function under this module's name
jra = importlib.import_module("triton_dist_tpu.ops.ring_attention")

TOL, GRAD_TOL = 1e-5, 1e-4
B, H, D = 1, 2, 128
SPEC = P(None, None, "tp", None)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, n_in, n_out):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=(SPEC,) * n_in,
                                 out_specs=(SPEC,) * n_out if n_out > 1 else SPEC,
                                 check_vma=False))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _inputs(seed, s_tot, heads=H, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, heads, s_tot, D)).astype(np.float32) for _ in range(n)]


def _ref_attn(q, k, v, causal):
    """The dense golden over the whole sequence (``tests/test_ring_attention.py``'s
    algebra), with its per-row log-sum-exp."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(jnp.float32(q.shape[-1]))
    if causal:
        mask = jnp.tril(jnp.ones((q.shape[2],) * 2, bool))
        s = jnp.where(mask[None, None], s, -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v), jax.nn.logsumexp(s, -1)


def _dense_ring(q, k, v, *, axis="tp", causal=True, config=None, layout="contig",
                return_lse=False, interpret=None):
    """The dense golden of one rank's rows inside ``shard_map``, with the
    JAX ring kernel's signature: the gathered k/v and both layouts' global
    positions."""
    del config, interpret
    n, me = jax.lax.axis_size(axis), jax.lax.axis_index(axis)
    s_loc = q.shape[2]

    def pos(r):
        if layout == "zigzag":
            return jra.zigzag_positions(r, n, s_loc)
        return r * s_loc + jnp.arange(s_loc)

    kf = jax.lax.all_gather(k, axis, axis=2, tiled=True)
    vf = jax.lax.all_gather(v, axis, axis=2, tiled=True)
    cols = jnp.concatenate([pos(c) for c in range(n)])
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kf) / math.sqrt(q.shape[-1])
    if causal:
        s = jnp.where((cols[None, :] <= pos(me)[:, None])[None, None], s, -jnp.inf)
    out = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), vf)
    return (out, jax.nn.logsumexp(s, -1)) if return_lse else out


def _port(world, fn):
    """`fn(ctx, rank)` on every rank of a CPU world (``ctx`` None at world
    1), with gradients on."""
    if world == 1:
        return [fn(None, 0)]
    ctx = initialize_distributed(world, device="cpu")
    return ctx.run(lambda: fn(ctx, ctx.rank), grad=True)


def _port_ring(world, q, k, v, causal, layout):
    """The port's out and lse over the whole sequence, from shards of the
    (permuted) inputs."""
    s_loc = q.shape[2] // world

    def fn(ctx, r):
        part = [_t(x[:, :, r * s_loc:(r + 1) * s_loc]) for x in (q, k, v)]
        return tra.ring_attention(*part, ctx=ctx, causal=causal, layout=layout,
                                  return_lse=True)

    outs = _port(world, fn)
    return torch.cat([o[0] for o in outs], 2), torch.cat([o[1] for o in outs], 2)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", ["contig", "zigzag"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_ring_attention_matches_dense_golden(world, layout, causal):
    """Out and lse of every rank's rows against the dense golden in natural
    order (zigzag: the shards are of the permuted sequence)."""
    s_tot = 16 * world
    q, k, v = _inputs(world + 10 * (layout == "zigzag"), s_tot, n=3)
    want, want_lse = _ref_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    perm, inv = (tra.zigzag_permutation(world, s_tot) if layout == "zigzag"
                 else (np.arange(s_tot), np.arange(s_tot)))
    out, lse = _port_ring(world, *(x[:, :, perm] for x in (q, k, v)), causal, layout)
    _close(out[:, :, inv], want)
    _close(lse[:, :, inv], want_lse)


@pytest.mark.parametrize("case", ["world4-zigzag-causal-lse", "world4-contig-full",
                                  "world1-contig-causal"])
def test_ring_attention_matches_pallas(case):
    """The port's shards against the interpreted Pallas ring kernel on the
    same shards (the lse through ``ring_attention(return_lse=True)`` under
    ``shard_map``, the rest through ``ring_attention_op``)."""
    world = int(case[5])
    layout, causal = case.split("-")[1], "causal" in case
    q, k, v = _inputs(20 + world, 16 * world, n=3)
    if case.endswith("lse"):
        want = jax.jit(jax.shard_map(
            lambda q, k, v: jra.ring_attention(q, k, v, axis="tp", causal=causal, layout=layout,
                                               return_lse=True),
            mesh=_mesh(world), in_specs=(SPEC,) * 3, out_specs=(SPEC, P(None, None, "tp")),
            check_vma=False))(q, k, v)
    else:
        want = (jra.ring_attention_op(q, k, v, _mesh(world), causal=causal, layout=layout),)
    got = _port_ring(world, q, k, v, causal, layout)
    for g, w in zip(got, want):
        _close(g, w)


def test_zigzag_helpers_and_errors_match_jax():
    """The permutation and its inverse, the positions of every rank, and
    the reference's layout errors word for word."""
    for n, s_tot in ((1, 8), (2, 16), (4, 32), (4, 64)):
        perm, inv = tra.zigzag_permutation(n, s_tot)
        jperm, jinv = jra.zigzag_permutation(n, s_tot)
        assert perm.dtype == np.int32 and np.array_equal(perm, jperm)
        assert np.array_equal(inv, jinv)
        for me in range(n):
            assert np.array_equal(tra.zigzag_positions(me, n, s_tot // n).numpy(),
                                  np.asarray(jra.zigzag_positions(me, n, s_tot // n)))
    with pytest.raises(ValueError) as err:
        tra.zigzag_permutation(4, 12)
    with pytest.raises(ValueError) as jerr:
        jra.zigzag_permutation(4, 12)
    assert str(err.value) == str(jerr.value)
    x = torch.zeros(1, 1, 3, D)
    with pytest.raises(ValueError, match="unknown layout 'ring'"):
        tra.ring_attention(x, x, x, layout="ring")
    with pytest.raises(ValueError, match="zigzag needs an even s_loc, got 3"):
        tra.ring_attention(x, x, x, layout="zigzag")
    assert tops.RingAttentionConfig() == tra.RingAttentionConfig(512, 512)
    assert tops.ring_attention_grad is tgrads.ring_attention_grad


@pytest.mark.parametrize("layout", ["contig", "zigzag"])
def test_ring_attention_grad_matches_jax(layout):
    """World 4, causal: dq, dk, dv of ``ring_attention_grad`` against
    ``jax.vjp`` of the JAX package's (its backward ``_ring_attn_bwd`` — one
    gather of (k ‖ v), the chunked flash gradient from the saved lse, one
    psum_scatter — on the dense golden's out and lse)."""
    world, s_tot = 4, 32
    q, k, v, dout = (x[:, :, tra.zigzag_permutation(world, s_tot)[0]] if layout == "zigzag"
                     else x for x in _inputs(30, s_tot))

    def jax_side(q, k, v, dout):
        out, vjp = jax.vjp(lambda q, k, v: jgrads.ring_attention_grad(
            q, k, v, "tp", True, None, None, layout), q, k, v)
        return (out, *vjp(dout))

    with mock.patch.object(jra, "ring_attention", _dense_ring):
        want = _shard(jax_side, world, 4, 4)(q, k, v, dout)
    s_loc = s_tot // world

    def fn(ctx, r):
        leaves = [_t(x[:, :, r * s_loc:(r + 1) * s_loc]).requires_grad_() for x in (q, k, v)]
        out = tgrads.ring_attention_grad(*leaves, ctx=ctx, layout=layout)
        return out, *torch.autograd.grad(out, leaves, _t(dout[:, :, r * s_loc:(r + 1) * s_loc]))

    outs = _port(world, fn)
    for i in range(4):
        _close(torch.cat([o[i] for o in outs], 2), want[i], GRAD_TOL)


@pytest.mark.parametrize("world", [1, 4])
def test_ulysses_matches_jax(world):
    """``ulysses_attention`` forward and dq, dk, dv against ``jax.vjp`` of
    the JAX package's (4 heads, one head a rank at world 4; its all-to-all
    kernel interpreted), the port's exchange on the host twin of K27."""
    s_tot = 16 * world
    q, k, v, dout = _inputs(40 + world, s_tot, heads=4)

    def jax_side(q, k, v, dout):
        out, vjp = jax.vjp(lambda q, k, v: jax_ulysses(q, k, v, "tp", True), q, k, v)
        return (out, *vjp(dout))

    want = _shard(jax_side, world, 4, 4)(q, k, v, dout)
    s_loc = s_tot // world

    def fn(ctx, r):
        leaves = [_t(x[:, :, r * s_loc:(r + 1) * s_loc]).requires_grad_() for x in (q, k, v)]
        out = tuly.ulysses_attention(*leaves, ctx=ctx)
        return out, *torch.autograd.grad(out, leaves, _t(dout[:, :, r * s_loc:(r + 1) * s_loc]))

    outs = _port(world, fn)
    for i in range(4):
        _close(torch.cat([o[i] for o in outs], 2), want[i], GRAD_TOL)


def test_usp_attention_inner_one_and_its_refusal():
    """With an inner axis of one rank ``usp_attention`` is ring attention
    over the outer one, forward and backward bit for bit; with an outer
    axis of one rank (``{"sp": 1, "tp": 2}``) it is the Ulysses head
    exchange over the inner one (the ring of one rank its local attention;
    the two-axis case against JAX is in ``test_torch_train2d.py``)."""
    q, k, v, dout = _inputs(50, 32)
    s_loc = 16

    def fn(ctx, r):
        rows = slice(r * s_loc, (r + 1) * s_loc)
        outs = []
        for attn in (lambda *a: tuly.usp_attention(*a, ctx=ctx, layout="zigzag"),
                     lambda *a: tgrads.ring_attention_grad(*a, ctx=ctx, layout="zigzag")):
            leaves = [_t(x[:, :, rows]).requires_grad_() for x in (q, k, v)]
            out = attn(*leaves)
            outs.append([out, *torch.autograd.grad(out, leaves, _t(dout[:, :, rows]))])
        return outs

    for usp, ring in _port(2, fn):
        assert all(torch.equal(a, b) for a, b in zip(usp, ring))
    ctx = initialize_distributed(mesh_shape={"sp": 1, "tp": 2}, device="cpu")

    def pair():
        rows = slice(ctx.rank * s_loc, (ctx.rank + 1) * s_loc)
        outs = []
        for attn in (lambda *a: tuly.usp_attention(*a, ctx=ctx, outer="sp", inner="tp"),
                     lambda *a: tuly.ulysses_attention(*a, ctx=ctx.group("tp"))):
            leaves = [_t(x[:, :, rows]).requires_grad_() for x in (q, k, v)]
            out = attn(*leaves)
            outs.append([out, *torch.autograd.grad(out, leaves, _t(dout[:, :, rows]))])
        return outs

    for usp, uly in ctx.run(pair, grad=True):
        for a, b in zip(usp, uly):
            _close(a, b.detach().numpy(), GRAD_TOL)

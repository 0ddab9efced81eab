"""The PyTorch port's KV handoff stream against the JAX package on the CPU.

- **Wire quantizers**: ``quantize_kv_wire`` and ``quantize_kv_wire_fp8``
  give payload bytes and f32 scales equal to the JAX package's (fp8
  compared through a ``uint8`` view), ``dequantize_kv_wire`` the same
  values.
- **The mirror exchange** (what the CPU runs: the plain version over the
  runtime's host ``ppermute``; the CUDA kernels K41/K42 are held to it in
  ``test_torch_cuda_kernels.py``) at world 2 and 4 for every member of
  ``KV_STREAM_TUNE_SPACE``: bit-equal to JAX's ``_kv_stream_fused`` run
  interpreted inside ``shard_map`` (the Mosaic TPU interpreter that
  ``tests/conftest.py`` turns on) and to its
  ``_kv_stream_xla``, one JAX program a world.
- **``kv_stream_op``** on every wire against JAX's ``kv_stream_op`` to 1e-6
  (as ``tests/test_fp8.py``'s fp8 round trip: under ``jit`` XLA divides by
  the constant ceiling as a product with its reciprocal, so a scale may sit
  an ulp apart).
- **Errors**: an odd world, missing or surplus scales and scale rows other
  than m raise ``ValueError``s whose messages equal JAX's.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import triton_dist_tpu.ops.kv_stream  # noqa: F401
from triton_dist_tpu_torch import ops as tops
from triton_dist_tpu_torch.ops import kv_stream as tkv
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

jkv = sys.modules["triton_dist_tpu.ops.kv_stream"]

M, W = 8, 16  # rows and row width of a rank's slab (chunks 1, 2, 4 all cut it)


def _to_torch(x):
    """A JAX or numpy array as a torch tensor; fp8 crosses as its bytes."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bits(x):
    """A torch tensor or JAX array as numpy bits (fp8 as its bytes)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.dtype == torch.float8_e4m3fn else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


def _slab(rng, rows):
    """Rows whose magnitudes span three decades (a misplaced scale shows),
    one all-zero row (scale 1) and one exact tie for int8's rounding."""
    x = rng.standard_normal((rows, W)) * np.logspace(-1.5, 1.5, rows)[:, None]
    x[1] = 0.0
    x[2, :2] = [127.0, 0.5]
    return x.astype(np.float32)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_wire_quantizers_match_jax(wire):
    x = _slab(np.random.default_rng(1), 4 * M)
    jq, js = jkv.quantize_kv_wire_for(wire, jnp.asarray(x))
    tq, ts = tkv.quantize_kv_wire_for(wire, torch.from_numpy(x))
    assert tq.dtype == {"int8": torch.int8, "fp8": tkv.FP8_WIRE_DTYPE}[wire]
    assert tq.shape == (4 * M, W) and ts.shape == (4 * M, 1) and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tkv.dequantize_kv_wire(tq, ts, dtype).float().numpy()
        want = np.asarray(jkv.dequantize_kv_wire(jq, js, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not a quantized wire: 'native'"):
        tkv.quantize_kv_wire_for("native", torch.from_numpy(x))


def test_config_tune_space_and_mirror_match_jax():
    assert tkv.WIRES == jkv.WIRES and tkv.QUANT_WIRES == jkv.QUANT_WIRES
    assert [(c.chunks_per_shard, c.wire) for c in tkv.KV_STREAM_TUNE_SPACE] == [
        (c.chunks_per_shard, c.wire) for c in jkv.KV_STREAM_TUNE_SPACE]
    assert tops.KVStreamConfig is tkv.KVStreamConfig and tops.kv_stream_op is tkv.kv_stream_op
    assert tops.kv_stream is tkv  # the submodule, never shadowed by the function
    for n in (2, 4, 6):
        for me in range(n):
            assert tkv.mirror_peer(me, n) == int(jkv.mirror_peer(me, n))
            assert tkv.mirror_peer(tkv.mirror_peer(me, n), n) == me
    for bad in (tkv.KVStreamConfig(chunks_per_shard=0), tkv.KVStreamConfig(wire="int4")):
        jbad = jkv.KVStreamConfig(chunks_per_shard=bad.chunks_per_shard, wire=bad.wire)
        with pytest.raises(ValueError) as want:
            jbad.validate()
        with pytest.raises(ValueError) as got:
            bad.validate()
        assert str(got.value) == str(want.value)


def _inputs(world):
    """Each rank's native f32 slab and its int8 and fp8 wire forms (the
    JAX quantizers, so both sides stream the same bytes)."""
    x = _slab(np.random.default_rng(10 + world), world * M)
    wires = {"native": (x, None)}
    for wire in tkv.QUANT_WIRES:
        q, s = jkv.quantize_kv_wire_for(wire, jnp.asarray(x))
        wires[wire] = (np.asarray(q), np.asarray(s))
    return wires


@pytest.mark.parametrize("world", [2, 4])
def test_kv_stream_matches_interpreted_kernels(world):
    """Every tune-space member: the port's plain exchange bit-equal to the
    JAX Pallas kernels (interpreted) and to JAX's ppermute golden."""
    wires = _inputs(world)
    space = jkv.KV_STREAM_TUNE_SPACE
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))

    def jprogram(x, q8, s8, qf, sf):
        ops = {"native": (x, None), "int8": (q8, s8), "fp8": (qf, sf)}
        outs = []
        for cfg in space:
            p, s = ops[cfg.wire]
            outs.append(jkv._kv_stream_fused(p, s, axis="tp", config=cfg))
        for wire in tkv.WIRES:
            outs.append(jkv._kv_stream_xla(*ops[wire], axis="tp") if wire != "native"
                        else jkv._kv_stream_xla(x, axis="tp"))
        return outs

    args = [wires["native"][0], *wires["int8"], *wires["fp8"]]
    fn = jax.jit(jax.shard_map(jprogram, mesh=mesh, in_specs=(P("tp"),) * 5,
                               out_specs=P("tp"), check_vma=False))
    want = jax.device_get(fn(*(jnp.asarray(a) for a in args)))
    golden = dict(zip(tkv.WIRES, want[len(space):]))
    want = want[:len(space)]
    ctx = initialize_distributed(world, device="cpu")
    port = {w: tuple(None if a is None else _to_torch(a) for a in v) for w, v in wires.items()}

    def rank():
        r = ctx.rank
        outs = []
        for cfg in tkv.KV_STREAM_TUNE_SPACE:
            p, s = port[cfg.wire]
            rows = slice(r * M, (r + 1) * M)
            outs.append(tkv.kv_stream(p[rows], None if s is None else s[rows], ctx=ctx,
                                      config=cfg))
        return outs

    calls = tkv._kv_stream_xla.calls
    per_rank = ctx.run(rank)
    assert tkv._kv_stream_xla.calls - calls == world * len(space)
    for i, cfg in enumerate(tkv.KV_STREAM_TUNE_SPACE):
        parts = [o[i] for o in per_rank]
        if cfg.wire == "native":
            got = np.concatenate([_bits(p) for p in parts])
            np.testing.assert_array_equal(got, _bits(want[i]))
            np.testing.assert_array_equal(got, _bits(golden["native"]))
            continue
        for j in range(2):  # payload, scales
            got = np.concatenate([_bits(p[j]) for p in parts])
            np.testing.assert_array_equal(got, _bits(want[i][j]))
            np.testing.assert_array_equal(got, _bits(golden[cfg.wire][j]))
    # the mirror's rows landed here: rank r holds rank (r + n/2)'s slab
    for i, cfg in enumerate(tkv.KV_STREAM_TUNE_SPACE):
        payload = port[cfg.wire][0]
        for r, outs in enumerate(per_rank):
            got = outs[i] if cfg.wire == "native" else outs[i][0]
            m = tkv.mirror_peer(r, world)
            np.testing.assert_array_equal(_bits(got), _bits(payload[m * M:(m + 1) * M]))


@pytest.mark.parametrize("wire", ["native", "int8", "fp8"])
def test_kv_stream_op_matches_jax(wire):
    world = 4
    x = _slab(np.random.default_rng(20), world * M)
    cfg = tkv.KVStreamConfig(chunks_per_shard=2, wire=wire)
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    want = np.asarray(jkv.kv_stream_op(jnp.asarray(x), mesh, config=jkv.KVStreamConfig(
        chunks_per_shard=2, wire=wire)))
    ctx = initialize_distributed(world, device="cpu")
    got = tkv.kv_stream_op(torch.from_numpy(x), ctx=ctx, config=cfg)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # world 1 keeps the slab in place (after the wire's round trip)
    one = tkv.kv_stream_op(torch.from_numpy(x), config=cfg).numpy()
    if wire == "native":
        np.testing.assert_array_equal(one, x)
    else:
        half = np.concatenate([one[2 * M:], one[:2 * M]])
        np.testing.assert_allclose(half, want, rtol=1e-6, atol=1e-6)


def _jax_error(world, payload, scales, cfg):
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    args = (payload,) if scales is None else (payload, scales)

    def body(*a):
        return jkv._kv_stream_fused(*a, axis="tp", config=cfg)

    with pytest.raises(ValueError) as err:
        jax.shard_map(body, mesh=mesh, in_specs=(P("tp"),) * len(args), out_specs=P("tp"),
                      check_vma=False)(*args)
    return str(err.value)


def test_errors_match_jax():
    """An odd world, a quantized wire without scales, the native wire with
    them, and scale rows other than the payload's: the same words."""
    cases = [
        (3, np.ones((3 * M, W), np.float32), None, "native"),
        (2, np.ones((2 * M, W), np.int8), None, "int8"),
        (2, np.ones((2 * M, W), np.float32), np.ones((2 * M, 1), np.float32), "native"),
        (2, np.ones((2 * M, W), np.int8), np.ones((2 * (M - 1), 1), np.float32), "int8"),
    ]
    for world, payload, scales, wire in cases:
        want = _jax_error(world, jnp.asarray(payload),
                          None if scales is None else jnp.asarray(scales),
                          jkv.KVStreamConfig(wire=wire))
        ctx = initialize_distributed(world, device="cpu")
        m = payload.shape[0] // world
        s_rows = None if scales is None else scales.shape[0] // world
        tp = torch.from_numpy(payload[:m])
        ts = None if scales is None else torch.from_numpy(scales[:s_rows])
        with pytest.raises(ValueError) as got:
            tkv.kv_stream(tp, ts, ctx=ctx, config=tkv.KVStreamConfig(wire=wire))
        assert str(got.value) == want
    # world 1 is the identity, with or without scales
    x = torch.ones(M, W)
    assert tkv.kv_stream(x) is x
    q, s = tkv.quantize_kv_wire(x)
    assert tkv.kv_stream(q, s, config=tkv.KVStreamConfig(wire="int8")) == (q, s)

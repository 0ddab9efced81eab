"""The dense and MoE LLaMA-class decoders (≙ ``triton_dist_tpu/models/
tp_transformer.py``), forward, vocab-parallel loss and SGD train step, at
any world.

Layouts match the JAX package at every public function: weights are
``[K, N]`` (``x @ W``), ``wqkv`` is kv-group-major ``[H, n_kv, (g+2)*d]``
(each group's g query heads, its K head, its V head), gate/up are
interleaved per FFN unit ``[H, F, 2]``. :func:`shard_params` lays the
weights out over the ranks as ``param_specs`` (``:116``) does: column
weights split on their output dim, row weights on their input dim, the LM
head vocab-parallel, norms and embedding replicated.

The forward is the per-rank Megatron body (``:190-238``): the residual
stream is token-sharded ``[m_loc, H]``; the column projections (QKV,
gate/up, LM head) go through ``ag_gemm`` (K6, or K15 on a ring; K1 at
world 1) and the row projections (attention out, MLP down) through
``gemm_rs`` (K7, or K16/K17 on a ring; K1 at world 1), with the config's
``ag_config``/``rs_config`` (``:183``, ``:188``); attention runs on the rank's local heads over the whole sequence.
RMSNorm, RoPE and the prefill attention are plain PyTorch, as the JAX
package leaves them to XLA. With grad mode on (training; serving runs in
inference mode) the projections go through the differentiable ops of
``ops/grads.py``, whose backward passes run the same kernels.

:meth:`TPTransformer.loss` is the vocab-parallel cross-entropy and
:func:`train_step` one optimizer step (``:547``) with the JAX package's
gradient accounting, over the data-parallel axis ``dp_axis`` of a 2-D
runtime too (``:595-625``): SGD at ``lr`` by default, or the transform
``opt=`` (``optim.adam`` / ``optim.sgd``, optax's twins) with its
``opt_state=``, returning ``(params, opt_state, loss)``. Call both per
rank inside ``ctx.run(..., grad=True)`` (world 1: directly).

On a 2-D runtime (``initialize_distributed(mesh_shape={"dp": 2, "tp":
2})``) a model runs its tensor parallelism over the group of
``cfg.axis`` (``"tp"``): pass the runtime, and the model takes its group.
:func:`shard_params` with ``ctx=`` lays the weights out per global rank:
the TP shards replicated over the other axes, an EP bank split over
``(ep_outer, axis)`` outer-major.

The MoE decoder (:class:`TPMoETransformer`, ``:352``) keeps the attention
and replaces the MLP by a router and a tensor-parallel expert bank: a
single up-projection ``w_up [E, H, F]``, the tanh GELU, ``w_down [E, F,
H]`` (no gate), both sharded on F, through ``ops/moe_mlp.tp_moe_mlp``.
:func:`quantize_moe_serving_params` (``:306``) turns the banks into int8 or
fp8 e4m3 pools with per-(expert, out-column) scales for serving.

The expert-parallel decoder (:class:`EPMoETransformer`, ``:447``) keeps the
same parameter tree but holds whole experts a rank (:func:`shard_params`
with the config splits the banks on the expert dim) and moves the tokens
to them over the all-to-all (``layers/ep_moe_mlp.py``); with ``ep_outer``
the hierarchical two-phase dispatch over ``(ep_outer, axis)``. Serving
only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from triton_dist_tpu_torch import optim
from triton_dist_tpu_torch.config import resolve_device
from triton_dist_tpu_torch.layers.ep_a2a_layer import _check_quant
from triton_dist_tpu_torch.ops import grads
from triton_dist_tpu_torch.ops.allgather_gemm import AGGemmConfig, ag_gemm
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import GemmRSConfig, gemm_rs
from triton_dist_tpu_torch.ops.group_gemm import (
    FP8_DTYPE,
    quantize_expert_weights,
    quantize_expert_weights_fp8,
)
from triton_dist_tpu_torch.ops.moe_mlp import tp_moe_mlp
from triton_dist_tpu_torch.ops.moe_utils import select_experts
from triton_dist_tpu_torch.utils import axis_index, axis_size


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """LLaMA-class decoder config (``dtype`` is a torch dtype). ``ag_config``
    and ``rs_config`` (≙ ``:60-61``) reach every column and row projection,
    forward and backward (None: the defaults). ``axis`` is the tensor-
    parallel axis of the rank runtime (≙ ``:59``)."""

    vocab: int = 256
    hidden: int = 128
    ffn: int = 256
    n_layers: int = 2
    n_q_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 32
    batch: int = 2
    seq: int = 32
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    ag_config: AGGemmConfig | None = None
    rs_config: GemmRSConfig | None = None
    axis: str = "tp"

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def qkv_dim(self) -> int:
        return self.q_dim + 2 * self.kv_dim


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig(TransformerConfig):
    """MoE decoder: dense attention + tensor-parallel expert MLPs (≙
    ``MoETransformerConfig``, ``:267``). ``gg_config`` is an
    ``ops.group_gemm.GroupGemmConfig`` (None: the default)."""

    n_experts: int = 8
    topk: int = 2
    gg_config: object = None


@dataclasses.dataclass(frozen=True)
class EPMoETransformerConfig(MoETransformerConfig):
    """Expert-parallel MoE decoder (≙ ``EPMoETransformerConfig``, ``:399``):
    the attention stays tensor-parallel, the experts are whole and spread
    over the ranks, the tokens travel to them over the all-to-all.
    ``ep_max_m`` is the per-(source, destination) slab capacity (None: the
    worst case, which never drops; an undersized one drops assignments,
    loudly under ``config.debug_ep_overflow``); ``ep_quant`` the one-byte
    dispatch wire (serving only). ``ep_outer`` names the outer axis of the
    hierarchical two-phase dispatch over ``(ep_outer, axis)``: the
    attention stays tensor-parallel over ``axis``, each outer group serves
    its own batch slice, and the experts spread over both axes."""

    ep_outer: str | None = None
    ep_max_m: int | None = None
    ep_quant: str | None = None

    def __post_init__(self):
        _check_quant(self.ep_quant)


def init_params(cfg: TransformerConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded random parameters in the JAX package's tree and layouts,
    drawn with a ``torch.Generator`` on `device` (the card unless the caller
    asks for the CPU). The draws differ from ``jax.random``'s; tests that
    need both packages to compute one function carry JAX's weights over with
    :func:`params_from_numpy` instead. A :class:`MoETransformerConfig` gets
    each layer's router and expert banks (:func:`init_moe_params`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(shape, scale):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    h, f = cfg.hidden, cfg.ffn
    g = cfg.n_q_heads // cfg.n_kv_heads

    def mlp():
        if isinstance(cfg, MoETransformerConfig):
            e = cfg.n_experts
            return dict(router=w((h, e), h**-0.5), w_up=w((e, h, f), h**-0.5),
                        w_down=w((e, f, h), f**-0.5))
        return dict(w_gate_up=w((h, f, 2), h**-0.5), w_down=w((f, h), f**-0.5))

    layers = [
        dict(
            attn_norm=ones(h),
            wqkv=w((h, cfg.n_kv_heads, (g + 2) * cfg.head_dim), h**-0.5),
            wo=w((cfg.q_dim, h), cfg.q_dim**-0.5),
            mlp_norm=ones(h),
            **mlp(),
        )
        for _ in range(cfg.n_layers)
    ]
    return dict(
        embed=w((cfg.vocab, h), 0.02),
        layers=layers,
        final_norm=ones(h),
        lm_head=w((h, cfg.vocab), h**-0.5),
    )


def init_moe_params(cfg: MoETransformerConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded random MoE parameters (≙ ``init_moe_params``, ``:277``): the
    attention weights of :func:`init_params`, and per layer a router ``[H,
    E]``, ``w_up [E, H, F]`` and ``w_down [E, F, H]`` in place of the dense
    MLP."""
    if not isinstance(cfg, MoETransformerConfig):
        raise TypeError("init_moe_params takes a MoETransformerConfig")
    return init_params(cfg, seed, device=device)


def params_from_numpy(tree: dict, device, dtype: torch.dtype) -> dict:
    """The JAX package's ``init_params`` tree, as numpy arrays, to this
    port's parameters (same keys, same layouts) on `device`: float leaves
    in `dtype`, except the quantized serving banks of
    :func:`quantize_moe_serving_params`: int8 pools stay ``torch.int8``,
    fp8 pools keep their bytes (through a ``uint8`` view), scales stay
    f32."""

    def conv(name, x):
        a = np.asarray(x)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy()).to(device)
        if a.dtype.itemsize == 1:  # float8_e4m3fn, numpy's ml_dtypes
            return torch.from_numpy(a.view(np.uint8).copy()).view(FP8_DTYPE).to(device)
        out_dtype = torch.float32 if name.endswith("_scale") else dtype
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=out_dtype)

    return dict(
        embed=conv("embed", tree["embed"]),
        layers=[{k: conv(k, v) for k, v in p.items()} for p in tree["layers"]],
        final_norm=conv("final_norm", tree["final_norm"]),
        lm_head=conv("lm_head", tree["lm_head"]),
    )


def quantize_moe_serving_params(params: dict, fmt: str = "int8") -> dict:
    """Quantize every layer's expert banks for serving (≙
    ``quantize_moe_serving_params``, ``:306``; weight-only, per-(expert,
    out-column) scales): ``w_up``/``w_down`` become int8 (``fmt="int8"``)
    or fp8 e4m3 (``fmt="fp8"``) pools and ``w_up_scale``/``w_down_scale``
    ``[E, 1, N]`` f32 join them. Returns a new tree; the other leaves are
    shared, not copied."""
    if fmt not in ("int8", "fp8"):
        raise ValueError(f"fmt must be 'int8' or 'fp8', got {fmt!r}")
    quantize = quantize_expert_weights_fp8 if fmt == "fp8" else quantize_expert_weights
    params = dict(params)
    params["layers"] = [dict(p) for p in params["layers"]]
    for p in params["layers"]:
        for name in ("w_up", "w_down"):
            p[name], p[name + "_scale"] = quantize(p[name])
    return params


def is_quantized_params(params: dict) -> bool:
    """Whether a parameter tree holds quantized serving banks."""
    return bool(params["layers"]) and "w_up_scale" in params["layers"][0]


# where each weight is split over the ranks (≙ param_specs, and for an MoE
# layer moe_param_specs, :295): the dim, or None for a replicated tensor
_TOP_SPLIT = dict(embed=None, final_norm=None, lm_head=1)
_LAYER_SPLIT = dict(attn_norm=None, wqkv=1, wo=0, mlp_norm=None, w_gate_up=1, w_down=0)
_MOE_LAYER_SPLIT = dict(attn_norm=None, wqkv=1, wo=0, mlp_norm=None, router=None, w_up=2,
                        w_down=1)
# the quantized serving banks (≙ moe_quantized_param_specs, :339): the pools
# keep their banks' splits; a scale [E, 1, N] splits with its OUT dim, so
# w_up's F columns split and w_down's H stays whole
_MOE_QUANT_LAYER_SPLIT = dict(_MOE_LAYER_SPLIT, w_up_scale=2, w_down_scale=None)
# expert parallelism (≙ ep_moe_param_specs / ep_moe_quantized_param_specs,
# :420, :433): the banks, and the scales with them, split on the EXPERT dim
_EP_LAYER_SPLIT = dict(_MOE_LAYER_SPLIT, w_up=0, w_down=0)
_EP_QUANT_LAYER_SPLIT = dict(_EP_LAYER_SPLIT, w_up_scale=0, w_down_scale=0)


def _moe_split(ep: bool, quant: bool) -> dict:
    if ep:
        return _EP_QUANT_LAYER_SPLIT if quant else _EP_LAYER_SPLIT
    return _MOE_QUANT_LAYER_SPLIT if quant else _MOE_LAYER_SPLIT


def specs_for(cfg: TransformerConfig, params: dict | None = None) -> dict:
    """Where each parameter is split over the ranks (≙ ``specs_for``,
    ``:501``): the parameter tree with the split dim at each leaf, or None
    for a replicated leaf. Pass `params` when they may hold quantized
    serving banks (:func:`quantize_moe_serving_params`)."""
    if isinstance(cfg, MoETransformerConfig):
        quant = params is not None and is_quantized_params(params)
        layer = _moe_split(isinstance(cfg, EPMoETransformerConfig), quant)
    else:
        layer = _LAYER_SPLIT
    return dict(_TOP_SPLIT, layers=[dict(layer) for _ in range(cfg.n_layers)])


def _layer_split(p: dict, cfg) -> dict:
    if "router" not in p:
        return _LAYER_SPLIT
    return _moe_split(isinstance(cfg, EPMoETransformerConfig), "w_up_scale" in p)


_EP_BANKS = ("w_up", "w_down", "w_up_scale", "w_down_scale")


def split_axes(cfg, name: str) -> tuple[str, ...]:
    """The runtime axes a split leaf `name` is split over (≙ the axes of
    its ``PartitionSpec`` entry): an EP bank over ``(ep_outer, axis)``
    outer-major (or ``axis`` when flat), everything else over ``axis``."""
    axis = getattr(cfg, "axis", "tp")
    if isinstance(cfg, EPMoETransformerConfig) and name in _EP_BANKS:
        return (axis,) if cfg.ep_outer is None else (cfg.ep_outer, axis)
    return (axis,)


def shard_params(params: dict, world: int | None = None, devices=None, cfg=None, *,
                 ctx=None) -> list[dict]:
    """Per-rank parameters (≙ ``specs_for`` + ``jax.device_put``): rank
    ``r`` gets slice ``r`` of each split weight, contiguous, on
    ``devices[r]`` (default: where the weight is). Replicated tensors are
    shared, not copied, between ranks on one device. The tree alone cannot
    tell the MoE layouts apart: pass the model's `cfg` so an
    :class:`EPMoETransformerConfig` gets its banks split on the expert dim
    (without it an MoE tree takes the tensor-parallel F split).

    With ``ctx`` (a rank runtime, 1-D or 2-D) the list has one entry a
    global rank, on ``ctx.devices``: a leaf split over axes ``A``
    (:func:`split_axes`) gets the slice of the rank's flattened index on
    ``A`` (a TP shard is then replicated over the other axes)."""
    if ctx is not None:
        ctx = ctx.runtime
        world, devices = ctx.world, devices or ctx.devices
    devices = devices or [None] * world

    def where(name, r):
        if ctx is None:
            return r, world
        axes = split_axes(cfg, name)
        return ctx.index_of(r, axes), ctx.axis_size(axes)

    def part(x, dim, r, name):
        dev = devices[r] or x.device
        if dim is None:
            return x.to(dev)
        i, count = where(name, r)
        if x.shape[dim] % count:
            raise ValueError(f"shape {tuple(x.shape)} dim {dim} does not split over {count}")
        return x.chunk(count, dim)[i].to(dev).contiguous()

    def rank(r):
        return {
            k: [{n: part(w, _layer_split(p, cfg)[n], r, n) for n, w in p.items()} for p in v]
            if k == "layers" else part(v, _TOP_SPLIT[k], r, k)
            for k, v in params.items()
        }

    return [rank(r) for r in range(world)]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * scale


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) of the rotary angles for ``positions [..., s]``, shaped
    ``[..., s, 1, d/2]`` to broadcast over heads. A decode step computes
    them once for all its layers."""
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d
    )
    ang = positions.float()[..., None] * freqs            # [..., s, d/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the two halves of the head dim; x ``[..., s,
    n_heads, d]``, positions ``[..., s]`` (``[s]`` for a prompt, ``[b, 1]``
    for one decode token per sequence)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _causal_gqa_attention(q, k, v, cfg: TransformerConfig) -> torch.Tensor:
    """Causal GQA over the full sequence, f32 scores; q ``[b, s, hq, d]``,
    k/v ``[b, s, h_kv, d]`` → ``[b, s, hq * d]`` in q's dtype."""
    b, s, hq, d = q.shape
    h_kv = k.shape[2]
    g = hq // h_kv
    qg = q.reshape(b, s, h_kv, g, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) / math.sqrt(d)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return out.reshape(b, s, hq * d).to(q.dtype)


@dataclasses.dataclass
class TPTransformer:
    """Decoder-only forward of one rank (call inside ``ctx.run``; ``ctx``
    None is world 1) over its token shard of the flattened stream
    (``cfg.batch * cfg.seq`` tokens, batch-major, ``m_loc`` of them a
    rank). ``ctx`` may be a 2-D runtime: the model runs over its group of
    ``cfg.axis``. ``kv_sink``, when a list, collects each layer's post-RoPE ``(k,
    v)`` ``[b, s, h_kv / world, d]`` (the rank's heads) for the prefill
    cache write (``models/decode.prefill_cache``)."""

    cfg: TransformerConfig
    kv_sink: list | None = None
    ctx: object = None

    def __post_init__(self):
        # a runtime (or any group of it) runs the model over cfg.axis
        if self.ctx is not None and hasattr(self.ctx, "group"):
            self.ctx = self.ctx.group(self.cfg.axis)

    def _col(self, x, w):
        c = self.cfg
        if torch.is_grad_enabled():
            return grads.ag_gemm_grad(x, w, ctx=self.ctx, ag_config=c.ag_config,
                                      rs_config=c.rs_config)
        return ag_gemm(x, w, ctx=self.ctx, config=c.ag_config)

    def _row(self, x, w):
        c = self.cfg
        if torch.is_grad_enabled():
            return grads.gemm_rs_grad(x, w, ctx=self.ctx, rs_config=c.rs_config,
                                      ag_config=c.ag_config)
        return gemm_rs(x, w, ctx=self.ctx, config=c.rs_config)

    def block(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        c = self.cfg
        n = axis_size(self.ctx)
        b, s = c.batch, c.seq
        hq_loc, hkv_loc = c.n_q_heads // n, c.n_kv_heads // n
        g = c.n_q_heads // c.n_kv_heads
        d = c.head_dim
        h = rmsnorm(x, p["attn_norm"], c.norm_eps)
        qkv = self._col(h, p["wqkv"].reshape(c.hidden, -1))
        qkv = qkv.reshape(b, s, hkv_loc, g + 2, d)   # the rank's kv groups
        q = qkv[..., :g, :].reshape(b, s, hq_loc, d)
        k = qkv[..., g, :]
        v = qkv[..., g + 1, :]
        pos = torch.arange(s, device=x.device)
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
        if self.kv_sink is not None:
            self.kv_sink.append((k, v))
        attn = _causal_gqa_attention(q, k, v, c)       # [b, s, hq_loc * d]
        x = x + self._row(attn.reshape(b * s, hq_loc * d), p["wo"])
        return x + self._mlp(x, p)

    def _mlp(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        c = self.cfg
        h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
        gu = self._col(h, p["w_gate_up"].reshape(c.hidden, -1))
        gu = gu.reshape(c.batch * c.seq, -1, 2)        # [m, F / world, 2]
        act = torch.nn.functional.silu(gu[..., 0].float()).to(x.dtype) * gu[..., 1]
        return self._row(act.contiguous(), p["w_down"])

    def __call__(self, tokens: torch.Tensor, params: dict) -> torch.Tensor:
        """tokens ``[m_loc]`` (this rank's shard of the ``b * s`` stream) →
        vocab-sharded logits ``[b * s, vocab / world]`` in ``cfg.dtype``."""
        c = self.cfg
        x = params["embed"][tokens]
        for p in params["layers"]:
            x = self.block(x, p)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        return self._col(x, params["lm_head"])

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor, params: dict) -> torch.Tensor:
        """Vocab-parallel cross-entropy (≙ ``loss``, ``:240``): no rank sees
        the whole logits; the log-sum-exp and the target logit are
        assembled with psums over the vocab shards. The max shift is
        detached (its gradient cancels). targets ``[b * s]`` int, the whole
        stream on every rank. Returns the mean over the stream (every rank
        the same value)."""
        ctx = self.ctx
        v_loc = self.cfg.vocab // axis_size(ctx)
        logits = self(tokens, params).float()                  # [m, V / world]
        row_max = logits.detach().amax(-1)
        m_sh = row_max if axis_size(ctx) == 1 else ctx.all_gather(row_max[None], 0).amax(0)
        se = grads.psum(torch.exp(logits - m_sh[:, None]).sum(-1), ctx)
        lse = m_sh + torch.log(se)
        local = targets.long() - axis_index(ctx) * v_loc
        in_shard = (local >= 0) & (local < v_loc)
        tl = logits.gather(1, local.clamp(0, v_loc - 1)[:, None])[:, 0]
        target_logit = grads.psum(torch.where(in_shard, tl, 0.0), ctx)
        return (lse - target_logit).mean()


@dataclasses.dataclass
class TPMoETransformer(TPTransformer):
    """MoE decoder of one rank (≙ ``TPMoETransformer``, ``:352``): the
    dense MLP half replaced by the router, the softmax top-k routing and
    the tensor-parallel expert MLP (K8 at world 1, K9/K10 at world > 1;
    with quantized banks under a ``w8``/``fp8`` config K24, K25/K26)."""

    def _mlp(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        c = self.cfg
        h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
        tw, ids = select_experts(h.float() @ p["router"].float(), c.topk)
        w_up, w_down = p["w_up"], p["w_down"]
        scales = {}
        if "w_up_scale" in p:
            gg = c.gg_config
            if gg is not None and (gg.w8 or gg.fp8):
                # the scaled formats' single pass (``:360-376``): the pools
                # and scales go straight to the grouped GEMMs (K24-K26)
                scales = dict(w_up_scale=p["w_up_scale"], w_down_scale=p["w_down_scale"])
            else:
                # quantized banks under a float config: dequantized to the
                # activation dtype on every call (``:378-390``)
                w_up = (w_up.float() * p["w_up_scale"]).to(x.dtype)
                w_down = (w_down.float() * p["w_down_scale"]).to(x.dtype)
        # the router trains through the routing weights
        mlp = grads.tp_moe_mlp_grad if torch.is_grad_enabled() else tp_moe_mlp
        return mlp(h, w_up, w_down, ids, tw, ctx=self.ctx, gg_config=c.gg_config,
                   **scales).to(x.dtype)


@dataclasses.dataclass
class EPMoETransformer(TPMoETransformer):
    """MoE decoder of one rank with expert-parallel MLPs (≙
    ``EPMoETransformer``, ``:447``): router → :class:`~triton_dist_tpu_torch.
    layers.ep_moe_mlp.EPMoEMLP` (the dispatch all-to-all K27/K28, the local
    grouped GEMMs K8 or K24, the combine); with ``cfg.ep_outer`` the
    two-phase dispatch over ``(ep_outer, axis)``, whose groups the model's
    ``ctx`` (the ``axis`` group of a 2-D runtime) reaches. Parameters from
    :func:`shard_params` with ``cfg``: each rank holds ``[E / world, H, F]``
    whole experts. It trains as the reference's does (``:447-466``): the
    dispatch and combine through the differentiable all-to-all, the expert
    GEMMs through ``group_gemm_grad``, and the hierarchical dispatch keeps
    the router gradient through the slab channel's straight-through
    weights."""

    def _mlp(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        c = self.cfg
        h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
        # flat dispatch can send all of a rank's topk assignments to one
        # rank; the hierarchical phase 1 sends at most one copy per (token,
        # destination group)
        max_m = c.ep_max_m or (x.shape[0] if c.ep_outer is not None else x.shape[0] * c.topk)
        return ep_moe_apply(c, h, p, max_m, ctx=self.ctx)


def ep_moe_apply(cfg: EPMoETransformerConfig, h: torch.Tensor, p: dict, max_m: int,
                 ctx=None) -> torch.Tensor:
    """Router → EP dispatch → expert GEMMs → combine on a token shard (≙
    ``ep_moe_apply``, ``:469``): the one implementation of the model
    forward and the serving decode, which differ in how they shard the
    tokens and bound ``max_m``. Quantized serving banks (a ``w_up_scale``)
    pass their scales through."""
    from triton_dist_tpu_torch.layers.ep_moe_mlp import EPMoEMLP

    tw, ids = select_experts(h.float() @ p["router"].float(), cfg.topk)
    hier = cfg.ep_outer is not None
    moe = EPMoEMLP(cfg.n_experts, cfg.topk, max_m, ctx, outer=cfg.ep_outer,
                   inner=cfg.axis if hier else None, gg_config=cfg.gg_config,
                   quant=cfg.ep_quant)
    scales = ({"w_up_scale": p["w_up_scale"], "w_down_scale": p["w_down_scale"]}
              if "w_up_scale" in p else {})
    return moe(h, p["w_up"], p["w_down"], ids, tw, **scales)


def _tree_map(fn, tree, *rest):
    """`fn` over the leaves of a parameter tree (dicts and lists of
    tensors); `rest` are trees of the same keys (extra keys are ignored)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    leaves = []
    _tree_map(leaves.append, tree)
    return leaves


def _trainable(p: torch.Tensor) -> bool:
    """A leaf SGD updates: a float tensor, not a quantized serving pool
    (int8 or fp8), which takes a zero cotangent as in the JAX package."""
    return p.is_floating_point() and p.dtype != FP8_DTYPE


def _loss_and_grads(model, params, tokens, targets, dp=None):
    """One rank's loss and the gradients ``train_step`` applies (≙ its
    ``value_and_grad`` and ``fix``, ``:595-613``), a list in the order of
    ``_tree_leaves(params)``: each rank differentiates its copy of the
    loss, so every gradient comes back scaled by the tp world; a leaf not
    split over the tp axis covers only this rank's tokens and is psum-ed
    over the tp group; with a dp group `dp` the loss is its mean over dp, a
    leaf split over the dp axis too (an EP bank over (dp, tp)) is divided
    by the dp world (its gradient already sums every dp group's share) and
    any other leaf is averaged over dp; then every gradient is divided by
    the tp world."""
    if not torch.is_grad_enabled() or torch.is_inference_mode_enabled():
        raise RuntimeError("train_step takes gradients: at world > 1 call it inside "
                           "ctx.run(..., grad=True), not in an inference-mode run")
    ctx = model.ctx
    world = axis_size(ctx)
    n_dp = axis_size(dp)
    work = _tree_map(lambda p: p.detach().requires_grad_(_trainable(p)), params)
    leaves = _tree_leaves(work)
    live = [p for p in leaves if p.requires_grad]
    loss = model.loss(tokens, targets, work)
    flat = dict(zip(map(id, live), torch.autograd.grad(loss, live, allow_unused=True)))
    flat = [flat.pop(id(p), None) for p in leaves]
    loss = loss.detach()
    if n_dp > 1:
        loss = dp.psum(loss) / n_dp
    cfg = model.cfg
    splits = _tree_leaves(_tree_map(lambda _, split: split, params, specs_for(cfg, params)))
    names = _tree_leaves(_tree_names(params))
    dp_name = dp.axis_names[0] if n_dp > 1 else None
    for i, (g, split) in enumerate(zip(flat, splits)):
        if not _trainable(leaves[i]):
            flat[i] = torch.zeros((), device=leaves[i].device)  # a pool's zero cotangent
            continue
        g = torch.zeros_like(leaves[i]) if g is None else g
        if split is None and world > 1:
            g = ctx.psum(g)
        if n_dp > 1:
            if split is not None and dp_name in split_axes(cfg, names[i]):
                g = g / n_dp
            else:
                g = dp.psum(g) / n_dp
        flat[i] = g / world
    return loss, flat


def _tree_names(tree, name=None):
    """Each leaf's key (a layer leaf's name in its layer dict)."""
    if isinstance(tree, dict):
        return {k: _tree_names(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_names(v, name) for v in tree]
    return name


def _dp_group(model, dp_axis):
    """The data-parallel group of `dp_axis` on the model's runtime; a
    runtime without that axis raises naming it."""
    ctx = model.ctx
    try:
        if ctx is None or not hasattr(ctx, "group"):
            raise ValueError("no rank runtime")
        return ctx.group(dp_axis)
    except ValueError as err:
        raise ValueError(
            f"train_step dp_axis={dp_axis!r}: the rank runtime has no axis {dp_axis!r} "
            f"({err}); pass dp_axis=None on a pure-TP runtime, or build one with "
            f"initialize_distributed(mesh_shape={{{dp_axis!r}: n, 'tp': m}})") from None


def train_step(
    model: TPTransformer, params: dict, tokens: torch.Tensor, targets: torch.Tensor,
    lr: float = 1e-2, dp_axis: str | None = "dp", opt=None, opt_state=None,
    skip_nonfinite: bool = False,
):
    """One optimizer step of one rank (≙ ``train_step``, ``:547``): call
    inside ``ctx.run(..., grad=True)`` with the rank's parameter shard
    (``shard_params``) and token shard; at world 1 call it directly.
    Default is SGD at `lr`: returns ``(params, loss)`` — new tensors, the
    inputs are not changed. With ``opt=`` (a transform of
    :mod:`triton_dist_tpu_torch.optim`, the twins of optax's ``adam`` and
    ``sgd``) and ``opt_state=`` (``opt.init`` of the rank's shard) `lr` is
    unused and the return is ``(params, opt_state, loss)``. With
    ``skip_nonfinite`` either return also ends in ``skipped`` (int32, 1
    when the step was dropped).

    ``dp_axis`` (default ``"dp"``, as the reference's) is the data-parallel
    axis of a 2-D runtime (``initialize_distributed(mesh_shape={"dp": 2,
    "tp": 2})``, the model built on it): the tokens are the rank's shard
    over ``(dp, tp)`` and the targets its dp group's, the loss is averaged
    over dp and the gradients follow the JAX package's accounting
    (:func:`_loss_and_grads`). Pass ``dp_axis=None`` on a pure-TP runtime
    and at world 1; a runtime without the axis raises a ``ValueError``
    naming it. ``skip_nonfinite`` gates the update on ``grads_all_finite``
    over the gradients and the loss on every rank of the tp and dp groups:
    a dropped step returns the parameters and the optimizer state bit for
    bit. A ragged ``gg_config`` trains on the ragged kernels (K29-K31
    forward, K29 and K34 backward); an expert-parallel model trains through
    the differentiable all-to-all (K27/K28) and grouped GEMMs, flat or
    hierarchical (``ep_outer``, its banks split over ``(ep_outer, axis)``);
    its quantized dispatch wire (``ep_quant``) cuts the router gradient and
    is refused here, as in the reference (``:581-590``)."""
    c = model.cfg
    if getattr(c, "ep_quant", None) is not None:
        raise ValueError(
            "train_step with ep_quant="
            f"{c.ep_quant!r}: the quantized EP dispatch wire is "
            "inference-only (it cuts the router gradient). Train with "
            "ep_quant=None and quantize for serving."
        )
    if (opt is None) != (opt_state is None):
        raise ValueError("train_step: pass opt= and opt_state= together (opt_state = "
                         "opt.init(params), the rank's shard)")
    dp = None if dp_axis is None else _dp_group(model, dp_axis)
    loss, flat = _loss_and_grads(model, params, tokens, targets, dp)
    ok = grads.grads_all_finite((flat, loss), model.ctx, dp) if skip_nonfinite else None
    order = iter(range(len(flat)))

    def gate(new, old):
        # ok=True is the identity on `new`; ok=False keeps `old` (parameters
        # and optimizer state: a dropped step leaves no trace)
        if ok is None:
            return new
        return optim.tree_map(lambda a, b: a if a is None or a is b else torch.where(ok, a, b),
                              new, old)

    if opt is not None:
        def grad_of(p):
            i = next(order)
            g, flat[i] = flat[i], None
            return g.to(p.dtype) if _trainable(p) else None

        with torch.no_grad():
            tree = _tree_map(grad_of, params)
            updates, new_state = opt.update(tree, opt_state, params)
            del tree  # the gradients are freed before the new parameters exist
            new_params = gate(optim.apply_updates(params, updates), params)
            del updates
            new_state = gate(new_state, opt_state)
        if ok is None:
            return new_params, new_state, loss
        return new_params, new_state, loss, (~ok).to(torch.int32)

    def update(p):
        i = next(order)
        g, flat[i] = flat[i], None  # each gradient is freed once applied
        if not _trainable(p):
            return p
        new = p - lr * g.to(p.dtype)
        return new if ok is None else torch.where(ok, new, p)

    with torch.no_grad():
        new_params = _tree_map(update, params)
    if ok is None:
        return new_params, loss
    return new_params, loss, (~ok).to(torch.int32)

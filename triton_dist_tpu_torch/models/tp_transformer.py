"""The dense LLaMA-class decoder (≙ ``triton_dist_tpu/models/
tp_transformer.py``), forward only, at world 1.

Layouts match the JAX package at every public function: weights are
``[K, N]`` (``x @ W``), ``wqkv`` is kv-group-major ``[H, n_kv, (g+2)*d]``
(each group's g query heads, its K head, its V head), gate/up are
interleaved per FFN unit ``[H, F, 2]``. The column projections (QKV,
gate/up, LM head) go through ``ag_gemm`` and the row projections
(attention out, MLP down) through ``gemm_rs``; at world 1 both are the K1
GEMM kernel. RMSNorm, RoPE and the prefill attention are plain PyTorch, as
the JAX package leaves them to XLA. The loss and train step are a later
slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from triton_dist_tpu_torch.config import resolve_device
from triton_dist_tpu_torch.ops.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import gemm_rs


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """LLaMA-class decoder config (``dtype`` is a torch dtype)."""

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

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def qkv_dim(self) -> int:
        return self.q_dim + 2 * self.kv_dim


def init_params(cfg: TransformerConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded random parameters in the JAX package's tree and layouts,
    drawn with a ``torch.Generator`` on `device` (the card unless the caller
    asks for the CPU). The draws differ from ``jax.random``'s; tests that
    need both packages to compute one function carry JAX's weights over with
    :func:`params_from_numpy` instead."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(shape, scale):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    h, f = cfg.hidden, cfg.ffn
    g = cfg.n_q_heads // cfg.n_kv_heads
    layers = [
        dict(
            attn_norm=ones(h),
            wqkv=w((h, cfg.n_kv_heads, (g + 2) * cfg.head_dim), h**-0.5),
            wo=w((cfg.q_dim, h), cfg.q_dim**-0.5),
            mlp_norm=ones(h),
            w_gate_up=w((h, f, 2), h**-0.5),
            w_down=w((f, h), f**-0.5),
        )
        for _ in range(cfg.n_layers)
    ]
    return dict(
        embed=w((cfg.vocab, h), 0.02),
        layers=layers,
        final_norm=ones(h),
        lm_head=w((h, cfg.vocab), h**-0.5),
    )


def params_from_numpy(tree: dict, device, dtype: torch.dtype) -> dict:
    """The JAX package's ``init_params`` tree, as numpy arrays, to this
    port's parameters (same keys, same layouts) on `device` in `dtype`."""

    def conv(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=device, dtype=dtype
        )

    return dict(
        embed=conv(tree["embed"]),
        layers=[{k: conv(v) for k, v in p.items()} for p in tree["layers"]],
        final_norm=conv(tree["final_norm"]),
        lm_head=conv(tree["lm_head"]),
    )


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
    """Decoder-only forward over the flattened token stream (``cfg.batch *
    cfg.seq`` tokens, batch-major). ``kv_sink``, when a list, collects each
    layer's post-RoPE ``(k, v)`` ``[b, s, h_kv, d]`` for the prefill cache
    write (``models/decode.prefill_cache``)."""

    cfg: TransformerConfig
    kv_sink: list | None = None

    def _col(self, x, w):
        return ag_gemm(x, w)

    def _row(self, x, w):
        return gemm_rs(x, w)

    def block(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        c = self.cfg
        b, s = c.batch, c.seq
        g = c.n_q_heads // c.n_kv_heads
        d = c.head_dim
        h = rmsnorm(x, p["attn_norm"], c.norm_eps)
        qkv = self._col(h, p["wqkv"].reshape(c.hidden, -1))
        qkv = qkv.reshape(b, s, c.n_kv_heads, g + 2, d)
        q = qkv[..., :g, :].reshape(b, s, c.n_q_heads, d)
        k = qkv[..., g, :]
        v = qkv[..., g + 1, :]
        pos = torch.arange(s, device=x.device)
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
        if self.kv_sink is not None:
            self.kv_sink.append((k, v))
        attn = _causal_gqa_attention(q, k, v, c)
        x = x + self._row(attn.reshape(b * s, c.q_dim), p["wo"])
        return x + self._mlp(x, p)

    def _mlp(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        c = self.cfg
        h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
        gu = self._col(h, p["w_gate_up"].reshape(c.hidden, -1))
        gu = gu.reshape(c.batch * c.seq, -1, 2)
        act = torch.nn.functional.silu(gu[..., 0].float()).to(x.dtype) * gu[..., 1]
        return self._row(act.contiguous(), p["w_down"])

    def __call__(self, tokens: torch.Tensor, params: dict) -> torch.Tensor:
        """tokens ``[b * s]`` → logits ``[b * s, vocab]`` in ``cfg.dtype``."""
        c = self.cfg
        x = params["embed"][tokens]
        for p in params["layers"]:
            x = self.block(x, p)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        return self._col(x, params["lm_head"])

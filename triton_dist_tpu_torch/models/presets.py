"""Named model-shape presets (≙ ``triton_dist_tpu/models/presets.py``):
the public architecture shapes of open-weight models as ready-to-run
configs. The MoE preset builds the tensor-parallel
:class:`~triton_dist_tpu_torch.models.tp_transformer.MoETransformerConfig`;
``":ep"`` (or ``ep=True``) its expert-parallel deployment, an
:class:`~triton_dist_tpu_torch.models.tp_transformer.EPMoETransformerConfig`
(≙ ``:82-100``). ``":ep-hier"`` and ``ep_outer=`` build the hierarchical
deployment (the two-phase dispatch over an ``(ep_outer, "tp")`` pair;
``":ep-hier"`` names the outer axis ``"dcn"``), served on a 2-D rank
runtime such as ``initialize_distributed(mesh_shape={"dcn": 2, "tp":
2})``. ``tp_check=`` holds the config to a TP degree
(:func:`validate_tp`, ≙ ``:45``).

    cfg = presets.preset("llama-3.1-8b", batch=8, n_layers=32)
    cfg = presets.preset("mixtral-8x7b", batch=8, n_layers=8)
    cfg = presets.preset("mixtral-8x7b:ep", batch=8, n_layers=8)
    cfg = presets.preset("mixtral-8x7b:ep-hier", batch=8, n_layers=8)
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.models.tp_transformer import (
    EPMoETransformerConfig,
    MoETransformerConfig,
    TransformerConfig,
)

# name → (hidden, ffn, n_q_heads, n_kv_heads, head_dim, vocab)
_DENSE = {
    "llama-7b": (4096, 11008, 32, 32, 128, 32000),
    "llama-3.1-8b": (4096, 14336, 32, 8, 128, 128256),
    "llama-3.1-70b": (8192, 28672, 64, 8, 128, 128256),
    "llama-3.1-405b": (16384, 53248, 128, 8, 128, 128256),
    "mistral-7b": (4096, 14336, 32, 8, 128, 32768),
    "qwen2-72b": (8192, 29568, 64, 8, 128, 152064),
}
# name → (hidden, ffn, n_q_heads, n_kv_heads, head_dim, vocab, E, topk)
_MOE = {
    "mixtral-8x7b": (4096, 14336, 32, 8, 128, 32000, 8, 2),
}

PRESETS = tuple(sorted((*_DENSE, *_MOE)))


def validate_tp(cfg: TransformerConfig, tp: int) -> None:
    """Raise if the preset's global shapes do not divide across `tp` ranks
    (≙ ``validate_tp``, ``:45``: kv heads bound attention TP; ``ffn``, the
    width the dense and the expert MLPs share, bounds the MLP TP)."""
    if cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} does not divide n_kv_heads={cfg.n_kv_heads}")
    if cfg.ffn % tp:
        raise ValueError(f"tp={tp} does not divide ffn={cfg.ffn}")


def preset(
    name: str,
    *,
    batch: int = 1,
    seq: int = 8192,
    n_layers: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
    tp_check: int | None = None,
    ep: bool = False,
    ep_outer: str | None = None,
    **overrides,
) -> TransformerConfig:
    """Build the named model's config. `n_layers` defaults to 1 (one
    decoder block); pass the real depth for full-model runs. Extra keyword
    arguments override any config field (≙ ``:73``), e.g.
    ``ag_config=AGGemmConfig(chunks_per_shard=2)``. ``ep=True`` (or the
    suffix ``":ep"``) builds an MoE preset's expert-parallel config;
    ``tp_check`` raises the reference's ``ValueError`` when that TP degree
    does not divide the shapes."""
    if name.endswith(":ep-hier"):
        name, ep, ep_outer = name[:-len(":ep-hier")], True, ep_outer or "dcn"
    elif name.endswith(":ep"):
        name, ep = name[:-len(":ep")], True
    if name in _MOE:
        h, f, q, kv, d, vocab, n_exp, topk = _MOE[name]
        if ep_outer is not None:
            overrides = dict(overrides, ep_outer=ep_outer)
        cfg = (EPMoETransformerConfig if ep or ep_outer else MoETransformerConfig)(
            vocab=vocab, hidden=h, ffn=f, n_layers=n_layers or 1,
            n_q_heads=q, n_kv_heads=kv, head_dim=d, batch=batch, seq=seq,
            dtype=dtype, n_experts=n_exp, topk=topk, **overrides,
        )
    elif name in _DENSE:
        if ep or ep_outer:
            raise ValueError(f"preset {name!r} is dense: expert parallelism applies to the "
                             f"MoE presets {sorted(_MOE)}")
        h, f, q, kv, d, vocab = _DENSE[name]
        cfg = TransformerConfig(
            vocab=vocab, hidden=h, ffn=f, n_layers=n_layers or 1,
            n_q_heads=q, n_kv_heads=kv, head_dim=d, batch=batch, seq=seq,
            dtype=dtype, **overrides,
        )
    else:
        raise KeyError(f"unknown preset {name!r}; have {PRESETS}")
    if tp_check is not None:
        validate_tp(cfg, tp_check)
    return cfg

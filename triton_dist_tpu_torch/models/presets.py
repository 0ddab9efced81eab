"""Named model-shape presets (≙ ``triton_dist_tpu/models/presets.py``):
the public architecture shapes of open-weight models as ready-to-run
configs. The MoE preset builds the tensor-parallel
:class:`~triton_dist_tpu_torch.models.tp_transformer.MoETransformerConfig`;
``":ep"`` (or ``ep=True``) its expert-parallel deployment, an
:class:`~triton_dist_tpu_torch.models.tp_transformer.EPMoETransformerConfig`
(≙ ``:82-100``). ``":ep-hier"`` (the hierarchical dispatch over an (outer,
inner) mesh) needs the 2-D rank runtime (ROADMAP A5) and raises.

    cfg = presets.preset("llama-3.1-8b", batch=8, n_layers=32)
    cfg = presets.preset("mixtral-8x7b", batch=8, n_layers=8)
    cfg = presets.preset("mixtral-8x7b:ep", batch=8, n_layers=8)
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


def preset(
    name: str,
    *,
    batch: int = 1,
    seq: int = 8192,
    n_layers: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
    ep: bool = False,
    **overrides,
) -> TransformerConfig:
    """Build the named model's config. `n_layers` defaults to 1 (one
    decoder block); pass the real depth for full-model runs. Extra keyword
    arguments override any config field (≙ ``:73``), e.g.
    ``ag_config=AGGemmConfig(chunks_per_shard=2)``. ``ep=True`` (or the
    suffix ``":ep"``) builds an MoE preset's expert-parallel config."""
    if name.endswith(":ep-hier"):
        raise NotImplementedError(
            f"preset {name!r}: hierarchical expert parallelism needs the 2-D "
            f"DistContext (an outer and an inner axis, ROADMAP A5)"
        )
    if name.endswith(":ep"):
        name, ep = name[:-len(":ep")], True
    if name in _MOE:
        h, f, q, kv, d, vocab, n_exp, topk = _MOE[name]
        return (EPMoETransformerConfig if ep else MoETransformerConfig)(
            vocab=vocab, hidden=h, ffn=f, n_layers=n_layers or 1,
            n_q_heads=q, n_kv_heads=kv, head_dim=d, batch=batch, seq=seq,
            dtype=dtype, n_experts=n_exp, topk=topk, **overrides,
        )
    if name not in _DENSE:
        raise KeyError(f"unknown preset {name!r}; have {PRESETS}")
    if ep:
        raise ValueError(f"preset {name!r} is dense: expert parallelism applies to the MoE "
                         f"presets {sorted(_MOE)}")
    h, f, q, kv, d, vocab = _DENSE[name]
    return TransformerConfig(
        vocab=vocab, hidden=h, ffn=f, n_layers=n_layers or 1,
        n_q_heads=q, n_kv_heads=kv, head_dim=d, batch=batch, seq=seq,
        dtype=dtype, **overrides,
    )

"""Named model-shape presets (≙ ``triton_dist_tpu/models/presets.py``):
the public architecture shapes of open-weight models as ready-to-run
configs. Dense presets only; the MoE preset needs the expert kernels
(ROADMAP A11) and raises.

    cfg = presets.preset("llama-3.1-8b", batch=8, n_layers=32)
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.models.tp_transformer import TransformerConfig

# name → (hidden, ffn, n_q_heads, n_kv_heads, head_dim, vocab)
_DENSE = {
    "llama-7b": (4096, 11008, 32, 32, 128, 32000),
    "llama-3.1-8b": (4096, 14336, 32, 8, 128, 128256),
    "llama-3.1-70b": (8192, 28672, 64, 8, 128, 128256),
    "llama-3.1-405b": (16384, 53248, 128, 8, 128, 128256),
    "mistral-7b": (4096, 14336, 32, 8, 128, 32768),
    "qwen2-72b": (8192, 29568, 64, 8, 128, 152064),
}
_MOE = ("mixtral-8x7b",)

PRESETS = tuple(sorted((*_DENSE, *_MOE)))


def preset(
    name: str,
    *,
    batch: int = 1,
    seq: int = 8192,
    n_layers: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
    **overrides,
) -> TransformerConfig:
    """Build the named model's config. `n_layers` defaults to 1 (one
    decoder block); pass the real depth for full-model runs. Extra keyword
    arguments override any config field."""
    if name in _MOE or name.split(":")[0] in _MOE:
        raise NotImplementedError(
            f"preset {name!r} is a mixture of experts: the grouped-GEMM "
            f"kernels it needs are not ported yet (ROADMAP A11)"
        )
    if name not in _DENSE:
        raise KeyError(f"unknown preset {name!r}; have {PRESETS}")
    h, f, q, kv, d, vocab = _DENSE[name]
    return TransformerConfig(
        vocab=vocab, hidden=h, ffn=f, n_layers=n_layers or 1,
        n_q_heads=q, n_kv_heads=kv, head_dim=d, batch=batch, seq=seq,
        dtype=dtype, **overrides,
    )

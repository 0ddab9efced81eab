"""The dense, MoE and expert-parallel MoE decoders, their presets, training step, the
serving-side decode and the prefix cache (≙ ``triton_dist_tpu/models``).
The model and training entry points and the prefix cache's configuration
are re-exported here; import ``decode``, ``prefix_cache`` and ``presets``
directly for the rest."""

from triton_dist_tpu_torch.models.prefix_cache import PrefixCacheConfig  # noqa: F401
from triton_dist_tpu_torch.models.tp_transformer import (  # noqa: F401
    EPMoETransformer,
    EPMoETransformerConfig,
    MoETransformerConfig,
    TPMoETransformer,
    TPTransformer,
    TransformerConfig,
    ep_moe_apply,
    init_moe_params,
    init_params,
    params_from_numpy,
    quantize_moe_serving_params,
    shard_params,
    specs_for,
    train_step,
)

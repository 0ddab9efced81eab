"""The dense and MoE decoders, their presets, training step and the
serving-side decode (≙ ``triton_dist_tpu/models``). The model and training
entry points are re-exported here; import ``decode`` and ``presets``
directly."""

from triton_dist_tpu_torch.models.tp_transformer import (  # noqa: F401
    MoETransformerConfig,
    TPMoETransformer,
    TPTransformer,
    TransformerConfig,
    init_moe_params,
    init_params,
    params_from_numpy,
    shard_params,
    specs_for,
    train_step,
)

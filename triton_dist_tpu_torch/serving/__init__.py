"""The serving subsystem (≙ ``triton_dist_tpu/serving``): the engine core
(``engine``), its metrics (``metrics``) and seeded replayable traffic
(``traffic``). The engine's entry points, the prefix cache's configuration
and the shared-prefix workload are re-exported here::

    ServingEngine(cfg, params, s_max=..., page_size=16, prefill=True,
                  serving=ServingConfig(prefix_cache=PrefixCacheConfig(),
                                        prefill_chunk_tokens=256))
"""

from triton_dist_tpu_torch.models.prefix_cache import PrefixCacheConfig  # noqa: F401
from triton_dist_tpu_torch.serving.engine import ServingConfig, ServingEngine  # noqa: F401
from triton_dist_tpu_torch.serving.traffic import shared_prefix_mix  # noqa: F401

"""The serving subsystem (≙ ``triton_dist_tpu/serving``): the engine core
(``engine``), its metrics (``metrics``) and seeded replayable traffic
(``traffic``). Import the submodules directly."""

"""The dense decoder, its presets, and the serving-side decode (≙
``triton_dist_tpu/models``). Import the submodules directly."""

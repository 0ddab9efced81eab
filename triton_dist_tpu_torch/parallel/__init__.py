"""The rank runtime and its topology (≙ ``triton_dist_tpu/parallel``).
Import the submodules directly."""

"""Resilience tier (≙ ``triton_dist_tpu/resilience``): only the injectable
clock is ported so far (``retry.py``)."""

"""Resilience tier (≙ ``triton_dist_tpu/resilience``): the injectable
clock (``retry.py``) and the bounded device waits of the distributed
kernels — wait-site numbering (``sites.py``), diagnostic records
(``records.py``) and the host check that raises with them
(``watchdog.py``)."""

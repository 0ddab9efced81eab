"""PyTorch/CUDA port of ``triton_dist_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and public layouts (``x @ W`` weights ``[K, N]``,
group-major ``wqkv``, the ``[L, b, h_kv, s_max, d]`` contiguous cache and
the ``[L, n_pages, h_kv, page, d]`` page pool), so a reader finds each
function where the JAX package has it and the tests hold the two against
each other on the same numpy inputs.

Every Pallas kernel on the served path is a hand-written CUDA kernel for
``sm_90a`` (``csrc/``), compiled with ``nvcc`` at first use and bound with
``ctypes`` (``_build.py``). Each kernel wrapper keeps its plain PyTorch
twin beside it: the wrapper runs the twin for tensors on the CPU (the
tests) and launches the kernel, or raises, for tensors on the card.

Entry points (``ContinuousBatcher``, ``ServingEngine``, ``init_params``,
``generate``) run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

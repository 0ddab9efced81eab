"""Test harness: 8 virtual CPU devices + TPU interpreter for all Pallas
kernels (SURVEY.md §4 — this is where we exceed the reference, which can
only test on real multi-GPU hardware).

NOTE: on hosts with very few CPU cores, XLA:CPU's host thread pool can
deadlock when many interpreted remote DMAs move large payloads concurrently
(observed threshold ~16 KiB/chunk in 8-device ring kernels on a 1-core
box). Keep per-DMA test payloads <= ~8 KiB; correctness coverage does not
need more, and real-TPU runs are unaffected.

Runtime budget (1-core box, re-measured 2026-08-01): the `-m quick` tier
is the fast gate (~8 min at 164 tests — it grows with kernel-family
coverage; the whole-loop speculative integration tests moved to the
slow tier when the r5 device-side while_loop rewrite tripled their
interpret-mode cost); the full suite is ~65 min (test_decode ~14 min
and test_models ~9 min dominate). The floor is
structural, not shape-driven: every interpreted pallas_call pays ~44 ms
of host machinery (≈112 io_callbacks + the per-call shared-memory
setup/cleanup barriers across virtual devices — profiled against
jax 0.9 interpret_pallas_call), and a model-level train-step test runs
hundreds of such calls plus a ~35 s trace+XLA-compile of its fwd+bwd
shard_map program that no persistent cache can hold (callback-bearing
executables are not cacheable). Model tests therefore use the smallest
layer count that still covers their property, and serving programs are
shared across tests via the keyed `jit_shard_map` cache."""

import os
import signal

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (the PyTorch port's CUDA kernels have no CPU mode); skips without one")
    config.addinivalue_line(
        "markers",
        "slow: second-tier tests (models, tutorials, large shapes, "
        "multi-process) — excluded from the fast `-m quick` CI tier",
    )
    config.addinivalue_line(
        "markers",
        "quick: first-tier kernel-family coverage; `pytest -m quick` is "
        "the fast gate (~8 min on a 1-core box)",
    )
    config.addinivalue_line(
        "markers",
        "chaos: resilience-layer fault injection (tests/test_chaos.py). "
        "Fast interpret-mode cases ride tier-1 automatically; the full "
        "drop/dup/delay/straggler × kernel-family matrix is additionally "
        "marked slow — run it standalone via scripts/chaos_matrix.sh",
    )
    config.addinivalue_line(
        "markers",
        "soak: long seeded multi-fault chaos campaigns "
        "(tests/test_overload.py / resilience/soak.py, ISSUE 11). "
        "Automatically wired slow so tier-1 stays fast; run via "
        "scripts/chaos_soak.py or `pytest -m soak`",
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        # soak implies slow (ISSUE 11): the campaign tier never rides the
        # fast gate, and forgetting the second marker can't break that
        if "soak" in item.keywords and "slow" not in item.keywords:
            item.add_marker(pytest.mark.slow)
        # quick == everything not explicitly marked slow, so the quick
        # tier can't silently lose new tests
        if "slow" not in item.keywords and "soak" not in item.keywords:
            item.add_marker(pytest.mark.quick)


def _cell_alarm(item, phase):
    """Per-cell wall-clock budget (ISSUE 11 satellite): with
    ``TDT_CELL_TIMEOUT_S`` set (scripts/chaos_matrix.sh exports it), a
    SIGALRM fires a TimeoutError inside the hung cell, so it reports as
    one named FAILED/ERROR row instead of stalling the whole matrix.
    Armed around ALL THREE phases (setup / call / teardown — a fixture
    can hang just as hard as a test body). Signal delivery needs the
    main thread + a Python bytecode boundary — true for every
    interpret-mode cell here; a cell wedged inside a C call fails at its
    next return to Python."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        budget = float(os.environ.get("TDT_CELL_TIMEOUT_S", "0") or 0)
        if budget <= 0 or not hasattr(signal, "SIGALRM"):
            yield
            return

        def _alarm(signum, frame):
            raise TimeoutError(
                f"cell {phase} exceeded TDT_CELL_TIMEOUT_S={budget:g}s: "
                f"{item.nodeid}"
            )

        old = signal.signal(signal.SIGALRM, _alarm)
        signal.setitimer(signal.ITIMER_REAL, budget)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    return scope()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _cell_alarm(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _cell_alarm(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _cell_alarm(item, "teardown"):
        yield


@pytest.fixture(scope="session", autouse=True)
def _interpret_mode():
    from triton_dist_tpu import config

    config.update(interpret=True)
    yield


@pytest.fixture(autouse=True)
def _resilience_isolation():
    """The resilience health registry is process-global: a watchdog
    quarantine or downgrade recorded by one test would pin later tests'
    op entries to the golden path, silently changing what they cover.
    Reset around every test — keeping only the environment pins (whether
    this jax install can build fused kernels doesn't change per test, and
    re-paying the failing trace hundreds of times would)."""
    from triton_dist_tpu import resilience
    from triton_dist_tpu.obs import alerts, blackbox, metrics

    def _flight_recorder_reset():
        # the ISSUE 15 flight-recorder registries are process-global like
        # the health registry: series/alerts/bundle census recorded by an
        # armed test must not leak into the next one (the tracer ring and
        # telemetry aggregation stay: test_obs manages those explicitly)
        metrics.reset()
        alerts.reset()
        blackbox.reset()

    resilience.reset(keep_env=True)
    _flight_recorder_reset()
    yield
    resilience.reset(keep_env=True)
    _flight_recorder_reset()


@pytest.fixture(scope="session")
def mesh8() -> Mesh:
    return Mesh(np.array(jax.devices()), ("tp",))


@pytest.fixture(scope="session")
def mesh2x4() -> Mesh:
    return Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "tp"))


@pytest.fixture(scope="session")
def mesh4() -> Mesh:
    return Mesh(np.array(jax.devices()[:4]), ("tp",))


@pytest.fixture(scope="session")
def mesh2x2x2() -> Mesh:
    return Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("a", "b", "c"))

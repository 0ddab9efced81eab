"""Seeded, replayable synthetic workloads for the serving engine (a copy of
``triton_dist_tpu/serving/traffic.py``: the same spec gives the same trace
and the same ``trace_fingerprint`` in both packages).

A :class:`TrafficSpec` describes an arrival process (Poisson or
deterministic-interval), prompt/output length distributions, and sampling
parameters; :func:`generate_trace` expands it into a tuple of
:class:`Arrival` (time-sorted ``(t_s, Request)`` pairs). Everything is
derived from one ``numpy`` PRNG seeded by ``spec.seed``, so the same spec
produces a byte-identical trace — :func:`trace_fingerprint` hashes the
full trace and tests pin the replay guarantee on it.

Length distributions are small tagged tuples (JSON-able, hashable):

- ``("fixed", n)``
- ``("uniform", lo, hi)``          — inclusive integer range
- ``("mix", ((w, lo, hi), ...))``  — weighted mixture of uniform ranges

:func:`preset_mix` derives a multi-tenant-looking mixture from a
``models/presets.py`` shape: the preset supplies the vocabulary and its
context length sets the scale, clamped into the serving cache budget
(``s_max``) so every generated request is admissible by construction.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from triton_dist_tpu_torch.models.decode import Request

PROCESSES = ("poisson", "deterministic", "burst")
# the overload controller's priority classes, best first
PRIORITIES = ("interactive", "batch")


def sample_length(dist: tuple, rng: np.random.Generator) -> int:
    """Draw one integer length from a tagged length distribution."""
    kind = dist[0]
    if kind == "fixed":
        return int(dist[1])
    if kind == "uniform":
        lo, hi = int(dist[1]), int(dist[2])
        return int(rng.integers(lo, hi + 1))
    if kind == "mix":
        arms = dist[1]
        w = np.array([a[0] for a in arms], np.float64)
        arm = arms[int(rng.choice(len(arms), p=w / w.sum()))]
        return int(rng.integers(int(arm[1]), int(arm[2]) + 1))
    raise ValueError(f"unknown length distribution {dist!r}")


def _validate_dist(name: str, dist: tuple) -> None:
    try:
        kind = dist[0]
        if kind == "fixed":
            ok = int(dist[1]) >= 1
        elif kind == "uniform":
            ok = 1 <= int(dist[1]) <= int(dist[2])
        elif kind == "mix":
            ok = len(dist[1]) >= 1 and all(
                float(w) > 0 and 1 <= int(lo) <= int(hi)
                for (w, lo, hi) in dist[1]
            )
        else:
            ok = False
    except (TypeError, IndexError, ValueError):
        ok = False
    if not ok:
        raise ValueError(
            f"{name} must be ('fixed', n), ('uniform', lo, hi) or "
            f"('mix', ((w, lo, hi), ...)) with positive sane values; "
            f"got {dist!r}"
        )


def max_length(dist: tuple) -> int:
    """The largest value a length distribution can produce (admissibility
    checks: prompt_max + output_max must fit the cache)."""
    kind = dist[0]
    if kind == "fixed":
        return int(dist[1])
    if kind == "uniform":
        return int(dist[2])
    return max(int(hi) for (_, _, hi) in dist[1])


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: ``t_s`` is the offered arrival time on the
    engine's (injectable) clock. ``priority``/``deadline_ms``
    feed the overload controller — the defaults make every pre-overload
    construction site and trace byte-identical."""

    t_s: float
    request: Request
    priority: str = "interactive"
    deadline_ms: int | None = None
    # client_id: the sticky-client label fleet-affinity
    # campaigns group by — None (the default) keeps every pre-fleet
    # construction site and trace byte-identical
    client_id: str | None = None


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """A replayable workload description (see module docstring).

    ``rate_rps`` is the offered load λ (mean arrivals/second); under
    ``process="deterministic"`` arrivals land exactly ``1/λ`` apart.
    ``process="burst"`` is the flash-crowd shape: crowds of
    ``burst_n`` arrivals start every ``burst_every_s`` seconds (default
    ``burst_n / rate_rps``, so the MEAN offered load stays λ and a
    λ-sweep over burst traffic sweeps what it claims to), Poisson-spaced
    *within* a crowd at ``burst_rate_rps`` (default 10·λ) — the offered
    load slams the queue in spikes the mean rate alone never shows. Per-request sampling seeds are derived from ``seed`` and the
    request index, so a request's tokens are reproducible independently
    of the trace position it was drawn at.

    ``priority_mix`` (pairs of ``(weight, class)`` over
    ``PRIORITIES``) and ``deadline_ms`` (a tagged
    integer distribution like the length dists) stamp the overload fields
    onto each arrival. Both default to None, and their draws come from a
    SEPARATE seed-derived PRNG — a spec that leaves them unset generates
    the byte-identical trace (same times, prompts, fingerprint) it did
    before they existed, and setting them changes neither arrival times
    nor prompts.

    ``prefix_pool`` is the shared-prefix workload: N
    seed-derived "system prompts" (lengths from ``prefix_len``) are drawn
    once, and each request independently — with probability
    ``prefix_share`` — prepends one of them, Zipf-weighted by
    ``prefix_zipf`` (rank k gets weight ∝ 1/k^zipf: a handful of hot
    prompts dominate, the production shape the prefix cache exists for).
    All prefix draws come from their OWN seed-derived PRNG stream (the
    priority/deadline discipline): an unchanged spec keeps
    its historical ``trace_fingerprint``, and setting the prefix fields
    changes neither arrival times nor the per-request SUFFIX (the old
    prompt becomes the suffix).

    ``client_pool`` stamps a sticky ``client_id`` onto each
    arrival: N client labels, Zipf-weighted by ``client_zipf`` (a
    handful of hot clients dominate — the production shape
    fleet-affinity routing exists for). The draws come from their OWN
    seed-derived PRNG stream (the priority/deadline discipline): an
    unchanged spec keeps its historical fingerprint, and setting the
    client fields changes neither arrival times nor prompts.

    ``long_prompt_frac`` / ``long_prompt_len`` inject the
    heavy-tail prompt mix chunked prefill exists for: each request is
    independently long with probability ``long_prompt_frac``, and a long
    request's BASE prompt (before any ``prefix_pool`` prepend) is
    replaced by one drawn from ``long_prompt_len``. All long-prompt
    draws come from their OWN seed-derived PRNG stream and the main
    stream's draws are still consumed, so: an unset spec keeps its
    historical ``trace_fingerprint`` byte-identically, and an armed
    spec's NON-long requests keep the exact arrival times and prompts
    they had unarmed (only the replaced prompts differ)."""

    rate_rps: float
    n_requests: int
    process: str = "poisson"
    prompt_len: tuple = ("fixed", 8)
    output_len: tuple = ("fixed", 16)
    vocab: int = 256
    temperature: float = 0.0
    top_k: int | None = None
    eos_id: int | None = None
    seed: int = 0
    start_s: float = 0.0
    uid_prefix: str = "req"
    burst_every_s: float | None = None
    burst_n: int = 8
    burst_rate_rps: float | None = None
    priority_mix: tuple | None = None
    deadline_ms: tuple | None = None
    prefix_pool: int | None = None
    prefix_len: tuple = ("fixed", 8)
    prefix_zipf: float = 1.2
    prefix_share: float = 1.0
    client_pool: int | None = None
    client_zipf: float = 1.2
    long_prompt_frac: float | None = None
    long_prompt_len: tuple | None = None

    def validate(self) -> "TrafficSpec":
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.process not in PROCESSES:
            raise ValueError(
                f"process must be one of {PROCESSES}, got {self.process!r}"
            )
        if self.vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {self.vocab}")
        _validate_dist("prompt_len", self.prompt_len)
        _validate_dist("output_len", self.output_len)
        if self.process == "burst":
            if self.burst_every_s is not None and self.burst_every_s <= 0:
                raise ValueError(
                    f"burst_every_s must be > 0, got {self.burst_every_s}"
                )
            if self.burst_n < 1:
                raise ValueError(f"burst_n must be >= 1, got {self.burst_n}")
            if self.burst_rate_rps is not None and self.burst_rate_rps <= 0:
                raise ValueError(
                    f"burst_rate_rps must be > 0, got {self.burst_rate_rps}"
                )
        if self.priority_mix is not None:
            if not self.priority_mix or not all(
                len(arm) == 2 and float(arm[0]) > 0 for arm in self.priority_mix
            ):
                raise ValueError(
                    f"priority_mix must be ((weight, class), ...) with "
                    f"positive weights, got {self.priority_mix!r}"
                )
            for _, cls in self.priority_mix:
                if cls not in PRIORITIES:  # loud on unknown classes
                    raise ValueError(
                        f"unknown priority {cls!r}; expected one of {PRIORITIES}"
                    )
        if self.deadline_ms is not None:
            _validate_dist("deadline_ms", self.deadline_ms)
        if self.prefix_pool is not None:
            if self.prefix_pool < 1:
                raise ValueError(
                    f"prefix_pool must be >= 1, got {self.prefix_pool}"
                )
            _validate_dist("prefix_len", self.prefix_len)
            if not 0.0 < self.prefix_share <= 1.0:
                raise ValueError(
                    f"prefix_share must be in (0, 1], got {self.prefix_share}"
                )
            if self.prefix_zipf <= 0:
                raise ValueError(
                    f"prefix_zipf must be > 0, got {self.prefix_zipf}"
                )
        if self.client_pool is not None:
            if self.client_pool < 1:
                raise ValueError(
                    f"client_pool must be >= 1, got {self.client_pool}"
                )
            if self.client_zipf <= 0:
                raise ValueError(
                    f"client_zipf must be > 0, got {self.client_zipf}"
                )
        if self.long_prompt_frac is not None:
            if not 0.0 < self.long_prompt_frac <= 1.0:
                raise ValueError(
                    f"long_prompt_frac must be in (0, 1], got "
                    f"{self.long_prompt_frac}"
                )
            if self.long_prompt_len is None:
                raise ValueError(
                    "long_prompt_frac needs long_prompt_len (the tagged "
                    "length distribution long prompts draw from)"
                )
            _validate_dist("long_prompt_len", self.long_prompt_len)
        elif self.long_prompt_len is not None:
            raise ValueError(
                "long_prompt_len needs long_prompt_frac to arm it"
            )
        return self


def generate_trace(spec: TrafficSpec) -> tuple[Arrival, ...]:
    """Expand a spec into its (time-sorted) arrival trace. Same spec ⇒
    byte-identical trace (one PRNG, fixed draw order; the overload fields
    draw from a second seed-derived PRNG so setting them perturbs neither
    arrival times nor prompts — fingerprint-stable for unchanged specs)."""
    spec.validate()
    rng = np.random.default_rng(spec.seed)
    # overload draws (priority / deadline) on their own stream: draw-order
    # isolation from the times/lengths/prompts above
    rng_ov = np.random.default_rng([int(spec.seed), 0x0F10AD])
    prio_arms = None
    if spec.priority_mix is not None:
        w = np.array([float(a[0]) for a in spec.priority_mix], np.float64)
        prio_arms = ([a[1] for a in spec.priority_mix], w / w.sum())
    # shared-prefix draws on a THIRD stream: the system-prompt
    # pool plus each request's (share?, which-prefix) pair — unset specs
    # never touch it, so their historical fingerprints hold
    rng_px = np.random.default_rng([int(spec.seed), 0x90EF1C])
    prefixes = zipf_w = None
    if spec.prefix_pool is not None:
        prefixes = [
            [int(x) for x in rng_px.integers(
                0, spec.vocab, sample_length(spec.prefix_len, rng_px)
            )]
            for _ in range(spec.prefix_pool)
        ]
        zipf_w = 1.0 / np.arange(
            1, spec.prefix_pool + 1, dtype=np.float64
        ) ** float(spec.prefix_zipf)
        zipf_w /= zipf_w.sum()
    # sticky-client draws on a FOURTH stream: one Zipf draw
    # per request when armed — unset specs never touch it, so their
    # historical fingerprints hold
    rng_cl = np.random.default_rng([int(spec.seed), 0xC11E27])
    client_w = None
    if spec.client_pool is not None:
        client_w = 1.0 / np.arange(
            1, spec.client_pool + 1, dtype=np.float64
        ) ** float(spec.client_zipf)
        client_w /= client_w.sum()
    # long-prompt draws on a FIFTH stream: each request's
    # (long?, length, tokens) triple when armed — unset specs never touch
    # it, so their historical fingerprints hold
    rng_lp = np.random.default_rng([int(spec.seed), 0x10BF6C])
    out = []
    t = float(spec.start_s)
    burst_rate = spec.burst_rate_rps or 10.0 * spec.rate_rps
    # default crowd period keeps the MEAN offered rate at λ (docstring)
    burst_every = (
        spec.burst_every_s if spec.burst_every_s is not None
        else spec.burst_n / spec.rate_rps
    )
    for i in range(spec.n_requests):
        if spec.process == "poisson":
            t += float(rng.exponential(1.0 / spec.rate_rps))
        elif spec.process == "burst":
            # flash crowd k holds arrivals [k*burst_n, (k+1)*burst_n) and
            # opens at start_s + k*burst_every_s; within a crowd the
            # inter-arrival gaps are Poisson at the (much higher) burst
            # rate
            if i % spec.burst_n == 0:
                t = float(spec.start_s) + (i // spec.burst_n) * burst_every
            t += float(rng.exponential(1.0 / burst_rate))
        else:
            t += 1.0 / spec.rate_rps
        p_len = sample_length(spec.prompt_len, rng)
        o_len = sample_length(spec.output_len, rng)
        prompt = [int(x) for x in rng.integers(0, spec.vocab, p_len)]
        if spec.long_prompt_frac is not None:
            # fixed two-draw cadence (the overload-stream discipline);
            # the main stream's p_len/prompt draws above were still
            # consumed, so NON-long requests are byte-identical to the
            # unarmed spec's. The replacement happens BEFORE any prefix
            # prepend: a long request can still share a system prompt.
            is_long = float(rng_lp.random()) < spec.long_prompt_frac
            lp_len = sample_length(spec.long_prompt_len, rng_lp)
            if is_long:
                prompt = [int(x) for x in rng_lp.integers(
                    0, spec.vocab, lp_len
                )]
        if prefixes is not None:
            # fixed two-draw cadence per request keeps the stream aligned
            # whatever the outcomes
            share = float(rng_px.random()) < spec.prefix_share
            which = int(rng_px.choice(spec.prefix_pool, p=zipf_w))
            if share:
                prompt = prefixes[which] + prompt
        priority = "interactive"
        if prio_arms is not None:
            priority = prio_arms[0][int(rng_ov.choice(
                len(prio_arms[0]), p=prio_arms[1]
            ))]
        deadline = (
            sample_length(spec.deadline_ms, rng_ov)
            if spec.deadline_ms is not None else None
        )
        client = None
        if client_w is not None:
            client = f"c{int(rng_cl.choice(spec.client_pool, p=client_w))}"
        out.append(Arrival(
            t_s=t,
            request=Request(
                prompt=prompt,
                max_new_tokens=o_len,
                eos_id=spec.eos_id,
                temperature=spec.temperature,
                top_k=spec.top_k,
                # derived per-request seed: reproducible independent of
                # neighbors (the documented sampling guarantee)
                seed=int(spec.seed) * 1_000_003 + i,
                uid=f"{spec.uid_prefix}{i}",
            ),
            priority=priority,
            deadline_ms=deadline,
            client_id=client,
        ))
    return tuple(sorted(out, key=lambda a: a.t_s))


def trace_fingerprint(trace: tuple[Arrival, ...]) -> str:
    """Stable content hash of a trace — the byte-identical-replay pin.
    The overload fields (priority / deadline_ms) enter the hash only when
    set away from their defaults, so every pre-overload spec keeps its
    historical fingerprint."""
    h = hashlib.sha256()
    for a in trace:
        extra = ()
        if a.priority != "interactive" or a.deadline_ms is not None:
            extra = (a.priority, a.deadline_ms)
        if a.client_id is not None:
            # the client label joins the hash only when set —
            # every pre-fleet spec keeps its historical fingerprint
            extra = extra + (a.client_id,)
        h.update(repr((
            round(a.t_s, 12), a.request.prompt, a.request.max_new_tokens,
            a.request.eos_id, a.request.temperature, a.request.top_k,
            a.request.seed, a.request.uid, *extra,
        )).encode())
    return h.hexdigest()


def preset_mix(
    name: str,
    *,
    s_max: int,
    rate_rps: float,
    n_requests: int,
    seed: int = 0,
    vocab: int | None = None,
    **overrides: Any,
) -> TrafficSpec:
    """A multi-tenant length mixture derived from a ``models/presets.py``
    shape: short-chat / medium / long-document prompt arms scaled off the
    preset's context length and clamped into ``s_max`` so the worst-case
    ``prompt + output`` always fits the serving cache. The preset supplies
    the vocabulary (override for shrunk test/serving configs whose logit
    head is smaller than the open-weight model's)."""
    from triton_dist_tpu_torch.models import presets

    cfg = presets.preset(name)
    if s_max < 8:
        raise ValueError(f"preset_mix needs s_max >= 8, got {s_max}")
    # preset seq sets the aspiration; s_max is the budget actually served
    scale = min(int(cfg.seq), int(s_max))
    short_hi = max(2, scale // 32)
    med_hi = max(short_hi + 1, scale // 8)
    long_hi = max(med_hi + 1, scale // 2)
    prompt = ("mix", (
        (0.6, 2, short_hi),
        (0.3, min(short_hi + 1, med_hi), med_hi),
        (0.1, min(med_hi + 1, long_hi), long_hi),
    ))
    out_hi = max(1, min(scale // 4, s_max - max_length(prompt)))
    output = ("uniform", 1, out_hi)
    return TrafficSpec(
        rate_rps=rate_rps,
        n_requests=n_requests,
        prompt_len=prompt,
        output_len=output,
        vocab=int(vocab if vocab is not None else cfg.vocab),
        seed=seed,
        **overrides,
    ).validate()

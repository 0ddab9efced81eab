"""Optimizer transforms for ``train_step(opt=, opt_state=)``: the port's twins
of the optax transforms the JAX package's training accepts (its tests train
with ``optax.adam`` and ``optax.sgd``; ``models/tp_transformer.py:547-660``
applies any optax transform). The card's machine has no optax, so this
module carries the two, not a new feature: the same update order, bias
correction, defaults and state (structure and dtypes) as optax 0.2.6's
``adam`` (``chain(scale_by_adam, scale(-lr))``) and ``sgd`` (``chain(trace
or identity, scale(-lr))``).

A transform is ``init(params) -> state`` and ``update(updates, state,
params=None) -> (updates, state)`` over a parameter tree (dicts and lists
of tensors), and :func:`apply_updates` adds the updates to the parameters
in each parameter's dtype. Each update runs leaf by leaf in one pass (the
same operations in the same order as the chain, so the same bits): no tree
of bias-corrected moments or unscaled updates is ever held whole, which is
what a full-width model's memory has room for. A leaf whose update is
``None`` (a quantized serving pool, which takes no gradient) keeps its
state and its value. :func:`opt_state_specs` gives the state's per-rank
split (≙ ``opt_state_specs``, ``:520``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    """≙ ``optax.GradientTransformation``."""

    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    """≙ ``optax.EmptyState``: a stateless transform's state."""


class ScaleByAdamState(NamedTuple):
    """≙ ``optax.ScaleByAdamState``: the step count (int32) and the first
    and second moments, trees of the parameters' shapes."""

    count: torch.Tensor
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    """≙ ``optax.TraceState``: the momentum buffer."""

    trace: Any


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of a tree of dicts, lists, tuples and named
    tuples (``None`` a leaf); `rest` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def _trainable(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point() and p.element_size() > 1


def _zeros_like(params):
    """Zero moments for every trainable leaf (``None`` for a one-byte
    pool): optax's ``tree.zeros_like`` in the parameter's dtype."""
    return tree_map(lambda p: torch.zeros_like(p) if _trainable(p) else None, params)


class _Parts:
    """A leaf's several results, unzipped into trees by :func:`_unzip`."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = parts


def _map_live(fn, *trees):
    """`fn` over the leaves where the first tree's leaf is not None."""
    return tree_map(lambda x, *r: None if x is None else fn(x, *r), *trees)


def _unzip(tree, n: int):
    return tuple(tree_map(lambda x, i=i: None if x is None else x.parts[i], tree)
                 for i in range(n))


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, held at the int32 maximum (≙ ``safe_increment``)."""
    return torch.where(count < torch.iinfo(count.dtype).max, count + 1, count)


def _correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count`` in f32 (≙ ``tree.bias_correction``'s
    denominator, cast to each moment's dtype before the division)."""
    return 1 - torch.tensor(decay, dtype=torch.float32, device=count.device) ** count


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """≙ ``optax.adam``: the moments' running averages, their bias
    correction, ``m / (sqrt(v) + eps)`` scaled by ``-learning_rate``; the
    state ``(ScaleByAdamState, EmptyState)``. A constant rate only (the JAX
    package's tests pass one)."""

    def init(params):
        dev = next((p.device for p in _leaves(params)), None)
        return (ScaleByAdamState(torch.zeros((), dtype=torch.int32, device=dev),
                                 _zeros_like(params), _zeros_like(params)),
                EmptyState())

    def update(updates, state, params=None):
        del params
        adam_state, empty = state
        count = _safe_increment(adam_state.count)
        c1, c2 = _correction(b1, count), _correction(b2, count)

        def leaf(g, m, v):
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * (g * g) + b2 * v
            m_hat = m / c1.to(m.dtype)
            out = -learning_rate * (m_hat / (torch.sqrt(v / c2.to(v.dtype)) + eps))
            return _Parts(out, m, v)

        out, mu, nu = _unzip(_map_live(leaf, updates, adam_state.mu, adam_state.nu), 3)
        return out, (ScaleByAdamState(count, mu, nu), empty)

    return GradientTransformation(init, update)


def sgd(learning_rate: float, momentum: float | None = None):
    """≙ ``optax.sgd``: with `momentum` the trace ``t = g + momentum * t``,
    which is the update, scaled by ``-learning_rate``; the state
    ``(TraceState or EmptyState, EmptyState)``."""

    def init(params):
        first = EmptyState() if momentum is None else TraceState(_zeros_like(params))
        return first, EmptyState()

    def update(updates, state, params=None):
        del params
        first, empty = state
        if momentum is None:
            return _map_live(lambda g: -learning_rate * g, updates), state

        def leaf(g, t):
            t = g + momentum * t
            return _Parts(-learning_rate * t, t)

        out, trace = _unzip(_map_live(leaf, updates, first.trace), 2)
        return out, (TraceState(trace), empty)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """≙ ``optax.apply_updates``: ``p + u`` in each parameter's dtype; a
    leaf without an update is returned as it is."""
    return tree_map(lambda p, u: p if u is None else (p + u).to(p.dtype), params, updates)


def _leaves(tree) -> list:
    out = []
    tree_map(lambda x: x is None or out.append(x), tree)
    return out


def _structure(tree):
    """A tree's structure with its leaves' shapes."""
    return tree_map(lambda x: None if x is None else tuple(x.shape), tree)


def opt_state_specs(opt: GradientTransformation, params, specs):
    """The optimizer state's per-rank split (≙ ``opt_state_specs``): every
    subtree that mirrors the parameter tree (Adam's moments, the momentum
    trace) takes `specs` (the parameters' split, as
    ``models.tp_transformer.specs_for`` gives it); every other leaf (step
    counts) is replicated, ``None``."""
    target = _structure(_zeros_like(params))

    def expand(x):
        if isinstance(x, (dict, list)) and _structure(x) == target:
            return specs
        if isinstance(x, tuple):
            items = [expand(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return None

    return expand(opt.init(params))

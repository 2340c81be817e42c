"""Gradient transformations: the port's counterpart of the optax pieces the JAX training
path uses (``optax.adamw``, ``optax.sgd``, ``optax.apply_updates``).

A transformation has ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)`` over param trees (``utils/tree.py``); ``apply_updates`` adds the
updates. The arithmetic keeps optax's expression order so fp32 trajectories agree with
the JAX package's to the last bits:

- moments: ``(1 - b1) * g + b1 * m`` and ``(1 - b2) * g**2 + b2 * v``, where a Python
  scalar multiplies an array after rounding to the array's type (JAX's weak typing:
  with a bf16 first moment, ``b1 * m`` is bf16(0.9) times m, rounded to bf16);
- bias correction by division, ``m / (1 - b1**t)``, with ``t`` counted from 1;
- decoupled weight decay ``u + wd * p``, then ``-lr * u``; ``p + u`` in p's type.

``learning_rate`` is a float or a schedule called on the step count (0-based), as an
optax schedule is. Counts are Python ints held on the host.

``multi_transform`` routes each labelled group of leaves to its own transformation and
``set_to_zero`` freezes a group (``models/lora.lora_optimizer`` builds the pair), with
optax's semantics: labels by tree path, each inner transformation sees the tree with the
other groups' leaves left out (None here, optax's ``MaskedNode``), and a
``set_to_zero`` group keeps no state. A frozen leaf whose gradient is None (the train
step takes none for it: ``frozen_leaves``) gets a None update, so no tensor of its size
is made.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .utils.tree import tree_leaves, tree_map

__all__ = ["AdamState", "SgdState", "EmptyState", "MultiTransformState",
           "GradientTransformation", "adamw", "sgd", "set_to_zero", "multi_transform",
           "apply_updates", "scale_by", "bias_correction"]


class AdamState(NamedTuple):
    """AdamW state (``optax.ScaleByAdamState``): steps taken and the two moment trees."""

    count: int
    mu: Any
    nu: Any


class SgdState(NamedTuple):
    count: int
    trace: Any = None


class EmptyState(NamedTuple):
    """The state of a stateless transformation (no leaves)."""


class MultiTransformState(NamedTuple):
    """``{label: inner state}`` of :func:`multi_transform`."""

    inner_states: dict


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def scale_by(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c * x`` with the Python scalar ``c`` first rounded to x's type, as JAX rounds a
    weakly typed scalar (identical to ``c * x`` for fp32 x)."""
    return x * float(torch.tensor(c, dtype=x.dtype))


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in fp32."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _lr(learning_rate, count: int) -> float:
    return float(learning_rate(count) if callable(learning_rate) else learning_rate)


def adamw(learning_rate: Union[float, Callable[[int], float]], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """AdamW with decoupled weight decay (``optax.adamw``'s defaults and order)."""

    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params)
        nu = tree_map(torch.zeros_like, params)
        return AdamState(count=0, mu=mu, nu=nu)

    def update(grads, state: AdamState, params=None):
        if params is None:
            raise ValueError("adamw.update requires params (AdamW decays weights)")
        count = state.count + 1
        bc1, bc2 = bias_correction(b1, count), bias_correction(b2, count)
        lr = _lr(learning_rate, state.count)

        def one(g, m, v, p):
            m_new = scale_by(1.0 - b1, g) + scale_by(b1, m)
            v_new = scale_by(1.0 - b2, g * g) + scale_by(b2, v)
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2 + eps_root) + eps)
            u = u + scale_by(weight_decay, p)
            return scale_by(-lr, u), m_new.to(m.dtype), v_new

        out = tree_map(one, grads, state.mu, state.nu, params)
        pick = lambda i: tree_map(lambda _, o: o[i], grads, out)  # noqa: E731
        return pick(0), AdamState(count=count, mu=pick(1), nu=pick(2))

    return GradientTransformation(init, update)


def sgd(learning_rate: Union[float, Callable[[int], float]], momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """SGD, optionally with (Nesterov) momentum (``optax.sgd``: ``optax.trace`` then
    ``-lr * u``)."""

    def init(params):
        trace = None if momentum is None else tree_map(torch.zeros_like, params)
        return SgdState(count=0, trace=trace)

    def update(grads, state: SgdState, params=None):
        lr = _lr(learning_rate, state.count)
        trace = state.trace
        if momentum is not None:
            trace = tree_map(lambda g, t: g + scale_by(momentum, t), grads, trace)
            grads = (tree_map(lambda g, t: g + scale_by(momentum, t), grads, trace)
                     if nesterov else trace)
        updates = tree_map(lambda g: scale_by(-lr, g), grads)
        return updates, SgdState(count=state.count + 1, trace=trace)

    return GradientTransformation(init, update)


class _SetToZero:
    """``optax.set_to_zero``: zero updates, no state."""

    def init(self, params):
        return EmptyState()

    def update(self, grads, state, params=None):
        return tree_map(torch.zeros_like, grads), state


def set_to_zero() -> _SetToZero:
    """A transformation whose updates are zeros (freezes the leaves it is given)."""
    return _SetToZero()


class _MultiTransform:
    """``optax.multi_transform``: ``transforms`` ``{label: transformation}``,
    ``param_labels`` a tree of labels shaped like the params or a callable making one."""

    def __init__(self, transforms: dict, param_labels):
        self.transforms = transforms
        self.param_labels = param_labels

    def _labels(self, tree):
        labels = self.param_labels(tree) if callable(self.param_labels) else self.param_labels
        unknown = {lbl for lbl in tree_leaves(labels)} - set(self.transforms)
        if unknown:
            raise ValueError(f"labels {sorted(unknown)} have no transformation")
        return labels

    @staticmethod
    def _masked(tree, labels, group):
        return tree_map(lambda label, x: x if label == group else None, labels, tree)

    def init(self, params):
        labels = self._labels(params)
        return MultiTransformState({g: tx.init(self._masked(params, labels, g))
                                    for g, tx in self.transforms.items()})

    def update(self, grads, state: MultiTransformState, params=None):
        labels = self._labels(params if params is not None else grads)
        inner, group_updates = {}, {}
        for g, tx in self.transforms.items():
            masked_params = None if params is None else self._masked(params, labels, g)
            group_updates[g], inner[g] = tx.update(self._masked(grads, labels, g),
                                                   state.inner_states[g], masked_params)
        groups = list(self.transforms)
        updates = tree_map(lambda label, *us: us[groups.index(label)], labels,
                           *(group_updates[g] for g in groups))
        return updates, MultiTransformState(inner)

    def frozen_leaves(self, params) -> list:
        """Per leaf of ``params`` (``tree_leaves`` order): whether its group's
        transformation is :func:`set_to_zero` (the train step takes no gradient for
        it)."""
        labels = self._labels(params)
        return [isinstance(self.transforms[lbl], _SetToZero) for lbl in tree_leaves(labels)]


def multi_transform(transforms: dict, param_labels) -> _MultiTransform:
    """Each group of leaves (by label) through its own transformation."""
    return _MultiTransform(transforms, param_labels)


def apply_updates(params, updates):
    """``p + u`` in p's type (``optax.apply_updates``); a None update leaves p."""
    return tree_map(lambda p, u: p if u is None else (p + u).to(p.dtype), params, updates)

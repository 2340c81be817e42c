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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .utils.tree import tree_map

__all__ = ["AdamState", "SgdState", "GradientTransformation", "adamw", "sgd",
           "apply_updates", "scale_by", "bias_correction"]


class AdamState(NamedTuple):
    """AdamW state (``optax.ScaleByAdamState``): steps taken and the two moment trees."""

    count: int
    mu: Any
    nu: Any


class SgdState(NamedTuple):
    count: int
    trace: Any = None


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


def apply_updates(params, updates):
    """``p + u`` in p's type (``optax.apply_updates``)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)

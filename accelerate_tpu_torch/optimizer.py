"""Optimizer wrapper (``AcceleratedOptimizer``): the port's counterpart of
``accelerate_tpu/optimizer.py``.

It wraps a gradient transformation (``optim.adamw``, ``ops.fused_optim.FusedAdamW``).
The update runs inside the train step built by ``Accelerator.build_train_step``; this
object owns the transformation and the host-side step counter, and its ``step()`` counts
only sync (apply) steps, so a scheduler downstream agrees with the step.
"""

from __future__ import annotations

from .state import GradientState

__all__ = ["AcceleratedOptimizer"]


class AcceleratedOptimizer:
    """Facade over a gradient transformation: the transformation, the host-side count of
    optimizer steps, and the latest optimizer state."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.gradient_state = GradientState()
        self._step_count = 0
        self._opt_state_ref = None  # set by Accelerator.create_train_state and each apply

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, opt_state, params=None):
        return self.optimizer.update(grads, opt_state, params)

    @property
    def state(self):
        return self._opt_state_ref

    def step(self, closure=None) -> None:
        """Count an optimizer step on sync steps only (the skip during accumulation)."""
        if self.gradient_state.sync_gradients:
            self._step_count += 1

    def state_dict(self):
        return {"step_count": self._step_count}

    def load_state_dict(self, state_dict):
        self._step_count = state_dict.get("step_count", 0)

    def __repr__(self):
        return f"AcceleratedOptimizer({self.optimizer!r}, steps={self._step_count})"

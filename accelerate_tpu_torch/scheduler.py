"""Scheduler wrapper: the port's counterpart of ``accelerate_tpu/scheduler.py``.

A learning-rate schedule that is a function of the step count (``optim.adamw(lr=fn)``)
needs no wrapper: it reads the optimizer's count, which advances only on apply steps.
A stateful scheduler (an object with ``step()``, ``state_dict()`` and
``load_state_dict()``, e.g. torch's) is wrapped by ``AcceleratedScheduler``: it steps
only when the optimizer really stepped, and ``num_processes`` times per step when the
batch grows with the number of processes (``split_batches=False``).
"""

from __future__ import annotations

from .state import GradientState, PartialState

__all__ = ["AcceleratedScheduler"]


class AcceleratedScheduler:
    def __init__(self, scheduler, optimizers, step_with_optimizer: bool = True,
                 split_batches: bool = False):
        self.scheduler = scheduler
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        self.split_batches = split_batches
        self.step_with_optimizer = step_with_optimizer
        self.gradient_state = GradientState()

    def step(self, *args, **kwargs):
        if not self.step_with_optimizer:
            self.scheduler.step(*args, **kwargs)
            return
        if not self.gradient_state.sync_gradients:
            # Keep a torch scheduler's call counter in step with the calls made even when
            # the rate is not updated.
            if self.gradient_state.adjust_scheduler and hasattr(self.scheduler, "_step_count"):
                self.scheduler._step_count += 1
            return
        if any(getattr(opt, "step_was_skipped", False) for opt in self.optimizers):
            return
        n = 1 if self.split_batches else PartialState._shared_state.get("num_processes", 1)
        for _ in range(n):
            self.scheduler.step(*args, **kwargs)

    def get_last_lr(self):
        return self.scheduler.get_last_lr()

    def state_dict(self):
        return self.scheduler.state_dict()

    def load_state_dict(self, state_dict):
        self.scheduler.load_state_dict(state_dict)

    def get_lr(self):
        return self.scheduler.get_lr()

    def __getattr__(self, name):
        return getattr(self.__dict__["scheduler"], name)

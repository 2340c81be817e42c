"""The step-level telemetry pipeline of the port: fenced timing, steady state and
counters → records. The counterpart of ``accelerate_tpu/telemetry/core.py``.

One ``Telemetry`` rides on the ``Accelerator``; when enabled, the train step brackets
every step with ``_step_begin`` / ``_step_end`` and a JSON-serializable record goes to
the JSONL sink (``TelemetryConfig.jsonl_dir``), the bounded history (``records``),
``last_step_record`` and every registered sink. The serving engine, gateway and
routers push their records through :meth:`Telemetry.emit`.

Contract when **disabled** (the default): ``enabled`` is False, no file is opened, and
the hot path performs two attribute reads a step: no record, no clock read, no
synchronization.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional

import torch

from ..utils.tree import tree_leaves
from .compile_monitor import CompileMonitor, compile_label
from .derived import derived_rates
from .memory import device_memory_stats
from .schemas import STEP_RECORD_SCHEMA
from .steady import TELEMETRY_REV, SteadyStateDetector
from .timing import StepTimer

__all__ = ["Telemetry", "STEP_RECORD_SCHEMA", "REQUIRED_STEP_COLUMNS"]

#: Columns every step record carries (derived-rate and memory columns are best-effort:
#: absent when their inputs are unknown).
REQUIRED_STEP_COLUMNS = (
    "schema", "telemetry_rev", "step", "wall_s", "dispatch_s", "fence_s", "steady",
    "warmup_steps_detected", "compiles_total", "compile_s_total", "compiles_delta",
)


def _infer_batch_counts(batch: Any, drop_leading: int = 0
                        ) -> tuple[Optional[int], Optional[int]]:
    """(examples, tokens) per step from the batch's SHAPES, never its values: the
    ``[batch, seq]`` id leaf (``tokens``/``input_ids``) gives tokens, the first leaf's
    leading dim examples; ``drop_leading`` strips stacked dispatch dims first."""
    examples = tokens = None
    if isinstance(batch, dict):
        for key in ("tokens", "input_ids"):
            shape = getattr(batch.get(key), "shape", None)
            if shape is not None and len(shape) >= 2 + drop_leading:
                tokens = int(shape[drop_leading] * shape[drop_leading + 1])
                break
    for leaf in tree_leaves(batch):
        shape = getattr(leaf, "shape", None)
        if shape is not None and len(shape) >= 1 + drop_leading and shape[drop_leading] > 0:
            examples = int(shape[drop_leading])
            break
    return examples, tokens


class Telemetry:
    """The telemetry pieces behind one enable flag. Sinks are ``record -> None``
    callables; :meth:`emit` fans every record out and keeps a bounded history
    (``records``) and ``last_step_record``."""

    def __init__(self, config=None):
        if config is None:
            from ..utils.dataclasses import TelemetryConfig

            config = TelemetryConfig()
        self.config = config
        self.enabled: bool = bool(config.enabled)
        self.records: List[dict] = []
        self.last_step_record: Optional[dict] = None
        self.sinks: List[Callable[[dict], None]] = []
        self.timer = StepTimer()
        self.detector = SteadyStateDetector(k=config.steady_k, rtol=config.steady_rtol,
                                            max_windows=config.steady_cap)
        self.compile_monitor = CompileMonitor()
        self._compile_seen = 0  # totals at the last record, for per-step deltas
        self._compile_seen_s = 0.0
        self._label_ctx = None
        self._jsonl_file = None
        self._jsonl_path = None
        self._step_count = 0
        # Throughput hints: explicit values win over shape inference.
        self.flops_per_step: Optional[float] = config.flops_per_step
        self.tokens_per_step: Optional[float] = config.tokens_per_step
        self.examples_per_step: Optional[float] = config.examples_per_step
        #: The flight recorder: not ported, so always None (the tracer reads it).
        self.recorder = None
        if self.enabled:
            if getattr(config, "recorder", False):
                raise NotImplementedError(
                    "TelemetryConfig.recorder: the flight recorder (telemetry/recorder.py) "
                    "is not ported yet; pass recorder=False")
            if config.compile_events:
                self.compile_monitor.start()
            if config.jsonl_dir:
                os.makedirs(config.jsonl_dir, exist_ok=True)
                self._jsonl_path = os.path.join(config.jsonl_dir, "telemetry.jsonl")
                self._jsonl_file = open(self._jsonl_path, "a")

    def set_throughput_hints(self, flops_per_step: Optional[float] = None,
                             tokens_per_step: Optional[float] = None,
                             examples_per_step: Optional[float] = None) -> None:
        """Static per-step costs for the derived rates (MFU needs ``flops_per_step``)."""
        if flops_per_step is not None:
            self.flops_per_step = flops_per_step
        if tokens_per_step is not None:
            self.tokens_per_step = tokens_per_step
        if examples_per_step is not None:
            self.examples_per_step = examples_per_step

    # ------------------------------------------------------------------ step scope
    def _step_begin(self, label: str = "train_step") -> None:
        """Start the fenced timer and the compile-attribution label (the enabled path
        only: the caller guards with one bool read)."""
        self._label_ctx = compile_label(label)
        self._label_ctx.__enter__()
        self.timer.start()

    def _step_abort(self) -> None:
        """Unwind a step bracket whose body raised: exit the label, drop the timer."""
        if self._label_ctx is not None:
            self._label_ctx.__exit__(None, None, None)
            self._label_ctx = None
        self.timer._t0 = None

    def _step_end(self, fence_on: Any, batch: Any = None, n_steps: int = 1,
                  drop_leading: int = 0) -> dict:
        """Fence, measure, observe steadiness, snapshot counters, emit one record."""
        timing = self.timer.stop(fence_on=fence_on)
        if self._label_ctx is not None:
            self._label_ctx.__exit__(None, None, None)
            self._label_ctx = None
        self._step_count += n_steps
        self.detector.observe(timing.wall_s / max(n_steps, 1))
        mon = self.compile_monitor
        compiles_delta = mon.count - self._compile_seen
        compile_s_delta = mon.seconds - self._compile_seen_s
        self._compile_seen = mon.count
        self._compile_seen_s = mon.seconds
        record = {
            "schema": STEP_RECORD_SCHEMA,
            "telemetry_rev": TELEMETRY_REV,
            "step": self._step_count,
            "wall_s": round(timing.wall_s, 6),
            "dispatch_s": round(timing.dispatch_s, 6),
            "fence_s": round(timing.fence_s, 6),
            "steady": self.detector.steady,
            "warmup_steps_detected": self.detector.warmup_steps_detected,
            "compiles_total": mon.count,
            "compile_s_total": round(mon.seconds, 6),
            "compiles_delta": compiles_delta,
            "compile_s_delta": round(compile_s_delta, 6),
        }
        if self.config.memory_stats:
            mem = device_memory_stats(device_index=self.config.device_index)
            if mem:
                record["memory"] = mem
        examples, tokens = (None, None)
        if batch is not None:
            examples, tokens = _infer_batch_counts(batch, drop_leading=drop_leading)
        tokens_window = (self.tokens_per_step * n_steps if self.tokens_per_step is not None
                         else (tokens * n_steps if tokens is not None else None))
        examples_window = (
            self.examples_per_step * n_steps if self.examples_per_step is not None
            else (examples * n_steps if examples is not None else None))
        rates = derived_rates(
            timing.wall_s, tokens_per_step=tokens_window, examples_per_step=examples_window,
            flops_per_step=(self.flops_per_step * n_steps
                            if self.flops_per_step is not None else None),
            n_chips=self._n_chips(), device=self._device())
        for key, value in rates.items():
            record[key] = round(value, 6)
        self.last_step_record = record
        self.emit(record)
        return record

    def _device(self):
        if torch.cuda.is_available() and self.config.device_index < torch.cuda.device_count():
            return torch.device("cuda", self.config.device_index)
        return None

    def _n_chips(self) -> int:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    # ------------------------------------------------------------------ pipeline
    def emit(self, record: dict) -> None:
        """Route one record (step, serving counter, span, ...) to the history, the
        JSONL file and every sink. No-op while disabled."""
        if not self.enabled:
            return
        self.records.append(record)
        cap = self.config.max_records
        if cap and len(self.records) > cap:
            del self.records[: len(self.records) - cap]
        if self._jsonl_file is not None:
            self._jsonl_file.write(json.dumps(record, default=float) + "\n")
            self._jsonl_file.flush()
            rotate = self.config.rotate_bytes
            if rotate and self._jsonl_file.tell() >= rotate:
                self._rotate_jsonl()
        for sink in self.sinks:
            sink(record)

    def _rotate_jsonl(self) -> None:
        """Roll the active file to ``telemetry.<n>.jsonl`` (n one past the largest
        existing, zero-padded: lexical order is chronological) and open a fresh one."""
        self._jsonl_file.close()
        directory = os.path.dirname(self._jsonl_path)
        taken = [-1]
        for fname in os.listdir(directory):
            if fname.startswith("telemetry.") and fname.endswith(".jsonl"):
                mid = fname[len("telemetry."):-len(".jsonl")]
                if mid.isdigit():
                    taken.append(int(mid))
        rolled = os.path.join(directory, f"telemetry.{max(taken) + 1:05d}.jsonl")
        os.replace(self._jsonl_path, rolled)
        self._jsonl_file = open(self._jsonl_path, "a")

    def log_columns(self, prefix: str = "telemetry/") -> dict:
        """The last step record flattened to scalar columns."""
        rec = self.last_step_record
        if not rec:
            return {}
        out = {}
        for key, value in rec.items():
            if key == "schema":
                continue
            if isinstance(value, dict):
                for sub, sval in value.items():
                    if isinstance(sval, (int, float, bool)):
                        out[f"{prefix}{key}/{sub}"] = sval
            elif isinstance(value, (int, float, bool)):
                out[f"{prefix}{key}"] = value
        return out

    def close(self) -> None:
        self.compile_monitor.stop()
        if self._jsonl_file is not None:
            self._jsonl_file.close()
            self._jsonl_file = None

    def __repr__(self) -> str:
        return (f"Telemetry(enabled={self.enabled}, steps={self._step_count}, "
                f"steady={self.detector.steady}, records={len(self.records)})")

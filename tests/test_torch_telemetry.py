"""The port's step-level telemetry pipeline against the JAX package's, on the CPU.

Mirrors tests/test_telemetry.py:42-441 and :499, leaving out the scheduled profiler,
the bench-import checks and the trackers (none is ported): the steady-state detector
(against JAX's on canned series), the fence and the step timer, the compile monitor
(here a CUDA graph capture or a first-use kernel build is a compile: a kernel build is
exercised through ``ops/_build.build`` with a stand-in compiler), memory counters, the
peak table, the JSONL step record and its rotation, the config and its environment
variable, the train step's telemetry bracket (records, MFU, zero synchronizations
when off, the label unwound after a failed step, one record a fused dispatch) and the
serving engine's counter records. The fence's device wait itself runs only on the
card (``chip_smoke.py``'s ``engine_faults``, ``fence_check``); on the CPU it must do
nothing.
"""

import json
import os
import stat

import numpy as np
import pytest
import torch

from accelerate_tpu.telemetry.steady import SteadyStateDetector as JaxDetector
from accelerate_tpu_torch.telemetry import (REQUIRED_STEP_COLUMNS, STEP_RECORD_SCHEMA,
                                            TELEMETRY_REV, CompileMonitor,
                                            SteadyStateDetector, StepTimer, Telemetry,
                                            compile_label, derived_rates,
                                            device_memory_stats, fence, peak_tflops,
                                            validate_record)
from accelerate_tpu_torch.telemetry.compile_monitor import _current_label, dispatch_compile
from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

PERF_NOTES_SERIES = [10.2, 2.1, 0.47, 0.46, 0.46, 0.47]


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


# ------------------------------------------------------------------ steady state
def test_detector_perf_notes_transient_labeled_not_averaged():
    det = SteadyStateDetector(k=2, rtol=0.10, max_windows=5)
    assert [det.observe(dt) for dt in PERF_NOTES_SERIES] == [False, False, False, True,
                                                             True, True]
    assert det.steady and not det.capped and det.warmup_steps_detected == 2
    assert 0.4 < det.steady_mean_s() < 0.5


def test_detector_immediate_agreement():
    det = SteadyStateDetector(k=2, rtol=0.10, max_windows=5)
    assert not det.observe(1.0)
    assert det.observe(1.05)
    assert det.warmup_steps_detected == 0


def test_detector_cap_labels_everything_warmup():
    det = SteadyStateDetector(k=2, rtol=0.10, max_windows=4)
    assert [det.observe(dt) for dt in [8.0, 4.0, 2.0, 1.0]] == [False, False, False, True]
    assert det.steady and det.capped and det.warmup_steps_detected == 4
    assert det.steady_mean_s() is None


def test_detector_k3_needs_three_agreeing_windows():
    det = SteadyStateDetector(k=3, rtol=0.10, max_windows=0)
    for dt in [5.0, 1.0, 1.02]:
        assert not det.observe(dt)
    assert det.observe(1.01)
    assert det.warmup_steps_detected == 1


def test_detector_validates_params():
    for kw in ({"k": 1}, {"rtol": 0.0}, {"max_windows": -1}):
        with pytest.raises(ValueError):
            SteadyStateDetector(**kw)


def test_detector_cap_below_k_allowed_caps_immediately():
    det = SteadyStateDetector(k=2, rtol=0.10, max_windows=1)
    assert det.observe(1.0)
    assert det.capped and det.warmup_steps_detected == 1


@pytest.mark.parametrize("series", [
    PERF_NOTES_SERIES, [1.0, 1.0, 1.0], [5.0, 3.0, 2.0, 1.5, 1.45, 1.44],
    [8.0, 4.0, 2.0, 1.0, 0.5, 0.25], [0.5, 0.51]])
def test_detector_agrees_with_jax_on_canned_series(series):
    """The copy labels every window as the JAX package's detector does."""
    for kw in ({"k": 2, "rtol": 0.10, "max_windows": 5}, {"k": 3, "rtol": 0.05,
                                                           "max_windows": 0}):
        port, ref = SteadyStateDetector(**kw), JaxDetector(**kw)
        assert [port.observe(dt) for dt in series] == [ref.observe(dt) for dt in series]
        assert (port.warmup_steps_detected, port.capped, port.steady_mean_s()) == \
            (ref.warmup_steps_detected, ref.capped, ref.steady_mean_s())


# ----------------------------------------------------------------- fenced timing
def test_fence_noop_on_cpu_tensors_and_host_values(monkeypatch):
    """Nothing on the CPU to wait for: no event is made, the input comes back."""
    def no_event(*a, **k):
        raise AssertionError("fence made a CUDA event for host data")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    out = {"loss": torch.ones(()), "big": torch.ones((64, 64))}
    assert fence(out) is out
    assert fence({"a": 1.0, "b": [2, 3]}) == {"a": 1.0, "b": [2, 3]}


def test_step_timer_measures_fenced_call():
    timer = StepTimer()
    out, timing = timer.time(lambda x: (x @ x).sum(), torch.ones((128, 128)))
    assert float(out) == 128.0 ** 3
    assert timing.wall_s > 0
    assert timing.wall_s == pytest.approx(timing.dispatch_s + timing.fence_s, rel=1e-6)
    assert not timer.running


def test_step_timer_stop_without_start_raises():
    with pytest.raises(RuntimeError):
        StepTimer().stop(fence_on=torch.ones(()))


# ------------------------------------------------------------- compile counters
def test_compile_counter_counts_events_and_labels():
    mon = CompileMonitor().start()
    try:
        assert mon.supported
        dispatch_compile("graph_capture", 0.5)
        with compile_label("serving.decode_multi"):
            dispatch_compile("graph_capture", 0.25)
        assert mon.count == 2 and mon.seconds == pytest.approx(0.75)
        assert mon.by_label == {"serving.decode_multi": {"count": 1, "seconds": 0.25}}
        assert mon.snapshot()["compiles_by_kind"] == {"graph_capture": 2, "kernel_build": 0}
        assert _current_label() is None
    finally:
        mon.stop()


def test_compile_counter_stop_detaches():
    mon = CompileMonitor().start()
    mon.stop()
    dispatch_compile("graph_capture", 1.0)
    assert mon.count == 0


def test_kernel_build_counts_as_compile(tmp_path, monkeypatch):
    """``ops/_build.build`` counts each source it compiles (not one found built) as a
    ``kernel_build`` compile under the active label; a stand-in for ``nvcc`` writes the
    library."""
    from accelerate_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\ntouch \"$2\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    mon = CompileMonitor().start()
    try:
        with compile_label("first_use"):
            paths = _build.build(["paged_attention", "fused_adamw"])
        assert all(p.exists() for p in paths.values())
        assert mon.by_kind["kernel_build"] == 2 and mon.by_label["first_use"]["count"] == 2
        _build.build(["paged_attention"])  # already built: no compile
        assert mon.count == 2
    finally:
        mon.stop()


def test_captured_step_reports_its_capture():
    """``utils/cuda_graph.CapturedStep`` reports each capture to the monitor (the
    call sits after the capture; the capture itself runs only on the card)."""
    import inspect

    from accelerate_tpu_torch.utils import cuda_graph

    src = inspect.getsource(cuda_graph.CapturedStep.__call__)
    assert 'dispatch_compile("graph_capture", self.capture_s)' in src


# ------------------------------------------------------------------ memory, peaks
def test_memory_stats_graceful_on_cpu():
    assert device_memory_stats() == {}
    assert device_memory_stats(device="cpu") == {}


def test_peak_tflops_table():
    assert peak_tflops(device_kind="NVIDIA H100 80GB HBM3") == 989.0
    assert peak_tflops(device_kind="cpu") == 0.5
    assert peak_tflops(device_kind="some other card") == 989.0
    assert peak_tflops(torch.device("cpu")) == 0.5
    rates = derived_rates(0.5, tokens_per_step=100, flops_per_step=989e12,
                          peak_flops=989e12)
    assert rates["tokens_per_sec_per_chip"] == 200.0
    assert rates["achieved_tflops_per_chip"] == 1978.0 and rates["mfu"] == 2.0


# ------------------------------------------------------------ record schema / JSONL
def test_step_record_jsonl_round_trip(tmp_path):
    tel = Telemetry(TelemetryConfig(enabled=True, jsonl_dir=str(tmp_path), steady_cap=5))
    x = torch.ones((4, 8))
    for _ in range(3):
        tel._step_begin()
        out = {"loss": x.sum()}
        tel._step_end(fence_on=out, batch={"input_ids": np.zeros((4, 8), np.int32)})
    tel.close()
    lines = (tmp_path / "telemetry.jsonl").read_text().splitlines()
    assert len(lines) == 3
    for line in lines:
        rec = json.loads(line)
        assert json.loads(json.dumps(rec)) == rec
        assert all(col in rec for col in REQUIRED_STEP_COLUMNS)
        assert rec["schema"] == STEP_RECORD_SCHEMA and rec["telemetry_rev"] == TELEMETRY_REV
        assert rec["tokens_per_sec_per_chip"] > 0 and validate_record(rec) == []
    assert [json.loads(line)["step"] for line in lines] == [1, 2, 3]


def test_jsonl_rotation_keeps_chronological_order(tmp_path):
    tel = Telemetry(TelemetryConfig(enabled=True, jsonl_dir=str(tmp_path), rotate_bytes=200))
    for i in range(12):
        tel.emit({"schema": "x", "i": i, "pad": "p" * 40})
    tel.close()
    files = sorted(f for f in os.listdir(tmp_path) if f != "telemetry.jsonl")
    assert files and all(f.startswith("telemetry.0") for f in files)
    seen = [json.loads(line)["i"] for f in files + ["telemetry.jsonl"]
            for line in (tmp_path / f).read_text().splitlines()]
    assert seen == list(range(12))


def test_telemetry_config_env_override(monkeypatch):
    monkeypatch.delenv("ACCELERATE_TELEMETRY", raising=False)
    assert TelemetryConfig().enabled is False
    monkeypatch.setenv("ACCELERATE_TELEMETRY", "1")
    monkeypatch.setenv("ACCELERATE_TELEMETRY_DIR", "/tmp/tel_env_dir")
    cfg = TelemetryConfig()
    assert cfg.enabled is True and cfg.jsonl_dir == "/tmp/tel_env_dir"
    assert TelemetryConfig(enabled=False).enabled is False


def test_telemetry_config_validation():
    for kw in ({"steady_k": 1}, {"steady_rtol": -0.1}, {"steady_cap": -1},
               {"rotate_bytes": -1}, {"trace_sample_every": 0}, {"trace_sample_prob": 2.0}):
        with pytest.raises(ValueError):
            TelemetryConfig(**kw)
    TelemetryConfig(steady_k=3, steady_cap=2)
    from accelerate_tpu_torch.telemetry import FlightRecorder

    armed = Telemetry(TelemetryConfig(enabled=True, recorder=True, recorder_ring=8))
    assert isinstance(armed.recorder, FlightRecorder) and armed.recorder.ring.maxlen == 8
    off = Telemetry(TelemetryConfig(enabled=False, recorder=True))
    assert off.enabled is False and off.recorder is None
    for kw in ({"recorder_ring": 0}, {"recorder_snapshot_every": -1},
               {"capsule_cooldown_s": -1.0}):
        with pytest.raises(ValueError):
            TelemetryConfig(**kw)


# -------------------------------------------------- integration: train step records
def _tiny_training(telemetry_config, n_steps=4, fused_steps=1):
    from accelerate_tpu_torch import optim as topt
    from accelerate_tpu_torch.accelerator import Accelerator

    acc = Accelerator(device="cpu", telemetry_config=telemetry_config)
    state = acc.create_train_state({"w": torch.ones((16, 4))}, topt.sgd(0.1))
    step = acc.build_train_step(
        lambda p, b: (torch.as_tensor(b["input_ids"]).float() @ p["w"]).mean(),
        fused_steps=fused_steps)
    batch = {"input_ids": np.ones((8, 16), np.int32)}
    if fused_steps > 1:
        batch = [batch] * fused_steps
    for _ in range(n_steps):
        state, metrics = step(state, batch)
    return acc, state, metrics, step


def test_enabled_train_loop_writes_jsonl_run_dir(tmp_path):
    acc, _, _, _ = _tiny_training(TelemetryConfig(enabled=True, jsonl_dir=str(tmp_path)),
                                  n_steps=5)
    acc.telemetry.close()
    recs = [json.loads(line) for line in
            (tmp_path / "telemetry.jsonl").read_text().splitlines()]
    assert len(recs) == 5 and [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    last = recs[-1]
    assert last["wall_s"] > 0 and last["fence_s"] >= 0 and isinstance(last["steady"], bool)
    assert last["compiles_total"] == 0  # nothing is captured or built on the CPU
    assert last["tokens_per_sec_per_chip"] > 0 and "memory" not in last
    assert acc.telemetry.log_columns()["telemetry/step"] == 5


def test_mfu_reported_with_flop_hint():
    acc, _, _, _ = _tiny_training(TelemetryConfig(enabled=True, flops_per_step=1e6),
                                  n_steps=3)
    rec = acc.telemetry.last_step_record
    assert rec["mfu"] > 0 and rec["achieved_tflops_per_chip"] > 0
    assert rec["peak_tflops_assumed"] == 0.5  # no card here: the table's cpu entry


def test_disabled_mode_zero_records_zero_syncs(monkeypatch):
    """Telemetry off (the default) adds to the train step no record, no timer, no
    fence and no synchronization."""
    from accelerate_tpu_torch.telemetry import core, timing

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("sync"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda self: calls.append("event"))
    monkeypatch.setattr(timing, "fence", lambda out: calls.append("fence") or out)
    monkeypatch.setattr(core.StepTimer, "start", lambda self: calls.append("clock"))
    acc, _, _, _ = _tiny_training(TelemetryConfig(), n_steps=3)
    assert acc.telemetry.enabled is False
    assert calls == [] and acc.telemetry.records == []
    assert acc.telemetry.last_step_record is None


def test_step_exception_unwinds_compile_label():
    from accelerate_tpu_torch import optim as topt
    from accelerate_tpu_torch.accelerator import Accelerator

    acc = Accelerator(device="cpu", telemetry_config=TelemetryConfig(enabled=True))
    state = acc.create_train_state({"w": torch.ones((16, 4))}, topt.sgd(0.1))
    step = acc.build_train_step(
        lambda p, b: (torch.as_tensor(b["input_ids"]).float() @ p["w"]).mean())
    with pytest.raises(Exception):
        step(state, {"input_ids": np.ones((8, 5), np.int32)})  # wrong inner dim
    assert _current_label() is None and not acc.telemetry.timer.running
    state, _ = step(state, {"input_ids": np.ones((8, 16), np.int32)})
    assert acc.telemetry.last_step_record is not None


def test_fused_step_emits_one_record_per_dispatch():
    acc, _, _, _ = _tiny_training(TelemetryConfig(enabled=True), n_steps=2, fused_steps=2)
    recs = [r for r in acc.telemetry.records if r["schema"] == STEP_RECORD_SCHEMA]
    assert len(recs) == 2 and recs[-1]["step"] == 4


def test_step_record_columns_match_jax():
    """The port's step record has the JAX record's columns (memory aside: neither
    backend here has an allocator ledger)."""
    import jax.numpy as jnp

    from accelerate_tpu.telemetry import Telemetry as JaxTelemetry
    from accelerate_tpu.utils.dataclasses import TelemetryConfig as JaxTelemetryConfig

    cfg = dict(enabled=True, flops_per_step=1e6)
    port, ref = Telemetry(TelemetryConfig(**cfg)), JaxTelemetry(JaxTelemetryConfig(**cfg))
    batch = {"input_ids": np.zeros((4, 8), np.int32)}
    port._step_begin()
    rec = port._step_end(fence_on={"loss": torch.ones(())}, batch=batch)
    ref._step_begin()
    jrec = ref._step_end(fence_on={"loss": jnp.ones(())}, batch=batch)
    drop = {"memory"}
    assert set(rec) - drop == set(jrec) - drop
    ref.close()


# ------------------------------------------------------------------ serving pipeline
def test_serving_counters_and_telemetry_records():
    import dataclasses

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32)
    params = llama.init_params(cfg, device="cpu")
    tel = Telemetry(TelemetryConfig(enabled=True))
    engine = ContinuousBatcher(params, cfg, max_slots=2, max_len=128, prompt_bucket=16,
                               telemetry=tel)
    for prompt in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
        engine.submit(np.array(prompt, np.int32), max_new_tokens=3)
    out, tps = engine.run(report_throughput=True)
    assert len(out) == 3 and tps > 0
    stats = engine.stats()
    assert stats["admitted"] == 3 and stats["evicted"] == 3
    assert stats["active_slots"] == 0 and stats["queued"] == 0
    serving = [r for r in tel.records
               if str(r.get("schema", "")).startswith("accelerate_tpu.telemetry.serving")]
    assert serving and all(validate_record(r) == [] for r in serving)
    tput = [r for r in serving if r["schema"].endswith("throughput/v1")]
    assert len(tput) == 1 and tput[0]["requests_finished"] == 3
    assert tput[0]["tokens_generated"] == sum(len(r.tokens) for r in out)
    tel.close()

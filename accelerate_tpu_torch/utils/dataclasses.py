"""Config dataclasses and enums of the training path.

Copies of ``accelerate_tpu/utils/dataclasses.py``'s ``KwargsHandler``, ``PrecisionType``,
``DistributedType``, ``RNGType``, ``GradientAccumulationPlugin``, ``MixedPrecisionPolicy``
(dtypes are torch's), ``DataLoaderConfiguration`` (with its launcher environment
sentinels), ``ProjectConfiguration``, ``GatewayConfig`` (the serving gateway's, with its
validation and its ``ACCELERATE_GATEWAY`` environment variable), ``TelemetryConfig``
(``ACCELERATE_TELEMETRY``, ``ACCELERATE_TELEMETRY_DIR``), ``FaultConfig``
(``ACCELERATE_FAULTS``) and ``TensorInformation``. ``RNGType`` has no
``jax`` member: the port draws no JAX keys.
"""

from __future__ import annotations

import copy
import enum
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .environment import parse_flag_from_env

__all__ = [
    "KwargsHandler", "PrecisionType", "DistributedType", "RNGType",
    "GradientAccumulationPlugin", "MixedPrecisionPolicy", "DataLoaderConfiguration",
    "ProjectConfiguration", "GatewayConfig", "TelemetryConfig", "FaultConfig",
    "TensorInformation", "parse_flag_from_env",
]


class KwargsHandler:
    """Base mixin for kwargs dataclasses."""

    def to_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self) -> dict[str, Any]:
        """Return only the fields that differ from the dataclass defaults."""
        default = self.__class__()
        return {k: v for k, v in self.to_dict().items() if getattr(default, k) != v}


class EnumWithContains(enum.EnumMeta):
    def __contains__(cls, item):
        try:
            cls(item)
        except ValueError:
            return False
        return True


class BaseEnum(str, enum.Enum, metaclass=EnumWithContains):
    def __str__(self):
        return self.value

    @classmethod
    def list(cls):
        return list(map(str, cls))


class DistributedType(BaseEnum):
    """Which parallelism mode the Accelerator is driving: ``NO`` in one process without a
    mesh, otherwise the JAX package's rule over the mesh's axes of size > 1
    (``state.AcceleratorState``)."""

    NO = "NO"
    MULTI_DEVICE = "MULTI_DEVICE"
    FSDP = "FSDP"
    TP = "TP"
    PP = "PP"
    SP = "SP"
    EP = "EP"
    HYBRID = "HYBRID"
    MULTI_HOST = "MULTI_HOST"


class RNGType(BaseEnum):
    NUMPY = "numpy"
    PYTHON = "python"
    GENERATOR = "generator"  # the torch generator that drives a sampler's data order
    TORCH = "torch"


class PrecisionType(BaseEnum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class MixedPrecisionPolicy(KwargsHandler):
    """The dtype quadruple governing a train step: params kept in ``param_dtype``
    (master weights), cast to ``compute_dtype`` for the forward/backward, outputs cast to
    ``output_dtype``, gradients taken in ``reduce_dtype`` when it equals the compute
    dtype (the bf16 ``compress_reduce`` branch of ``build_train_step``)."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32
    reduce_dtype: Any = torch.float32

    @classmethod
    def from_precision(cls, precision) -> "MixedPrecisionPolicy":
        precision = PrecisionType(str(precision))
        if precision == PrecisionType.NO:
            return cls()
        if precision == PrecisionType.BF16:
            return cls(compute_dtype=torch.bfloat16, reduce_dtype=torch.bfloat16)
        if precision == PrecisionType.FP16:
            return cls(compute_dtype=torch.float16, reduce_dtype=torch.float16)
        if precision == PrecisionType.FP8:
            return cls(compute_dtype=torch.bfloat16, reduce_dtype=torch.bfloat16)
        raise ValueError(f"unknown precision {precision}")


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """How ``Accelerator.prepare`` wraps a data loader. The None-sentinel fields resolve
    from the launcher's environment (``ACCELERATE_DISPATCH_BATCHES``,
    ``ACCELERATE_EVEN_BATCHES``, ``ACCELERATE_USE_SEEDABLE_SAMPLER``), else the built-in
    default. ``prefetch_depth``: batches placed on the device ahead of the one being
    consumed (at least 1, which ``end_of_dataloader`` needs)."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: Optional[bool] = None         # built-in True
    use_seedable_sampler: Optional[bool] = None  # built-in True
    data_seed: Optional[int] = None
    non_blocking: bool = False
    use_stateful_dataloader: bool = False
    prefetch_depth: int = 1

    def __post_init__(self):
        if self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth={self.prefetch_depth} must be >= 1 (the one-batch "
                "lookahead is required to detect end_of_dataloader before the final "
                "batch is yielded)")
        if self.dispatch_batches is None and "ACCELERATE_DISPATCH_BATCHES" in os.environ:
            self.dispatch_batches = parse_flag_from_env("ACCELERATE_DISPATCH_BATCHES")
        if self.even_batches is None:
            self.even_batches = parse_flag_from_env("ACCELERATE_EVEN_BATCHES", True)
        if self.use_seedable_sampler is None:
            self.use_seedable_sampler = parse_flag_from_env("ACCELERATE_USE_SEEDABLE_SAMPLER",
                                                            True)


@dataclass
class ProjectConfiguration(KwargsHandler):
    """Checkpoint folder layout and rotation: with ``automatic_checkpoint_naming``,
    ``save_state()`` writes ``project_dir/checkpoints/checkpoint_{iteration}`` and keeps
    at most ``total_limit`` committed checkpoints."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.project_dir is None and os.environ.get("ACCELERATE_PROJECT_DIR"):
            self.project_dir = os.environ["ACCELERATE_PROJECT_DIR"]
        if self.total_limit is None and os.environ.get("ACCELERATE_CHECKPOINT_TOTAL_LIMIT"):
            self.total_limit = int(os.environ["ACCELERATE_CHECKPOINT_TOTAL_LIMIT"])
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


#: Values of ``ACCELERATE_GATEWAY`` that switch the gateway on or off; anything else
#: must be a policy name.
_GATEWAY_ENV_TRUE = frozenset({"1", "true", "yes", "on"})
_GATEWAY_ENV_FALSE = frozenset({"", "0", "false", "no", "off"})
_GATEWAY_POLICIES = frozenset({"fifo", "priority", "edf", "wfq"})


@dataclass
class GatewayConfig(KwargsHandler):
    """The SLO-aware serving gateway's configuration (``serving_gateway``), a copy of
    the JAX package's ``GatewayConfig``.

    ``enabled`` and ``policy`` resolve as explicit argument > ``ACCELERATE_GATEWAY`` >
    built-in (off, ``fifo``); a policy-name value of the variable enables the gateway
    and picks the policy. ``policy``: ``fifo``, ``priority`` (with aging: +1 level per
    ``aging_s`` waited), ``edf`` or ``wfq`` (``tenant_weights``). ``max_queue`` /
    ``max_queued_tokens`` bound admission (0 = unbounded); past a bound ``overload``
    rejects the newcomer or sheds the least urgent queued request. ``deadline_s`` is a
    default relative deadline; ``preempt`` lets a more urgent queued request evict the
    least urgent running one, which retries up to ``max_retries`` times. The breaker
    opens after ``breaker_threshold`` step failures in ``breaker_window_s`` (0 = off)
    and admits one probe after ``breaker_cooldown_s``; ``degrade`` turns speculation off
    and then halves the bounds at each opening. Fleet: ``drain_deadline_s``,
    ``replica_restarts``, ``replica_restart_backoff``; disaggregated serving:
    ``replica_roles`` (one of prefill/decode/mixed per replica, comma-separated).
    ``metrics`` builds a live metrics plane over an enabled telemetry (windows of
    ``metrics_window_s``) and ``capsule_state`` registers the gateway's state with the
    telemetry's flight recorder. ``decode_steps`` is the super-step depth the
    gateway expects of its engine (validated at construction; 1 = whatever it runs)."""

    enabled: Optional[bool] = None
    policy: Optional[str] = None
    max_queue: int = 0
    max_queued_tokens: int = 0
    overload: str = "reject"
    aging_s: float = 10.0
    default_priority: int = 0
    tenant_weights: Optional[dict] = None
    deadline_s: Optional[float] = None
    preempt: bool = False
    max_retries: int = 0
    emit_per_request: bool = True
    max_terminal: int = 4096
    breaker_threshold: int = 0
    breaker_window_s: float = 60.0
    breaker_cooldown_s: float = 30.0
    degrade: bool = False
    drain_deadline_s: Optional[float] = 30.0
    replica_restarts: int = 2
    replica_restart_backoff: float = 0.0
    replica_roles: Optional[str] = None
    metrics: bool = False
    metrics_window_s: float = 300.0
    capsule_state: bool = True
    decode_steps: int = 1

    def __post_init__(self):
        raw = os.environ.get("ACCELERATE_GATEWAY")
        raw_norm = raw.strip().lower() if raw is not None else None
        raw_is_policy = raw_norm in _GATEWAY_POLICIES
        if (raw_norm is not None and not raw_is_policy
                and raw_norm not in (_GATEWAY_ENV_TRUE | _GATEWAY_ENV_FALSE)):
            raise ValueError(
                f"ACCELERATE_GATEWAY={raw!r}: expected a boolean "
                f"({'/'.join(sorted(_GATEWAY_ENV_TRUE))} or "
                f"{'/'.join(sorted(v for v in _GATEWAY_ENV_FALSE if v))}) "
                f"or a policy name ({'/'.join(sorted(_GATEWAY_POLICIES))})")
        if self.enabled is None:
            self.enabled = (False if raw_norm is None
                            else raw_is_policy or raw_norm in _GATEWAY_ENV_TRUE)
        if self.policy is None:
            self.policy = raw_norm if raw_is_policy else "fifo"
        if self.policy not in _GATEWAY_POLICIES:
            raise ValueError(f"policy={self.policy!r} must be one of {sorted(_GATEWAY_POLICIES)}")
        if self.max_queue < 0:
            raise ValueError(f"max_queue={self.max_queue} must be >= 0 (0 = unbounded)")
        if self.max_queued_tokens < 0:
            raise ValueError(
                f"max_queued_tokens={self.max_queued_tokens} must be >= 0 (0 = unbounded)")
        if self.overload not in ("reject", "shed"):
            raise ValueError(f"overload={self.overload!r} must be 'reject' or 'shed'")
        if self.aging_s <= 0:
            raise ValueError(
                f"aging_s={self.aging_s} must be > 0 (aging is what makes the priority "
                "policy starvation-free; disable aging by raising it, not zeroing it)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s={self.deadline_s} must be > 0 when set")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")
        if self.max_terminal < 0:
            raise ValueError(f"max_terminal={self.max_terminal} must be >= 0 (0 = unbounded)")
        if self.breaker_threshold < 0:
            raise ValueError(
                f"breaker_threshold={self.breaker_threshold} must be >= 0 (0 = off)")
        if self.breaker_window_s <= 0:
            raise ValueError(f"breaker_window_s={self.breaker_window_s} must be > 0")
        if self.breaker_cooldown_s <= 0:
            raise ValueError(f"breaker_cooldown_s={self.breaker_cooldown_s} must be > 0")
        if self.drain_deadline_s is not None and self.drain_deadline_s <= 0:
            raise ValueError(
                f"drain_deadline_s={self.drain_deadline_s} must be > 0 "
                "(None = wait for in-flight requests forever)")
        if self.metrics_window_s <= 0:
            raise ValueError(f"metrics_window_s={self.metrics_window_s} must be > 0")
        if self.decode_steps < 1:
            raise ValueError(
                f"decode_steps={self.decode_steps} must be >= 1 (1 = classic one-token decode)")
        if self.replica_restarts < 0:
            raise ValueError(f"replica_restarts={self.replica_restarts} must be >= 0")
        if self.replica_restart_backoff < 0:
            raise ValueError(
                f"replica_restart_backoff={self.replica_restart_backoff} must be >= 0")
        if self.replica_roles is not None:
            roles = [r.strip() for r in self.replica_roles.split(",")]
            bad = [r for r in roles if r not in ("prefill", "decode", "mixed")]
            if bad or not roles:
                raise ValueError(
                    f"replica_roles={self.replica_roles!r}: expected a comma-separated "
                    "list of prefill/decode/mixed, one per replica")
        if self.tenant_weights is not None:
            for tenant, weight in self.tenant_weights.items():
                if weight <= 0:
                    raise ValueError(f"tenant_weights[{tenant!r}]={weight} must be > 0")


@dataclass
class TelemetryConfig(KwargsHandler):
    """The telemetry pipeline's configuration (``telemetry.Telemetry``), a copy of the
    JAX package's ``TelemetryConfig``.

    Off by default and free when off. ``enabled`` resolves as explicit argument >
    ``ACCELERATE_TELEMETRY`` > off; ``jsonl_dir`` (``ACCELERATE_TELEMETRY_DIR``) makes
    records land in ``<jsonl_dir>/telemetry.jsonl``, rolled over past ``rotate_bytes``
    (0 = never). ``steady_*`` parameterize the warm-until-steady rule;
    ``flops_per_step``/``tokens_per_step``/``examples_per_step`` are static per-step
    costs for the derived rates. ``compile_events`` counts graph captures and kernel
    builds; ``memory_stats`` samples the CUDA allocator. ``trace_sample_*`` set a
    tracer's head sampling. ``recorder`` arms the flight recorder (a ring of
    ``recorder_ring`` records, a plane snapshot every ``recorder_snapshot_every``
    records, incident capsules under ``capsule_dir`` at most once per trigger in
    ``capsule_cooldown_s``)."""

    enabled: Optional[bool] = None          # None → env ACCELERATE_TELEMETRY > False
    jsonl_dir: Optional[str] = None         # None → env ACCELERATE_TELEMETRY_DIR
    rotate_bytes: int = 0
    steady_k: int = 2
    steady_rtol: float = 0.10
    steady_cap: int = 50                    # 0 = never cap the warmup
    compile_events: bool = True
    memory_stats: bool = True
    device_index: int = 0
    max_records: int = 4096                 # in-memory history cap (JSONL is unbounded)
    merge_into_log: bool = True
    flops_per_step: Optional[float] = None
    tokens_per_step: Optional[float] = None
    examples_per_step: Optional[float] = None
    recorder: bool = False
    recorder_ring: int = 2048
    recorder_snapshot_every: int = 256
    capsule_dir: Optional[str] = None       # None → env ACCELERATE_CAPSULE_DIR
    capsule_cooldown_s: float = 30.0
    trace_sample_every: int = 1
    trace_sample_prob: Optional[float] = None
    trace_sample_seed: int = 0

    def __post_init__(self):
        if self.enabled is None:
            self.enabled = parse_flag_from_env("ACCELERATE_TELEMETRY")
        if self.jsonl_dir is None:
            self.jsonl_dir = os.environ.get("ACCELERATE_TELEMETRY_DIR") or None
        if self.capsule_dir is None:
            self.capsule_dir = os.environ.get("ACCELERATE_CAPSULE_DIR") or None
        if self.steady_k < 2:
            raise ValueError(f"steady_k={self.steady_k}: agreement needs >= 2 windows")
        if self.steady_rtol <= 0:
            raise ValueError(f"steady_rtol={self.steady_rtol} must be > 0")
        if self.steady_cap < 0:
            raise ValueError(f"steady_cap={self.steady_cap} must be >= 0 (0 = no cap)")
        if self.rotate_bytes < 0:
            raise ValueError(f"rotate_bytes={self.rotate_bytes} must be >= 0 (0 = never rotate)")
        if self.recorder_ring < 1:
            raise ValueError(f"recorder_ring={self.recorder_ring} must be >= 1")
        if self.recorder_snapshot_every < 0:
            raise ValueError(f"recorder_snapshot_every={self.recorder_snapshot_every} "
                             "must be >= 0 (0 = never snapshot)")
        if self.capsule_cooldown_s < 0:
            raise ValueError(f"capsule_cooldown_s={self.capsule_cooldown_s} must be >= 0")
        if self.trace_sample_every < 1:
            raise ValueError(f"trace_sample_every={self.trace_sample_every} must be >= 1 "
                             "(1 = trace every request)")
        if self.trace_sample_prob is not None and not 0.0 <= self.trace_sample_prob <= 1.0:
            raise ValueError(f"trace_sample_prob={self.trace_sample_prob} must be in [0, 1]")


@dataclass
class FaultConfig(KwargsHandler):
    """Deterministic fault injection's configuration (``resilience.faults``), a copy of
    the JAX package's ``FaultConfig``.

    Off by default and free when off. ``enabled`` resolves as explicit argument >
    ``ACCELERATE_FAULTS`` > off; a value of the variable that is not a boolean is the
    clause string (``resilience.faults.parse_fault_spec``'s grammar) and both enables
    injection and defines the plan. ``seed`` seeds the plan (a ``seed=N`` clause wins);
    :meth:`build_plan` gives the ``FaultPlan`` the ``Accelerator`` exposes as
    ``fault_plan``."""

    enabled: Optional[bool] = None   # None → env ACCELERATE_FAULTS > False
    spec: Optional[str] = None       # None → the env clause string (when not a boolean)
    seed: int = 0

    def __post_init__(self):
        raw = os.environ.get("ACCELERATE_FAULTS")
        raw_norm = raw.strip().lower() if raw is not None else None
        raw_is_spec = raw_norm is not None and raw_norm not in (
            _GATEWAY_ENV_TRUE | _GATEWAY_ENV_FALSE)
        if self.enabled is None:
            if raw_norm is None:
                self.enabled = False
            else:
                self.enabled = raw_is_spec or raw_norm in _GATEWAY_ENV_TRUE
        if self.spec is None and raw_is_spec:
            self.spec = raw
        if self.enabled and not self.spec:
            raise ValueError(
                "fault injection enabled with no fault clauses: pass spec= (or set "
                "ACCELERATE_FAULTS to a clause string like 'serving.decode:error:0.1') — "
                "an empty plan would silently inject nothing")
        if self.spec:
            from ..resilience.faults import parse_fault_spec

            parse_fault_spec(self.spec)  # the grammar is checked here, not at a draw

    def build_plan(self):
        """The resolved ``FaultPlan`` (None when disabled)."""
        if not self.enabled:
            return None
        from ..resilience.faults import FaultPlan

        return FaultPlan.from_spec(self.spec, seed=self.seed)


class TensorInformation:
    """Shape and dtype of one leaf, sent ahead of its data by the object collectives."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"TensorInformation(shape={self.shape}, dtype={self.dtype})"

    def __eq__(self, other):
        return (isinstance(other, TensorInformation) and self.shape == other.shape
                and self.dtype == other.dtype)

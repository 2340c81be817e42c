"""``serve-bench`` of the port: the serving benchmarks over the torch engine, the
counterpart of ``accelerate_tpu/commands/serve_bench.py``.

Modes on the host clock (latencies and tokens/s are wall seconds):

- :func:`run_serve_bench` (no mode flag): one paced overload burst replayed once per
  queue policy; one SLO row per policy, with ``--spec-k``/``--spec-draft`` (``ngram``,
  ``half``, ``oracle``), ``--page-size`` and ``--decode-steps`` columns;
- :func:`run_disagg_bench` (``--disagg P:D``): a mixed ``FleetRouter`` against a
  ``DisaggRouter`` of P prefill and D decode replicas, plus a chaos arm with replica
  crash clauses; per-replica stall shares measured by :class:`_EngineMeter`;
- :func:`run_paged_compare` (``--paged-compare``): dense against paged at one KV byte
  budget, with a short-request burst and a prefix-heavy burst;
- :func:`run_multistep_bench` (``--multistep``): a ``decode_steps`` sweep whose streams
  must equal the N = 1 row's bitwise;
- :func:`run_spec_bench` (``--spec-bench``): plain, host-loop n-gram and oracle overload
  rows, then host-loop speculation against the fused speculative super-step.

Modes on a VIRTUAL clock (one router step = ``step_dt`` seconds), so their invariants do
not depend on how fast the device is:

- :func:`run_trace_replay` (``--trace-gen``/``--workload-trace``): one row per policy
  with SLO percentiles, deadline attainment and the trace hash;
- :func:`run_trace_curves` (``--trace-curves``): deadline attainment against offered
  load, per generator and policy;
- :func:`run_chaos_bench` (``--chaos``): one trace clean and under a seeded
  ``FaultPlan`` (decode, prefill, kv_admit sites) with the metrics plane, the stock
  alert rules and the flight recorder armed: zero silently-lost requests, stream
  parity, alerts silent when clean and firing under chaos, capsules covering every
  injected site;
- :func:`run_fleet_chaos_bench` (``--chaos --fleet N``): replica crash clauses behind
  the ``FleetRouter``, restarts through ``engine_factory``, replayed streams bitwise,
  availability above one engine of the same lanes;
- :func:`run_autoscale_bench` (``--autoscale``): a diurnal swing trace static-small /
  static-peak / autoscaled, plus steady, flood and crash-mid-scale-down arms.

Each ``run_*`` takes JAX's arguments plus ``device`` (default: the CUDA card; ``"cpu"``
to run on the CPU), ``dtype`` (default: the preset's), ``params`` (default: the port's
seeded ``init_params``) and ``engine_hook`` (called with every engine after its warm-up).
On the card every engine, the restarted and spawned ones included, captures its CUDA
graphs with ``warm_programs()`` before it takes traffic, where the JAX bench warms the
process-wide jit caches once. Sampled requests take the integer seed ``seed * 1000 + i``
where JAX takes ``PRNGKey(seed * 1000 + i)``.

Run it as ``python -m accelerate_tpu_torch serve-bench ...`` (or
``python -m accelerate_tpu_torch.commands.serve_bench ...``); ``--device cpu`` runs it
on the CPU.
"""

from __future__ import annotations

import argparse

from ..spec_decode import DraftSource

__all__ = ["run_serve_bench", "run_trace_replay", "run_trace_curves", "run_chaos_bench",
           "run_fleet_chaos_bench", "run_autoscale_bench", "run_disagg_bench",
           "run_paged_compare", "run_multistep_bench", "run_spec_bench",
           "serve_bench_command", "serve_bench_command_parser"]

#: Policy rows a plain run emits, in order.
ALL_POLICIES = ("fifo", "priority", "edf", "wfq")


def serve_bench_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = (
        "Replay one synthetic overload burst against the serving gateway once per "
        "queue policy over the torch engine; print a JSON row of SLO percentiles per "
        "policy (or run one of the mode flags' benches)."
    )
    if subparsers is not None:
        parser = subparsers.add_parser("serve-bench", description=description)
    else:
        parser = argparse.ArgumentParser(
            "python -m accelerate_tpu_torch.commands.serve_bench",
            description=description
        )
    parser.add_argument("--policy", default="all",
                        choices=("all",) + ALL_POLICIES,
                        help="which policy rows to run (default: all)")
    parser.add_argument("--preset", default="smoke",
                        help="model preset: 'smoke' (tiny CI shape) or a "
                             "models.llama.CONFIGS key")
    parser.add_argument("--requests", type=int, default=48,
                        help="burst size (several × the queue bound → overload)")
    parser.add_argument("--max-slots", type=int, default=4, help="decode lanes")
    parser.add_argument("--max-len", type=int, default=128, help="engine cache length")
    parser.add_argument("--prompt-bucket", type=int, default=16,
                        help="prefill bucket / chunk width")
    parser.add_argument("--max-new", type=int, default=16,
                        help="generation budget per request")
    parser.add_argument("--overload", type=float, default=4.0,
                        help="queue bound = overload × max_slots (the 4× acceptance "
                             "geometry)")
    parser.add_argument("--high-frac", type=float, default=0.25,
                        help="fraction of high-priority / tight-deadline requests")
    parser.add_argument("--deadline-tight", type=float, default=15.0,
                        help="relative deadline (s) of the high class (EDF orders by it)")
    parser.add_argument("--deadline-loose", type=float, default=120.0,
                        help="relative deadline (s) of the low class")
    parser.add_argument("--seed", type=int, default=0, help="workload rng seed")
    parser.add_argument("--spec-k", type=int, default=0,
                        help="speculative proposals per slot per step (0 = plain "
                             "decode); every policy row then stamps spec_accept_rate "
                             "and tokens_per_step")
    parser.add_argument("--spec-draft", default="ngram",
                        choices=("ngram", "half", "oracle"),
                        help="draft source when --spec-k > 0: 'ngram' (model-free "
                             "prompt lookup), 'half' (half-depth draft model), or "
                             "'oracle' (proposals from precomputed greedy references "
                             "— acceptance-1.0 CEILING isolating the engine's verify "
                             "mechanism; random smoke weights make real acceptance "
                             "meaningless-by-construction, same rationale as "
                             "benchmarks/big_model_inference/speculative_tpu.py)")
    parser.add_argument("--workload", default="mixed", choices=("mixed", "repeat"),
                        help="'mixed' = the classic random burst; 'repeat' = "
                             "low-entropy repeated-token prompts (the "
                             "extraction/echo-shaped traffic prompt-lookup drafting "
                             "is for). Applies with or without --spec-k, so "
                             "spec/non-spec rows stay apples-to-apples")
    parser.add_argument("--page-size", type=int, default=0,
                        help="paged KV cache page size (tokens per page; 0 = dense "
                             "layout). Every policy row then stamps page-pool "
                             "occupancy and kv_bytes_per_request")
    parser.add_argument("--kv-pages", type=int, default=None,
                        help="page-pool size for --page-size (default: dense-"
                             "equivalent capacity)")
    parser.add_argument("--decode-steps", default="1",
                        help="multi-step decode depth (docs/multistep_decode.md). "
                             "Policy rows take a single int (every engine and "
                             "its gateway run that super-step depth); with "
                             "--multistep, a comma-separated sweep ladder "
                             "starting at the N=1 baseline (default 1,2,4,8)")
    parser.add_argument("--multistep", default=None, metavar="OUT_JSON",
                        help="instead of policy rows, sweep --decode-steps at "
                             "high occupancy (same burst per depth) and write "
                             "the artifact (BENCH_MULTISTEP.json) to this "
                             "path: decode-only tokens/s, host-time share from "
                             "the decode spans' measured inter-dispatch gaps, "
                             "and the bitwise identical-vs-N=1 gate per row")
    parser.add_argument("--spec-bench", default=None, metavar="OUT_JSON",
                        help="instead of policy rows, run the speculative-"
                             "serving comparison (plain / host-loop ngram / "
                             "oracle-ceiling overload rows, plus the high-"
                             "occupancy host-loop-vs-FUSED super-step sweep "
                             "with per-arm host_share from the decode spans "
                             "and bitwise parity gates) and write the "
                             "artifact (BENCH_SPEC.json) to this path. "
                             "--spec-k sets k (default 3), --decode-steps the "
                             "fused depth (default 8)")
    parser.add_argument("--paged-compare", default=None, metavar="OUT_JSON",
                        help="instead of policy rows, run the fixed-KV-budget "
                             "dense-vs-paged comparison and write the artifact "
                             "(BENCH_PAGED.json) to this path. Uses compare-tuned "
                             "geometry (256-token rows, 16 paged lanes) unless "
                             "--max-len/--max-slots are explicitly set; --kv-pages "
                             "is always derived from the byte budget")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny fast shape (CI tier-1): 20 requests, 2 slots, "
                             "8-token budget")
    parser.add_argument("--trace-gen", default=None,
                        help="replace the classic burst with a generated workload "
                             "trace (poisson/diurnal/heavy_tail/tenant_flood) "
                             "replayed on a virtual clock; rows stamp the trace "
                             "hash")
    parser.add_argument("--workload-trace", default=None, metavar="FILE",
                        help="replay a recorded workload-trace JSONL file "
                             "(arrival_s/prompt_len/output_len/tenant/priority/"
                             "deadline_s per line) instead of any generator")
    parser.add_argument("--save-trace", default=None, metavar="FILE",
                        help="with --trace-gen: write the generated trace JSONL "
                             "to FILE and exit (replay it later with "
                             "--workload-trace)")
    parser.add_argument("--load", type=float, default=None,
                        help="offered-load factor (arrivals time-compressed/"
                             "paced by this factor); default 1.0 for trace "
                             "replay and chaos, 2.0 for --disagg (the >=2x "
                             "overload acceptance geometry)")
    parser.add_argument("--trace-curves", default=None, metavar="OUT_JSON",
                        help="run the SLO-attainment-vs-offered-load sweep "
                             "(generators x policies x loads) and write the "
                             "BENCH_TRACE.json artifact to this path")
    parser.add_argument("--chaos", default=None, metavar="OUT_JSON",
                        help="run the chaos proof: replay one workload trace "
                             "clean AND under a seeded FaultPlan failing "
                             "--chaos-rate of decode dispatches, assert zero "
                             "silently-lost requests + byte-identical "
                             "recovered streams, and write BENCH_CHAOS.json "
                             "to this path")
    parser.add_argument("--chaos-rate", type=float, default=0.15,
                        help="per-dispatch decode failure probability for "
                             "--chaos (default 0.15 — above the >=10%% "
                             "acceptance floor)")
    parser.add_argument("--chaos-sites", default="decode",
                        help="comma-separated fault sites for the --chaos "
                             "plan: decode (dispatch failures), prefill "
                             "(admission failures), kv_admit (paged page-pool "
                             "allocation failures — forces a paged engine when "
                             "--page-size is 0). Per-site fire counts are "
                             "stamped into the artifact")
    parser.add_argument("--fleet", type=int, default=0, metavar="N",
                        help="with --chaos: run the FLEET chaos proof instead "
                             "(N engine replicas behind the FleetRouter, a "
                             "seeded plan killing replicas mid-trace) and "
                             "write BENCH_FLEET.json — zero silently-lost, "
                             "migrated streams byte-identical, availability "
                             "above a single engine of the same total "
                             "capacity at the same kill rate")
    parser.add_argument("--kill-rate", type=float, default=0.05,
                        help="per-decode-dispatch replica crash probability "
                             "for --fleet --chaos (each replica draws from "
                             "its own seeded stream)")
    parser.add_argument("--kills-per-replica", type=int, default=None,
                        help="fire budget of each replica's crash clause; "
                             "default 2 for --fleet --chaos, 1 for the "
                             "--disagg chaos arm")
    parser.add_argument("--capsule-dir", default=None, metavar="DIR",
                        help="keep the flight-recorder incident capsules the "
                             "--chaos arms write under DIR/{clean,chaos} "
                             "(inspect with accelerate-tpu capsule-report); "
                             "default: a temp dir, summarized into the "
                             "artifact and deleted")
    parser.add_argument("--loads", default="0.5,1.0,2.0,4.0",
                        help="comma-separated offered-load sweep for "
                             "--trace-curves")
    parser.add_argument("--disagg", default=None, metavar="P:D",
                        help="run the disaggregated prefill/decode proof: P "
                             "prefill + D decode replicas behind the "
                             "DisaggRouter vs a same-chip (P+D)-replica MIXED "
                             "fleet at --load offered load, plus a chaos arm "
                             "(replica crash clauses) — write BENCH_DISAGG."
                             "json to --disagg-out. Exit non-zero on any "
                             "silently-lost request or stream mismatch (full "
                             "runs also gate the decode-stall / TTFT "
                             "improvements)")
    parser.add_argument("--disagg-out", default="BENCH_DISAGG.json",
                        metavar="OUT_JSON",
                        help="artifact path for --disagg")
    parser.add_argument("--autoscale", default=None, metavar="OUT_JSON",
                        help="run the closed-loop autoscaling proof: one "
                             "diurnal swing trace replayed static-small / "
                             "static-peak / autoscaled on a shared virtual "
                             "clock (plus steady no-thrash, tenant-flood "
                             "bounded-events and crash-mid-scale-down chaos "
                             "arms) and write BENCH_AUTOSCALE.json to this "
                             "path. Gates: autoscaled attainment within band "
                             "of the peak arm at strictly fewer replica-"
                             "hours, zero silently-lost in every arm, "
                             "byte-identical streams, bounded scale events")
    parser.add_argument("--autoscale-min", type=int, default=1,
                        help="autoscaler floor / static-small fleet size")
    parser.add_argument("--autoscale-max", type=int, default=3,
                        help="autoscaler ceiling / static-peak fleet size")
    parser.add_argument("--swing-ratio", type=float, default=4.0,
                        help="peak:trough offered-load ratio of the "
                             "--autoscale swing trace")
    parser.add_argument("--device", default=None,
                        help="torch device of the engines (default: the CUDA card; "
                             "'cpu' to run on the CPU)")
    parser.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                        help="model dtype (default: the preset's; 'smoke' is float32)")
    if subparsers is not None:
        parser.set_defaults(func=serve_bench_command)
    return parser


def _calibrated_iat(max_slots: int, output_range=(4, 16)) -> float:
    """Mean inter-arrival (virtual seconds = engine steps) that saturates the
    engine at offered load 1.0: one request costs ~mean(output) decode steps of
    one lane, so capacity is ``max_slots / mean_output`` requests per step.

    The (4, 16) midpoint of 10 matches the measured mean output length of every
    generator within 3% — including heavy_tail, whose Pareto(1.3) draw clamped
    to (4, 32) lands at ~9.7 — so one calibration labels every sweep's load
    axis honestly."""
    mean_out = (output_range[0] + output_range[1]) / 2.0
    return mean_out / max(1, max_slots)


def _model(preset: str, max_len: int, device=None, dtype=None, params=None):
    """``(cfg, params)`` of one bench: ``preset`` is ``smoke`` (the tiny CI shape at
    fp32, as the JAX bench's) or a ``llama.CONFIGS`` key, with ``max_seq`` set to
    ``max_len`` and ``dtype`` (when given) replacing the preset's. ``params`` are
    used as given (several benches can share one set), else the port's seeded
    ``init_params`` on ``device`` (default: the CUDA card)."""
    import dataclasses

    from ..models import llama
    from ..utils.device import resolve_device

    if preset == "smoke":
        import torch

        cfg = dataclasses.replace(
            llama.CONFIGS["tiny"], vocab_size=512, d_model=128, n_layers=2,
            n_heads=4, n_kv_heads=2, d_ff=256, dtype=torch.float32,
        )
    elif preset in llama.CONFIGS:
        cfg = llama.CONFIGS[preset]
    else:
        raise ValueError(
            f"unknown preset {preset!r}; expected 'smoke' or one of "
            f"{sorted(llama.CONFIGS)}"
        )
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, max_seq=max_len)
    if params is None:
        params = llama.init_params(cfg, device=resolve_device(device))
    return cfg, params


def _engine(params, cfg, max_new_tokens: int, engine_hook=None, **engine_kw):
    """One ``ContinuousBatcher`` of a bench: on the card it captures, before any
    request, every graph a request of up to ``max_new_tokens`` new tokens can dispatch
    (``warm_programs``), so no capture falls inside traffic; then
    ``engine_hook(engine)`` sees it."""
    from ..serving import ContinuousBatcher

    engine = ContinuousBatcher(params, cfg, **engine_kw)
    if engine.device.type == "cuda":
        engine.warm_programs(max_new_tokens=max_new_tokens)
    if engine_hook is not None:
        engine_hook(engine)
    return engine


def _workload(n: int, vocab: int, bucket: int, high_frac: float, seed: int,
              kind: str = "mixed"):
    """The deterministic burst every policy row replays: (prompt, is_high, tenant).

    ``kind="repeat"`` draws low-entropy prompts (one or two tokens tiled) — the
    token-level shape of extraction/echo traffic, which tends to drive greedy decode
    into repetitive attractors that prompt-lookup drafting can actually predict;
    ``"mixed"`` is the classic uniform-random burst (near-incompressible, the
    n-gram drafter's worst case)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(3, bucket + 1))
        if kind == "repeat":
            base = rng.integers(1, vocab, int(rng.integers(1, 3)))
            prompt = np.tile(base, length)[:length].astype(np.int32)
        else:
            prompt = rng.integers(1, vocab, length).astype(np.int32)
        is_high = bool(rng.random() < high_frac)
        tenant = f"tenant{int(rng.integers(0, 3))}"
        out.append((prompt, is_high, tenant))
    return out


class _OracleDrafter(DraftSource):
    """Bench-only ``DraftSource``: proposes each request's PRECOMPUTED greedy
    continuation — an always-accepted draft at zero draft cost, i.e. the engine's
    verify-side throughput CEILING at acceptance 1.0.

    Random smoke weights make any real drafter's measured acceptance
    meaningless-by-construction (the ``speculative_tpu.py`` rationale); this row
    isolates what the batched verify mechanism delivers when acceptance is there,
    and real deployments interpolate by their measured acceptance (the
    ``spec_accept_rate`` column the ngram/half rows stamp)."""

    def __init__(self, refs: dict):
        self.refs = refs  # prompt bytes -> np.ndarray reference continuation

    def propose(self, lanes, pending, positions, k):
        import numpy as np

        out = np.zeros((len(lanes), k), np.int32)
        for i, req in enumerate(lanes):
            if req is None:
                continue
            ref = self.refs[req.prompt.tobytes()]
            t = len(req.tokens)
            cont = ref[t:t + k]
            out[i, :len(cont)] = cont
            if len(cont) < k:
                out[i, len(cont):] = ref[-1] if len(ref) else 0
        return out


def _build_drafter(spec_draft, target_params, target_cfg, draft_params=None):
    """A ``spec_decode.DraftSource`` for one bench engine (the counterpart of JAX's
    ``compile_cache.warmup.build_drafter``): ``None``/``"ngram"`` → the model-free
    prompt-lookup drafter; ``"half"`` → a half-depth copy of the target config over
    ``draft_params`` (default: the port's seeded ``init_params`` of that config on the
    target's device)."""
    import dataclasses

    from ..spec_decode import ModelDrafter, NgramDrafter

    if spec_draft in (None, "ngram"):
        return NgramDrafter()
    if spec_draft == "half":
        from ..models import llama

        d_cfg = dataclasses.replace(
            target_cfg, n_layers=max(1, target_cfg.n_layers // 2)
        )
        if draft_params is None:
            draft_params = llama.init_params(d_cfg, device=target_params["embed"].device)
        return ModelDrafter(draft_params, d_cfg)
    raise ValueError(f"spec_draft={spec_draft!r}: expected 'ngram' or 'half'")


def _oracle_refs(params, cfg, prompts, max_new: int, spec_k: int, engine_hook=None,
                 **engine_kw) -> dict:
    """The oracle drafter's references: each distinct prompt's ``max_new`` greedy
    tokens from a drain of an engine with the oracle row's layout (``engine_kw``) and
    ``spec_k`` under the n-gram drafter, so every reference token comes from the same
    ``[B, spec_k+1]`` verify the oracle row runs. A verify row's logits do not depend on
    its row index or on whether the drafts before it were accepted, so the oracle row
    reproduces them bitwise: at bf16 neither ``llama.generate`` (dense einsum attention)
    nor a one-token decode (``T = 1`` shapes) rounds as the verify does. The engine is
    built by :func:`_engine` like every other engine of the bench."""
    import numpy as np

    engine = _engine(params, cfg, max_new, engine_hook, spec_k=spec_k, **engine_kw)
    reqs = {}
    for prompt in prompts:
        if prompt.tobytes() not in reqs:
            reqs[prompt.tobytes()] = engine.submit(prompt, max_new_tokens=max_new)
    engine.run()
    return {key: np.asarray(req.tokens, np.int32) for key, req in reqs.items()}


def run_serve_bench(
    policies=ALL_POLICIES,
    preset: str = "smoke",
    requests: int = 48,
    max_slots: int = 4,
    max_len: int = 128,
    prompt_bucket: int = 16,
    max_new: int = 16,
    overload: float = 4.0,
    high_frac: float = 0.25,
    deadline_tight: float = 15.0,
    deadline_loose: float = 120.0,
    seed: int = 0,
    spec_k: int = 0,
    spec_draft: str = "ngram",
    workload: str = "mixed",
    page_size: int = 0,
    kv_pages=None,
    decode_steps: int = 1,
    telemetry=None,
    device=None,
    dtype=None,
    params=None,
    draft_params=None,
    engine_hook=None,
) -> list:
    """Run the burst once per policy; returns one SLO row dict per policy.

    ``spec_k > 0`` runs every policy row with batched speculative decoding
    (output-identical by construction) and stamps ``spec_accept_rate`` /
    ``tokens_per_step`` next to TTFT/TPOT, so the speculative TPOT claim lands
    in artifacts rather than prose. ``device``/``dtype``/``params``: see
    :func:`_model`; ``draft_params``: the ``half`` drafter's weights (see
    :func:`_build_drafter`); ``engine_hook``: see :func:`_engine`."""
    import time

    from ..serving_gateway import ServingGateway
    from ..telemetry.provenance import provenance_stamp
    from ..telemetry.slo import latency_summary
    from ..utils.dataclasses import GatewayConfig

    cfg, params = _model(preset, max_len, device, dtype, params)
    burst = _workload(requests, cfg.vocab_size, prompt_bucket, high_frac, seed,
                      kind=workload)
    max_queue = max(1, int(overload * max_slots))
    prov = provenance_stamp(cfg)
    layout = dict(max_slots=max_slots, max_len=max_len, prompt_bucket=prompt_bucket,
                  page_size=page_size, kv_pages=kv_pages)

    oracle_refs = None
    if spec_k and spec_draft == "oracle":
        # Reference continuations for the oracle ceiling row, computed BEFORE any
        # timed row (greedy decode is deterministic).
        oracle_refs = _oracle_refs(params, cfg, [p for p, _, _ in burst], max_new,
                                   spec_k, engine_hook, **layout)

    def fresh_engine():
        if not spec_k:
            drafter = None
        elif spec_draft == "oracle":
            drafter = _OracleDrafter(oracle_refs)
        else:
            # A drafter binds to ONE engine (per-slot draft cache): fresh per row.
            drafter = _build_drafter(spec_draft, params, cfg, draft_params)
        return _engine(params, cfg, max_new, engine_hook, **layout, spec_k=spec_k,
                       drafter=drafter, decode_steps=decode_steps)

    rows = []
    for policy in policies:
        gw = ServingGateway(
            fresh_engine(),
            GatewayConfig(
                enabled=True, policy=policy, max_queue=max_queue,
                overload="shed", aging_s=5.0, decode_steps=decode_steps,
            ),
            telemetry=telemetry,
        )
        t0 = time.perf_counter()
        greqs = []
        pending = list(burst)
        # Paced arrivals (one per decode step) rather than a single burst: the
        # queue stays saturated at its bound while draining, so every policy sees
        # the same sustained overload and admits a comparable high-priority set —
        # a burst would let FIFO reject late high arrivals outright and its
        # "admitted-high TTFT" would be survivor-biased toward the lucky early ones.
        while pending or gw.queue_depth or gw.running_count:
            if pending:
                prompt, is_high, tenant = pending.pop(0)
                greqs.append(gw.submit(
                    prompt, max_new_tokens=max_new,
                    priority=2 if is_high else 0,
                    deadline_s=deadline_tight if is_high else deadline_loose,
                    tenant=tenant,
                ))
            gw.step()
        if telemetry is not None:
            gw.emit_slo_record()
        wall_s = time.perf_counter() - t0

        done = [r for r in greqs if r.status == "done"]
        high_done = [r for r in done if r.priority > 0]
        summary = gw.slo_summary()
        counters = gw.counters
        estats = gw.engine.stats()
        rows.append({
            "metric": f"serve/{policy}" + (f"/spec{spec_k}" if spec_k else ""),
            "policy": policy,
            "preset": preset,
            "requests": requests,
            "max_slots": max_slots,
            "max_queue": max_queue,
            "overload": overload,
            "workload": workload,
            "spec_k": spec_k,
            "spec_draft": spec_draft if spec_k else None,
            "decode_steps": decode_steps,
            "spec_accept_rate": estats["spec_accept_rate"],
            "tokens_per_step": estats["tokens_per_step"],
            "wall_s": round(wall_s, 3),
            "tokens_generated": sum(len(r.tokens) for r in done),
            "tokens_per_sec": round(
                sum(len(r.tokens) for r in done) / wall_s, 1
            ) if wall_s > 0 else None,
            "done": counters["done"],
            "rejected": counters["rejected"],
            "shed": counters["shed"],
            "expired": counters["expired"],
            "ttft": summary["ttft_s"],
            "ttft_high": latency_summary([r.ttft_s for r in high_done]),
            "tpot": summary["tpot_s"],
            "queue_wait": summary["queue_wait_s"],
            "provenance": prov,
            **_kv_columns(gw.engine, estats),
        })
    return rows


#: Curve generators the BENCH_TRACE.json artifact sweeps by default: the bursty
#: baseline plus the adversarial multi-tenant scenario.
CURVE_GENERATORS = ("poisson", "tenant_flood")

#: Offered-load factors of the default sweep (0.5 = half capacity ... 4.0 = 4x).
CURVE_LOADS = (0.5, 1.0, 2.0, 4.0)


class _ChaosObservability:
    """One chaos-bench arm's live observability stack: a fresh enabled
    ``Telemetry`` (forwarding to the caller's, when one was passed) and an
    :class:`~..telemetry.alerts.AlertEngine` on the stock rule set over the
    GATEWAY'S OWN metrics plane — the replay constructs its gateway/router
    with ``GatewayConfig(metrics=True, metrics_window_s=...)``, so the plane
    rides the production wiring on the replay's virtual clock (windows
    measure virtual seconds, same time domain as deadlines and spans), and
    :meth:`attach` only adds the rule engine. The proof surface: the chaos
    arm must raise the expected ``alert/v1`` set, the clean arm must raise
    none.

    The thresholds are explicit, not the library defaults: the smoke traces
    legitimately shed a few percent at their calibrated load, so the burn
    gate is set where only injected-fault failure rates (>30% of the error
    budget at objective 0.9) can reach it."""

    #: The plane horizon the replay's gateway is configured with — the slow
    #: burn window must fit inside it (AlertEngine validates this).
    WINDOW_S = 120.0

    def __init__(self, forward_to=None, capsule_dir=None):
        from ..telemetry import Telemetry
        from ..utils.dataclasses import TelemetryConfig

        self.capsule_dir = capsule_dir
        self.telemetry = Telemetry(TelemetryConfig(
            enabled=True, compile_events=False, memory_stats=False,
            recorder=capsule_dir is not None, capsule_dir=capsule_dir,
        ))
        if forward_to is not None and getattr(forward_to, "enabled", False):
            self.telemetry.sinks.append(forward_to.emit)
        self.plane = None
        self.alerts = None

    def attach(self, plane) -> None:
        """Arm the rule engine on the gateway-built plane (called right after
        gateway construction, before any record flows)."""
        from ..telemetry.alerts import AlertEngine, default_alert_rules

        self.plane = plane
        self.alerts = AlertEngine(
            plane,
            default_alert_rules(objective=0.9, fast_window_s=30.0,
                                slow_window_s=self.WINDOW_S,
                                burn_threshold=3.0, fault_window_s=60.0),
            eval_interval_s=1.0,
        )

    def summary(self) -> dict:
        stats = self.plane.stats()
        out = {
            "metrics": {k: stats[k] for k in
                        ("records_consumed", "counters", "gauges", "slo")},
            "alerts": self.alerts.summary(),
        }
        recorder = getattr(self.telemetry, "recorder", None)
        if recorder is not None:
            out["recorder"] = recorder.stats()
        return out

    def fired_rules(self) -> set:
        return {r["rule"] for r in self.alerts.fired if r["state"] == "firing"}


def _capsule_summary(capsule_dir, expected_sites=(), expected_alerts=()):
    """The capsule coverage block a chaos artifact carries: every capsule
    under ``capsule_dir`` reconstructed via :func:`~.capsule_report.
    capsule_report` and reduced to the gateable facts — how many capsules,
    which triggers, whether every injected fault site and every fired alert
    rule is named by at least one capsule's report. The bench gates on this
    (``capsules_chaos_expected`` / ``capsules_clean_zero``), which makes the
    capsule path a tier-1 proof surface, not best-effort debugging output."""
    from ..telemetry.recorder import list_capsules, load_capsule
    from .capsule_report import capsule_report

    reports = [capsule_report(load_capsule(p))
               for p in list_capsules(capsule_dir)]
    sites, kinds, alerts = set(), set(), set()
    for r in reports:
        sites.update(r["fault_sites"])
        kinds.update(r["fault_kinds"])
        alerts.update(r["alerts_fired"])
    return {
        "count": len(reports),
        "triggers": sorted({r["trigger"] for r in reports}),
        "fault_sites": sorted(sites),
        "fault_kinds": sorted(kinds),
        "alerts": sorted(alerts),
        "sites_covered": set(expected_sites) <= sites,
        "alerts_covered": set(expected_alerts) <= alerts,
    }


def _replay_one_policy(params, cfg, policy, trace, *, max_slots, max_len,
                       prompt_bucket, max_queue, load, step_dt, seed,
                       page_size=0, kv_pages=None, telemetry=None,
                       faults=None, on_token_factory=None,
                       observability=None, engine_hook=None):
    """One fresh engine + gateway + virtual-clock replay of ``trace`` under
    ``policy`` → ``(gateway, gateway requests)``. The ONE construction both the
    per-policy rows and the attainment curves run, so they can never measure
    different gateway configurations. ``faults`` arms the engine's fault
    boundary with an injected plan (the chaos arm); ``on_token_factory(i)``
    builds a per-request streaming callback (chaos stream-parity capture);
    ``observability`` (a :class:`_ChaosObservability`) supplies the arm's
    telemetry and is bound to the replay's virtual clock. ``engine_hook(engine)``
    sees the engine after its warm-up, before any request."""
    from ..serving_gateway import ServingGateway
    from ..serving_gateway.workload import VirtualClock, replay_trace
    from ..telemetry.tracing import Tracer
    from ..utils.dataclasses import GatewayConfig

    clock = VirtualClock()
    if observability is not None:
        telemetry = observability.telemetry
    tracer = Tracer(telemetry, clock=clock) if telemetry is not None else None
    engine = _engine(
        params, cfg, max(r.output_len for r in trace), engine_hook, max_slots=max_slots,
        max_len=max_len,
        prompt_bucket=prompt_bucket, page_size=page_size, kv_pages=kv_pages,
        tracer=tracer, faults=faults, telemetry=telemetry,
    )
    gw = ServingGateway(
        engine,
        GatewayConfig(enabled=True, policy=policy, max_queue=max_queue,
                      overload="shed", aging_s=5.0,
                      metrics=observability is not None,
                      metrics_window_s=(observability.WINDOW_S
                                        if observability is not None
                                        else 300.0)),
        telemetry=telemetry, clock=clock, tracer=tracer,
    )
    if observability is not None:
        observability.attach(gw.metrics)
    greqs = replay_trace(gw, trace, cfg.vocab_size, clock,
                         step_dt=step_dt, load=load, seed=seed,
                         on_token_factory=on_token_factory)
    if telemetry is not None:
        gw.emit_slo_record()
    return gw, greqs


def run_trace_replay(
    trace,
    policies=ALL_POLICIES,
    preset: str = "smoke",
    max_slots: int = 4,
    max_len: int = 128,
    prompt_bucket: int = 16,
    overload: float = 4.0,
    load: float = 1.0,
    step_dt: float = 1.0,
    seed: int = 0,
    generator: str = "custom",
    telemetry=None,
    page_size: int = 0,
    kv_pages=None,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> list:
    """Replay one workload trace through every policy on a VIRTUAL clock; one
    row per policy stamping SLO percentiles, deadline attainment, the trace
    content hash and run provenance.

    Unlike :func:`run_serve_bench`'s paced burst (apples-to-apples policy
    geometry), a trace replay presents the trace's own arrival process —
    bursts, floods, ramps — time-compressed by ``load``. Latencies are in
    VIRTUAL seconds (1.0 = one engine step), so rows are deterministic and
    host-speed-independent. ``device``/``dtype``/``params``: see :func:`_model`;
    ``engine_hook``: see :func:`_engine`."""
    from ..serving_gateway.workload import trace_hash
    from ..telemetry.provenance import provenance_stamp

    cfg, params = _model(preset, max_len, device, dtype, params)
    max_queue = max(1, int(overload * max_slots))
    thash = trace_hash(trace)
    prov = provenance_stamp(cfg)

    rows = []
    for policy in policies:
        gw, greqs = _replay_one_policy(
            params, cfg, policy, trace, max_slots=max_slots, max_len=max_len,
            prompt_bucket=prompt_bucket, max_queue=max_queue, load=load,
            step_dt=step_dt, seed=seed, page_size=page_size, kv_pages=kv_pages,
            telemetry=telemetry, engine_hook=engine_hook,
        )
        rows.append({
            "metric": f"serve_trace/{generator}/{policy}",
            "policy": policy,
            "generator": generator,
            "preset": preset,
            "requests": len(trace),
            "max_slots": max_slots,
            "max_queue": max_queue,
            "step_dt": step_dt,
            "workload_trace_hash": thash,
            "provenance": prov,
            **_attainment_point(gw, greqs, load),
        })
    return rows


def _attainment_point(gw, greqs, load: float) -> dict:
    """One curve point: deadline attainment (all + high-priority class), TTFT
    percentiles, admission accounting — computed over EVERY submitted request
    (a shed/rejected/expired request is an SLO failure, not a missing sample)."""
    from ..telemetry.slo import latency_summary

    with_deadline = [r for r in greqs if r.deadline_at is not None]
    high = [r for r in greqs if r.priority > 0]
    high_deadline = [r for r in high if r.deadline_at is not None]

    def met_frac(rs):
        if not rs:
            return None
        return round(sum(bool(r.deadline_met) for r in rs) / len(rs), 4)

    counters = gw.counters
    ttfts = [r.ttft_s for r in greqs if r.status == "done"]
    return {
        "offered_load": load,
        "attainment": met_frac(with_deadline),
        "attainment_high": met_frac(high_deadline),
        "done": counters["done"],
        "rejected": counters["rejected"],
        "shed": counters["shed"],
        "expired": counters["expired"],
        "ttft": latency_summary(ttfts),
        "ttft_high": latency_summary(
            [r.ttft_s for r in high if r.status == "done"]
        ),
        "queue_wait": gw.slo_summary()["queue_wait_s"],
    }


def run_trace_curves(
    generators=CURVE_GENERATORS,
    policies=ALL_POLICIES,
    loads=CURVE_LOADS,
    requests: int = 64,
    preset: str = "smoke",
    max_slots: int = 4,
    max_len: int = 128,
    prompt_bucket: int = 16,
    overload: float = 4.0,
    seed: int = 0,
    step_dt: float = 1.0,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """SLO-attainment-vs-offered-load curves: for each (generator, policy) pair,
    replay the SAME trace at each load factor on the virtual clock and record deadline
    attainment — the BENCH_TRACE.json artifact, stamped with trace hash + provenance so
    every curve names the commit, config and arrival process that produced it.
    ``device``/``dtype``/``params``: see :func:`_model`; ``engine_hook``: see
    :func:`_engine` (one fresh engine per point)."""
    from ..serving_gateway.workload import generate_workload, trace_hash
    from ..telemetry.provenance import provenance_stamp

    cfg, params = _model(preset, max_len, device, dtype, params)
    max_queue = max(1, int(overload * max_slots))
    mean_iat = _calibrated_iat(max_slots)
    prov = provenance_stamp(cfg)

    curves = []
    for generator in generators:
        trace = generate_workload(generator, requests, seed=seed,
                                  mean_iat_s=mean_iat)
        thash = trace_hash(trace)
        for policy in policies:
            points = []
            for load in loads:
                gw, greqs = _replay_one_policy(
                    params, cfg, policy, trace, max_slots=max_slots,
                    max_len=max_len, prompt_bucket=prompt_bucket,
                    max_queue=max_queue, load=load, step_dt=step_dt,
                    seed=seed, engine_hook=engine_hook,
                )
                points.append(_attainment_point(gw, greqs, load))
            curves.append({
                "generator": generator,
                "policy": policy,
                "workload_trace_hash": thash,
                "provenance": prov,
                "points": points,
            })
    return {
        "schema": "accelerate_tpu.bench.trace/v1",
        "preset": preset,
        "requests": requests,
        "max_slots": max_slots,
        "max_queue": max_queue,
        "mean_iat_s": round(mean_iat, 4),
        "step_dt": step_dt,
        "loads": list(loads),
        "seed": seed,
        "provenance": prov,
        "curves": curves,
    }


def _chaos_arm_summary(gw, greqs) -> dict:
    """One chaos-bench arm's accounting: terminal disposition of EVERY
    submitted request (a uid with no terminal state would be a silent loss —
    the thing the fault boundary exists to prevent), availability, latency
    percentiles, and the engine's recovery counters."""
    from ..telemetry.slo import latency_summary

    counters = gw.counters
    estats = gw.engine.stats()
    submitted = len(greqs)
    terminal = sum(1 for g in greqs if g.terminal)
    done = [g for g in greqs if g.status == "done"]
    return {
        "submitted": submitted,
        "terminal": terminal,
        "silently_lost": submitted - terminal,
        "done": counters["done"],
        "failed": counters["failed"],
        "shed": counters["shed"],
        "rejected": counters["rejected"],
        "expired": counters["expired"],
        "availability": round(counters["done"] / max(1, submitted), 4),
        "recovered_requests": sum(
            1 for g in done if getattr(g, "recoveries", 0) > 0
        ),
        "ttft": latency_summary([g.ttft_s for g in done]),
        "tpot": latency_summary([g.tpot_s for g in done]),
        "engine": {
            "decode_steps": estats["decode_steps"],
            "step_failures": estats["step_failures"],
            "step_fault_rate": round(
                estats["step_failures"] / max(1, estats["decode_steps"]), 4
            ),
            "quarantined": estats["quarantined"],
            "recovered_admissions": estats["recovered_admissions"],
            "bisect_rounds": estats["bisect_rounds"],
        },
    }


#: Fault sites ``--chaos-sites`` may include, mapped to the FaultSpec site
#: names.
CHAOS_SITES = {
    "decode": "serving.decode",
    "prefill": "serving.prefill",
    "kv_admit": "serving.kv_admit",
}


def _chaos_plan(sites, chaos_rate: float, seed: int):
    """The seeded chaos plan: one ``error`` clause per requested site, all at
    the same per-invocation rate. Decode failures are unattributed (they
    exercise bisection); prefill/kv_admit failures are attributable by
    construction (the fault fires admitting exactly one request)."""
    from ..resilience.faults import FaultPlan, FaultSpec

    specs = []
    for site in sites:
        if site not in CHAOS_SITES:
            raise ValueError(
                f"unknown chaos site {site!r} (known: {sorted(CHAOS_SITES)})"
            )
        specs.append(FaultSpec(
            CHAOS_SITES[site], "error", prob=chaos_rate,
            attributed=site != "decode",
        ))
    return FaultPlan(specs, seed=seed)


def run_chaos_bench(
    preset: str = "smoke",
    requests: int = 32,
    max_slots: int = 4,
    max_len: int = 128,
    prompt_bucket: int = 16,
    overload: float = 4.0,
    load: float = 1.0,
    step_dt: float = 1.0,
    seed: int = 0,
    policy: str = "fifo",
    chaos_rate: float = 0.15,
    generator: str = "poisson",
    chaos_sites=("decode",),
    page_size: int = 0,
    kv_pages=None,
    telemetry=None,
    capsule_dir=None,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """The chaos proof (BENCH_CHAOS.json): replay ONE workload trace twice —
    clean, then under a seeded ``FaultPlan`` failing ``chaos_rate`` of the
    dispatches at each requested fault site (``chaos_sites``: decode, and
    optionally prefill admissions and paged kv_admit allocations) — and stamp
    what recovery delivered: zero silently-lost requests (every submitted uid
    reaches a machine-readable terminal state), recovered-request token
    streams BYTE-IDENTICAL to the clean replay (asserted per request, stamped
    as ``streams_identical``), availability, per-site fire counts, and
    faulted-vs-clean p95 TTFT/TPOT on the shared virtual clock.

    Both arms run with the flight recorder armed (``capsule_dir``, a temp dir
    when not given): the chaos arm must produce a capsule naming every
    injected fault site and every fired alert rule; the clean arm must
    produce ZERO. Stamped as ``capsules``/``capsules_clean_zero``/
    ``capsules_chaos_expected`` and gated by the CLI.

    At bf16 a recovered request re-prefills its context with the prefill programs,
    whose rounding is not the decode steps', so a survivor can leave the clean
    stream at a near tie: ``streams_mismatched`` counts such requests and
    ``mismatched_requests`` holds, per one, its trace row, both streams and the token
    counts it kept at each recovery re-admission (the engine's ``readmit`` records),
    for the caller's near-tie check. At fp32 the streams are identical."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from ..serving_gateway.workload import generate_workload, trace_hash
    from ..telemetry.provenance import provenance_stamp
    from ..telemetry.schemas import RECOVERY_SCHEMA

    if not 0.0 < chaos_rate <= 1.0:
        raise ValueError(f"chaos_rate={chaos_rate} must be in (0, 1]")
    chaos_sites = tuple(chaos_sites)
    if "kv_admit" in chaos_sites and not page_size:
        # The kv_admit site only exists on a paged engine: the whole bench runs
        # paged, so both arms share one layout.
        page_size = 8
    cfg, params = _model(preset, max_len, device, dtype, params)
    max_queue = max(1, int(overload * max_slots))
    mean_iat = _calibrated_iat(max_slots)
    trace = generate_workload(generator, requests, seed=seed,
                              mean_iat_s=mean_iat)
    prov = provenance_stamp(cfg)


    common = dict(max_slots=max_slots, max_len=max_len,
                  prompt_bucket=prompt_bucket, max_queue=max_queue, load=load,
                  step_dt=step_dt, seed=seed, page_size=page_size,
                  kv_pages=kv_pages, telemetry=telemetry, engine_hook=engine_hook)
    # Per-arm metrics plane + alert engine : the
    # SAME rule set watches both arms; the chaos arm must fire the fault-burst
    # (and, under enough injected failure, SLO-burn) alerts, the clean arm
    # must stay silent.
    capsule_root = capsule_dir or tempfile.mkdtemp(prefix="chaos-capsules-")
    obs_clean = _ChaosObservability(
        forward_to=telemetry,
        capsule_dir=os.path.join(capsule_root, "clean"))
    obs_chaos = _ChaosObservability(
        forward_to=telemetry,
        capsule_dir=os.path.join(capsule_root, "chaos"))
    clean_streams, clean_factory = _stream_capture()
    gw_clean, greqs_clean = _replay_one_policy(
        params, cfg, policy, trace, on_token_factory=clean_factory,
        observability=obs_clean, **common
    )
    plan = _chaos_plan(chaos_sites, chaos_rate, seed)
    chaos_streams, chaos_factory = _stream_capture()
    # The chaos engine's uid of each prompt: its ``readmit`` records name engine uids.
    prompt_of_uid = {}

    def chaos_hook(engine):
        submit = engine.submit

        def recording_submit(prompt, *args, **kwargs):
            req = submit(prompt, *args, **kwargs)
            prompt_of_uid[req.uid] = np.asarray(prompt).tobytes()
            return req

        engine.submit = recording_submit
        if engine_hook is not None:
            engine_hook(engine)

    gw_chaos, greqs_chaos = _replay_one_policy(
        params, cfg, policy, trace, faults=plan,
        on_token_factory=chaos_factory, observability=obs_chaos,
        **{**common, "engine_hook": chaos_hook}
    )

    # Stream parity: every request DONE in both arms must have produced the
    # byte-identical token stream (greedy decode + deterministic prompts —
    # recovery must never change WHAT is generated, only when).
    compared = mismatched = 0
    mismatched_rows = []
    for i in range(len(trace)):
        if (i < len(greqs_clean) and i < len(greqs_chaos)
                and greqs_clean[i].status == "done"
                and greqs_chaos[i].status == "done"):
            compared += 1
            if clean_streams.get(i) != chaos_streams.get(i):
                mismatched += 1
                mismatched_rows.append(i)
    readmits = {}
    for rec in obs_chaos.telemetry.records:
        if rec.get("schema") == RECOVERY_SCHEMA and rec.get("action") == "readmit":
            readmits.setdefault(prompt_of_uid[rec["uid"]], []).append(rec["tokens_kept"])
    mismatched_rows = [
        {"row": i, "clean": clean_streams[i], "chaos": chaos_streams[i],
         "readmitted_with": readmits.get(np.asarray(greqs_chaos[i].prompt).tobytes(), [])}
        for i in mismatched_rows]
    clean_arm = {**_chaos_arm_summary(gw_clean, greqs_clean),
                 **obs_clean.summary()}
    chaos_arm = {**_chaos_arm_summary(gw_chaos, greqs_chaos),
                 **obs_chaos.summary()}
    # Incident capsules: every injected fault site must be named by at least
    # one capsule's report (fault:<site> captures are never cooldown-
    # suppressed on first fire), every fired alert rule by an alert:<rule>
    # capsule; the clean arm — same trace, same rules, recorder armed — must
    # write none.
    capsules_clean = _capsule_summary(os.path.join(capsule_root, "clean"))
    capsules_chaos = _capsule_summary(
        os.path.join(capsule_root, "chaos"),
        expected_sites=plan.stats()["by_site"],
        expected_alerts=obs_chaos.fired_rules(),
    )
    if capsule_dir is None:
        shutil.rmtree(capsule_root, ignore_errors=True)
    return {
        "schema": "accelerate_tpu.bench.chaos/v1",
        "preset": preset,
        "policy": policy,
        "generator": generator,
        "requests": requests,
        "max_slots": max_slots,
        "max_queue": max_queue,
        "load": load,
        "chaos_rate": chaos_rate,
        "chaos_sites": list(chaos_sites),
        "page_size": page_size,
        "fault_plan": {"seed": seed,
                       "sites": [CHAOS_SITES[s] for s in chaos_sites],
                       "kind": "error", "prob": chaos_rate,
                       "fired": len(plan.fired),
                       "fired_by_site": plan.stats()["by_site"]},
        "workload_trace_hash": trace_hash(trace),
        "provenance": prov,
        "streams_compared": compared,
        "streams_identical": mismatched == 0,
        "streams_mismatched": mismatched,
        "mismatched_requests": mismatched_rows,
        # Alert-plane invariants (gated by the CLI like the stream ones): the
        # injected-fault arm must raise the fault-burst alert; the clean
        # replay of the SAME trace under the SAME rules must raise nothing.
        "alerts_clean_silent": not obs_clean.alerts.fired,
        "alerts_chaos_fired": sorted(obs_chaos.fired_rules()),
        "alerts_chaos_expected": "step-failure-burst" in obs_chaos.fired_rules(),
        # Capsule invariants (gated by the CLI): the chaos arm's flight
        # recorder must dump ≥1 capsule covering every injected site and
        # fired rule; the clean arm's recorder must dump zero.
        "capsules_clean": capsules_clean["count"],
        "capsules_clean_zero": capsules_clean["count"] == 0,
        "capsules": capsules_chaos,
        "capsules_chaos_expected": (capsules_chaos["count"] >= 1
                                    and capsules_chaos["sites_covered"]
                                    and capsules_chaos["alerts_covered"]),
        "clean": clean_arm,
        "chaos": chaos_arm,
    }


def _replay_fleet(params, cfg, policy, trace, *, n_replicas, max_slots,
                  max_len, prompt_bucket, max_queue, load, step_dt, seed,
                  plans=None, restart_backoff=0.0, replica_restarts=4,
                  telemetry=None, on_token_factory=None, observability=None,
                  engine_hook=None):
    """One fresh N-replica FleetRouter + virtual-clock replay of ``trace`` →
    ``(router, gateway requests)``. ``plans[rid]`` arms replica ``rid``'s
    engine with its own seeded FaultPlan (the kill schedule); restarted
    replicas keep their plan, so the whole chaos run stays deterministic.
    ``observability`` binds a per-arm metrics plane + alert engine to the
    replay's virtual clock (fault/recovery/health records flow from the
    engines and router into it). Every engine, the restarted ones included, is
    built by :func:`_engine` (warmed on the card, then ``engine_hook``)."""
    from ..serving_gateway import FleetRouter
    from ..serving_gateway.workload import VirtualClock, replay_trace
    from ..utils.dataclasses import GatewayConfig

    clock = VirtualClock()
    if observability is not None:
        telemetry = observability.telemetry

    def build_engine(rid):
        return _engine(
            params, cfg, max(r.output_len for r in trace), engine_hook,
            max_slots=max_slots, max_len=max_len, prompt_bucket=prompt_bucket,
            faults=None if plans is None else plans[rid],
            telemetry=telemetry,
        )

    router = FleetRouter(
        [build_engine(rid) for rid in range(n_replicas)],
        GatewayConfig(enabled=True, policy=policy, max_queue=max_queue,
                      overload="shed", aging_s=5.0, breaker_threshold=3,
                      replica_restarts=replica_restarts,
                      replica_restart_backoff=restart_backoff,
                      metrics=observability is not None,
                      metrics_window_s=(observability.WINDOW_S
                                        if observability is not None
                                        else 300.0)),
        telemetry=telemetry, clock=clock, engine_factory=build_engine,
    )
    if observability is not None:
        observability.attach(router.metrics)
    greqs = replay_trace(router, trace, cfg.vocab_size, clock,
                         step_dt=step_dt, load=load, seed=seed,
                         on_token_factory=on_token_factory)
    return router, greqs


def _fleet_arm_summary(router, greqs) -> dict:
    """One fleet-bench arm's accounting: terminal disposition of EVERY
    submitted request, availability, latency percentiles, migration/restart
    counters and the per-replica kill/restart history — plus the count of
    circuit-reason rejections, which the per-replica-isolation contract pins
    at zero while any replica stays healthy."""
    from ..telemetry.slo import latency_summary

    counters = router.counters
    submitted = len(greqs)
    terminal = sum(1 for g in greqs if g.terminal)
    done = [g for g in greqs if g.status == "done"]
    circuit_rejections = sum(
        1 for g in greqs if g.status == "rejected"
        and (g.reason or "").startswith(("circuit", "fleet_down"))
    )
    return {
        "submitted": submitted,
        "terminal": terminal,
        "silently_lost": submitted - terminal,
        "done": counters["done"],
        "failed": counters["failed"],
        "shed": counters["shed"],
        "rejected": counters["rejected"],
        "circuit_rejections": circuit_rejections,
        "expired": counters["expired"],
        "availability": round(counters["done"] / max(1, submitted), 4),
        "migrated": counters["migrated"],
        "replica_kills": counters["replica_kills"],
        "replica_restarts": counters["replica_restarts"],
        "replica_retired": counters["replica_retired"],
        "replayed_requests": sum(1 for g in greqs if g.replays > 0),
        "ttft": latency_summary([g.ttft_s for g in done]),
        "tpot": latency_summary([g.tpot_s for g in done]),
        "replicas": [
            {"replica": r["replica"], "state": r["state"],
             "restarts": r["restarts"],
             "breaker_openings": r["breaker_openings"]}
            for r in router.stats()["replicas"]
        ],
    }


def run_fleet_chaos_bench(
    n_replicas: int = 3,
    preset: str = "smoke",
    requests: int = 32,
    max_slots: int = 2,
    max_len: int = 128,
    prompt_bucket: int = 16,
    overload: float = 4.0,
    load: float = 1.0,
    step_dt: float = 1.0,
    seed: int = 0,
    policy: str = "fifo",
    kill_rate: float = 0.05,
    kills_per_replica: int = 2,
    restart_backoff: float = 2.0,
    generator: str = "poisson",
    telemetry=None,
    capsule_dir=None,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """The fleet resilience proof (BENCH_FLEET.json): replay ONE workload
    trace three ways on the shared virtual clock —

    1. **fleet_clean**: ``n_replicas`` replicas, no faults (the baseline);
    2. **fleet_chaos**: the same fleet, each replica armed with its OWN seeded
       crash clause (``kill_rate`` per decode dispatch, ``kills_per_replica``
       fire budget) — replicas die mid-trace, in-flight requests migrate via
       the replay path, the supervisor restarts them after ``restart_backoff``
       virtual seconds;
    3. **single_chaos**: ONE engine with the same TOTAL lane count and the
       same per-dispatch kill rate behind a 1-replica router — same capacity,
       same fault rate, one failure domain instead of N.

    Stamps: zero ``silently_lost``, migrated streams byte-identical to the
    undisturbed fleet (per-request capture with on_retry reset), availability
    per arm (the fleet must beat the single engine — the reason the router
    exists), zero circuit-reason rejections while a healthy replica remained,
    per-class deadline attainment, and the failover p95 TTFT penalty.

    Both observed arms run with the flight recorder armed: every replica kill
    must yield a capsule (``recovery:replica_died`` — crashes surface at the
    router, not as engine fault records — plus ``alert:replica-died``), and
    the clean fleet must write ZERO. Stamped and gated like the stream/alert
    invariants."""
    import os
    import shutil
    import tempfile

    from ..resilience.faults import FaultPlan, FaultSpec
    from ..serving_gateway.workload import generate_workload, trace_hash
    from ..telemetry.provenance import provenance_stamp

    if n_replicas < 2:
        raise ValueError(f"n_replicas={n_replicas} must be >= 2 (the single-"
                         "engine comparison arm is built automatically)")
    if not 0.0 < kill_rate <= 1.0:
        raise ValueError(f"kill_rate={kill_rate} must be in (0, 1]")
    cfg, params = _model(preset, max_len, device, dtype, params)
    total_lanes = n_replicas * max_slots
    max_queue = max(1, int(overload * total_lanes))
    mean_iat = _calibrated_iat(total_lanes)
    trace = generate_workload(generator, requests, seed=seed,
                              mean_iat_s=mean_iat)
    prov = provenance_stamp(cfg)

    def kill_plans(n):
        # Each replica draws its crash schedule from its own stream keyed off
        # (seed, rid): which replica dies, and when, depends only on the seed.
        return [
            FaultPlan([FaultSpec("serving.decode", "crash", prob=kill_rate,
                                 max_fires=kills_per_replica)],
                      seed=seed * 7919 + rid + 1)
            for rid in range(n)
        ]


    common = dict(max_len=max_len, prompt_bucket=prompt_bucket,
                  max_queue=max_queue, load=load, step_dt=step_dt, seed=seed,
                  restart_backoff=restart_backoff, telemetry=telemetry,
                  engine_hook=engine_hook)
    # Per-arm alert planes: the kill sequence must trip the breaker-open (and
    # fault-burst) alerts in the chaos arm; the clean fleet stays silent.
    capsule_root = capsule_dir or tempfile.mkdtemp(prefix="fleet-capsules-")
    obs_clean = _ChaosObservability(
        forward_to=telemetry,
        capsule_dir=os.path.join(capsule_root, "clean"))
    obs_chaos = _ChaosObservability(
        forward_to=telemetry,
        capsule_dir=os.path.join(capsule_root, "chaos"))
    clean_streams, clean_factory = _stream_capture()
    r_clean, g_clean = _replay_fleet(
        params, cfg, policy, trace, n_replicas=n_replicas,
        max_slots=max_slots, on_token_factory=clean_factory,
        observability=obs_clean, **common)
    chaos_streams, chaos_factory = _stream_capture()
    chaos_plans = kill_plans(n_replicas)
    r_chaos, g_chaos = _replay_fleet(
        params, cfg, policy, trace, n_replicas=n_replicas,
        max_slots=max_slots, plans=chaos_plans,
        on_token_factory=chaos_factory, observability=obs_chaos, **common)
    single_plans = kill_plans(1)
    r_single, g_single = _replay_fleet(
        params, cfg, policy, trace, n_replicas=1, max_slots=total_lanes,
        plans=single_plans, **common)

    compared = mismatched = 0
    for i in range(len(trace)):
        if (g_clean[i].status == "done" and g_chaos[i].status == "done"):
            compared += 1
            if clean_streams.get(i) != chaos_streams.get(i):
                mismatched += 1
    clean_arm = {**_fleet_arm_summary(r_clean, g_clean),
                 **_attainment_point(r_clean, g_clean, load),
                 **obs_clean.summary()}
    chaos_arm = {**_fleet_arm_summary(r_chaos, g_chaos),
                 **_attainment_point(r_chaos, g_chaos, load),
                 **obs_chaos.summary()}
    single_arm = {**_fleet_arm_summary(r_single, g_single),
                  **_attainment_point(r_single, g_single, load)}
    p95_clean = (clean_arm["ttft"] or {}).get("p95")
    p95_chaos = (chaos_arm["ttft"] or {}).get("p95")
    # Incident capsules: replica crashes raise EngineCrashed and surface at
    # the router as recovery/replica_died records (NOT engine fault records),
    # so the capsule gate here is count + fired-alert coverage — no fault-site
    # expectation, by construction of the crash path.
    capsules_clean = _capsule_summary(os.path.join(capsule_root, "clean"))
    capsules_chaos = _capsule_summary(
        os.path.join(capsule_root, "chaos"),
        expected_alerts=obs_chaos.fired_rules(),
    )
    if capsule_dir is None:
        shutil.rmtree(capsule_root, ignore_errors=True)
    return {
        "schema": "accelerate_tpu.bench.fleet/v1",
        "preset": preset,
        "policy": policy,
        "generator": generator,
        "requests": requests,
        "n_replicas": n_replicas,
        "max_slots_per_replica": max_slots,
        "total_lanes": total_lanes,
        "max_queue": max_queue,
        "load": load,
        "kill_plan": {"seed": seed, "site": "serving.decode", "kind": "crash",
                      "prob": kill_rate, "max_fires": kills_per_replica,
                      "restart_backoff_s": restart_backoff,
                      "fleet_fired": sum(len(p.fired) for p in chaos_plans),
                      "single_fired": sum(len(p.fired) for p in single_plans)},
        "workload_trace_hash": trace_hash(trace),
        "provenance": prov,
        "streams_compared": compared,
        "streams_identical": mismatched == 0,
        "streams_mismatched": mismatched,
        "failover_ttft_p95_penalty": (
            round(p95_chaos / p95_clean, 4)
            if p95_clean and p95_chaos else None
        ),
        "fleet_availability_above_single": (
            chaos_arm["availability"] > single_arm["availability"]
        ),
        # Alert-plane invariants: the kill sequence must raise the
        # replica-died alert (replica-unhealthy typically rides along while
        # the dead replica restarts); the clean fleet must stay silent.
        "alerts_clean_silent": not obs_clean.alerts.fired,
        "alerts_chaos_fired": sorted(obs_chaos.fired_rules()),
        "alerts_chaos_expected": "replica-died" in obs_chaos.fired_rules(),
        "capsules_clean": capsules_clean["count"],
        "capsules_clean_zero": capsules_clean["count"] == 0,
        "capsules": capsules_chaos,
        "capsules_chaos_expected": (capsules_chaos["count"] >= 1
                                    and capsules_chaos["alerts_covered"]),
        "fleet_clean": clean_arm,
        "fleet_chaos": chaos_arm,
        "single_chaos": single_arm,
    }


def _replay_autoscaled(params, cfg, policy, trace, *, n_start, max_slots,
                       max_len, prompt_bucket, max_queue, load, step_dt, seed,
                       controller, metrics_window_s=60.0,
                       on_token_factory=None, chaos=False, engine_hook=None):
    """One autoscaled arm: a FleetRouter born at ``n_start`` replicas with a
    live metrics plane and an :class:`Autoscaler` armed with the stock rule
    pair, replayed on a virtual clock → ``(router, scaler, greqs, kill)``.
    ``controller`` carries the Autoscaler kwargs plus a nested ``rules`` dict
    for :func:`default_autoscale_rules`. ``chaos=True`` crashes one replica
    the moment the FIRST scale-down decision lands — the drain victim itself
    while it still holds in-flight work, else the busiest survivor — so the
    arm proves a crash mid-scale-down still loses nothing. Every engine (the
    spawned ones included) is built by :func:`_engine`: on the card it captures its
    graphs before the router routes to it."""
    import numpy as np

    from ..serving_gateway import (ACTIVE, DRAINING, Autoscaler, FleetRouter,
                                   default_autoscale_rules)
    from ..serving_gateway.workload import VirtualClock
    from ..telemetry import Telemetry
    from ..utils.dataclasses import GatewayConfig, TelemetryConfig

    clock = VirtualClock()
    telemetry = Telemetry(TelemetryConfig(enabled=True, compile_events=False,
                                          memory_stats=False))

    def build_engine(rid):
        return _engine(
            params, cfg, max(r.output_len for r in trace), engine_hook,
            max_slots=max_slots, max_len=max_len, prompt_bucket=prompt_bucket,
            telemetry=telemetry,
        )

    router = FleetRouter(
        [build_engine(rid) for rid in range(n_start)],
        GatewayConfig(enabled=True, policy=policy, max_queue=max_queue,
                      overload="shed", aging_s=5.0, breaker_threshold=3,
                      replica_restarts=4, replica_restart_backoff=0.0,
                      metrics=True, metrics_window_s=metrics_window_s),
        telemetry=telemetry, clock=clock, engine_factory=build_engine,
    )
    controller = dict(controller)
    up, down = default_autoscale_rules(**controller.pop("rules", {}))
    scaler = Autoscaler(router, up_rules=up, down_rules=down, **controller)

    prompt_rng = np.random.default_rng(seed)
    prompts = [
        prompt_rng.integers(1, cfg.vocab_size, row.prompt_len).astype(np.int32)
        for row in trace
    ]
    greqs = []
    i = 0
    steps = 0
    cap = 200 * max(1, len(trace))
    kill = None
    # The replay_trace loop with one hook: after the router step (scale
    # decisions land at the END of step(), inside the autoscaler poll), the
    # chaos arm gets to crash a replica mid-scale-down.
    while i < len(trace) or router.queue_depth or router.running_count:
        while i < len(trace) and trace[i].arrival_s / load <= clock.t:
            row = trace[i]
            kwargs = {}
            if on_token_factory is not None:
                cbs = on_token_factory(i)
                if isinstance(cbs, tuple):
                    kwargs["on_token"], kwargs["on_retry"] = cbs
                else:
                    kwargs["on_token"] = cbs
            greqs.append(router.submit(
                prompts[i], max_new_tokens=row.output_len,
                priority=row.priority, deadline_s=row.deadline_s,
                tenant=row.tenant, **kwargs,
            ))
            i += 1
        router.step()
        if chaos and kill is None:
            down_ev = next((e for e in scaler.events
                            if e["action"] == "scale_down"), None)
            if down_ev is not None:
                victim = router._replicas[down_ev["replica"]]
                target = victim if (victim.state == DRAINING
                                    and victim.running) else None
                if target is None:
                    live = [rep for rep in router._replicas
                            if rep.state in (ACTIVE, DRAINING)]
                    target = max(live,
                                 key=lambda rep: (len(rep.running), -rep.rid),
                                 default=None)
                if target is not None:
                    in_flight = len(target.running)
                    router.kill(target.rid, reason="chaos_mid_scale_down")
                    kill = {"replica": target.rid, "in_flight": in_flight,
                            "t": round(clock.t, 3),
                            "was_drain_victim": target.rid == victim.rid}
        clock.advance(step_dt)
        steps += 1
        if steps >= cap:
            raise RuntimeError(
                f"autoscale replay exceeded {cap} steps with work pending — "
                "the fleet stopped making progress"
            )
    return router, scaler, greqs, kill


def run_autoscale_bench(
    preset: str = "smoke",
    requests: int = 48,
    max_slots: int = 2,
    max_len: int = 128,
    prompt_bucket: int = 16,
    overload: float = 4.0,
    load: float = 1.0,
    step_dt: float = 1.0,
    seed: int = 0,
    policy: str = "fifo",
    min_replicas: int = 1,
    max_replicas: int = 3,
    swing_ratio: float = 4.0,
    mean_load: float = 1.5,
    cooldown_s: float = 12.0,
    down_cooldown_s: float = 10.0,
    idle_window_s: float = 12.0,
    forecast_window_s: float = 8.0,
    attainment_band: float = 0.10,
    telemetry=None,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """The autoscaling proof (BENCH_AUTOSCALE.json): ONE diurnal ``swing``
    trace (``swing_ratio`` peak:trough, mean offered load ``mean_load`` × one
    replica's calibrated capacity) replayed three ways on the shared virtual
    clock —

    1. **static_small**: ``min_replicas`` replicas, no controller (what the
       trough needs — the peak overruns it);
    2. **static_peak**: ``max_replicas`` replicas, no controller (provisioned
       for the peak — the trough wastes it);
    3. **autoscaled**: born at ``min_replicas`` with the :class:`Autoscaler`
       closed loop (stock rule pair + predictive forecaster), bounds
       ``[min_replicas, max_replicas]``.

    Gates (CLI exits non-zero otherwise): the autoscaled arm's deadline
    attainment within ``attainment_band`` of static_peak at STRICTLY fewer
    replica-hours; zero silently-lost requests through every scale-down in
    every arm; migrated/autoscaled streams byte-identical to static_peak for
    every request done in both.

    Plus three controller-integrity arms: **steady** (a flat poisson trace on
    a fleet provisioned at its floor — the controller must fire ZERO scale
    events: any event here is thrash or a broken capacity estimate),
    **flood** (a tenant-flood burst — total scale events bounded by one ramp
    up + one ramp down across the bounds, the no-oscillation proof), and
    **chaos** (the swing trace where the first scale-down decision is
    answered with a replica crash — still nothing lost, streams still
    byte-identical)."""
    from ..serving_gateway.workload import generate_workload, trace_hash
    from ..telemetry.provenance import provenance_stamp

    if max_replicas < min_replicas + 1:
        raise ValueError(
            f"max_replicas={max_replicas} must exceed min_replicas="
            f"{min_replicas} — a fixed-size fleet has nothing to autoscale")
    cfg, params = _model(preset, max_len, device, dtype, params)
    # One queue bound for every arm (sized to the PEAK fleet): admission is
    # apples-to-apples, so attainment differences are scheduling + capacity,
    # never queue geometry.
    max_queue = max(1, int(overload * max_replicas * max_slots))
    mean_iat = _calibrated_iat(max_slots) / mean_load
    duration = requests * mean_iat
    period_s = duration / 1.25  # one full swing cycle + a quarter of the next
    trace = generate_workload("swing", requests, seed=seed,
                              mean_iat_s=mean_iat, period_s=period_s,
                              swing_ratio=swing_ratio)
    # The steady arm is CORRECTLY provisioned: flat load sized to half the
    # floor fleet's capacity, so any scale event the controller fires there
    # is thrash (or a broken capacity estimate), never a real need.
    steady_trace = generate_workload("poisson", requests, seed=seed + 1,
                                     mean_iat_s=_calibrated_iat(max_slots))
    flood_trace = generate_workload("tenant_flood", requests, seed=seed + 2,
                                    mean_iat_s=mean_iat)
    prov = provenance_stamp(cfg)

    # Rule windows scaled to the trace's timescale; the metrics plane horizon
    # covers the widest of them (the burn rule's slow window).
    controller = dict(
        min_replicas=min_replicas, max_replicas=max_replicas,
        cooldown_s=cooldown_s, down_cooldown_s=down_cooldown_s,
        forecast_window_s=forecast_window_s,
        rules=dict(queue_window_s=10.0, idle_lane_floor=float(max_slots),
                   idle_clear=float(max_slots) + 1.0,
                   idle_window_s=idle_window_s, objective=0.9,
                   fast_window_s=10.0, slow_window_s=40.0,
                   burn_threshold=2.0),
    )


    fleet_common = dict(max_slots=max_slots, max_len=max_len,
                        prompt_bucket=prompt_bucket, max_queue=max_queue,
                        load=load, step_dt=step_dt, seed=seed,
                        telemetry=telemetry, engine_hook=engine_hook)
    auto_common = dict(max_slots=max_slots, max_len=max_len,
                       prompt_bucket=prompt_bucket, max_queue=max_queue,
                       load=load, step_dt=step_dt, seed=seed,
                       metrics_window_s=60.0, engine_hook=engine_hook)

    r_small, g_small = _replay_fleet(
        params, cfg, policy, trace, n_replicas=min_replicas, **fleet_common)
    peak_streams, peak_factory = _stream_capture()
    r_peak, g_peak = _replay_fleet(
        params, cfg, policy, trace, n_replicas=max_replicas,
        on_token_factory=peak_factory, **fleet_common)
    auto_streams, auto_factory = _stream_capture()
    r_auto, s_auto, g_auto, _ = _replay_autoscaled(
        params, cfg, policy, trace, n_start=min_replicas,
        controller=controller, on_token_factory=auto_factory, **auto_common)
    # Steady arm: flat load, fleet born AT its floor (min == start), so the
    # only possible events are spurious — the controller must stay silent.
    steady_controller = dict(controller,
                             min_replicas=min(2, max_replicas),
                             max_replicas=max_replicas)
    r_steady, s_steady, g_steady, _ = _replay_autoscaled(
        params, cfg, policy, steady_trace,
        n_start=steady_controller["min_replicas"],
        controller=steady_controller, **auto_common)
    r_flood, s_flood, g_flood, _ = _replay_autoscaled(
        params, cfg, policy, flood_trace, n_start=min_replicas,
        controller=controller, **auto_common)
    chaos_streams, chaos_factory = _stream_capture()
    r_chaos, s_chaos, g_chaos, chaos_kill = _replay_autoscaled(
        params, cfg, policy, trace, n_start=min_replicas,
        controller=controller, on_token_factory=chaos_factory, chaos=True,
        **auto_common)

    def parity(streams, greqs):
        compared = mismatched = 0
        for i in range(len(trace)):
            if g_peak[i].status == "done" and greqs[i].status == "done":
                compared += 1
                if peak_streams.get(i) != streams.get(i):
                    mismatched += 1
        return compared, mismatched

    compared, mismatched = parity(auto_streams, g_auto)
    chaos_compared, chaos_mismatched = parity(chaos_streams, g_chaos)

    def arm(router, greqs, scaler=None):
        row = {**_fleet_arm_summary(router, greqs),
               **_attainment_point(router, greqs, load),
               "replica_hours": round(router.replica_hours, 6),
               "replica_spawned": router.counters["replica_spawned"]}
        if scaler is not None:
            stats = scaler.stats()
            row["scale_events"] = stats["scale_events"]
            row["scale_actions"] = stats["actions"]
            row["service_rate_per_lane"] = stats["service_rate_per_lane"]
            row["scale_records"] = list(scaler.events)
        return row

    small_arm = arm(r_small, g_small)
    peak_arm = arm(r_peak, g_peak)
    auto_arm = arm(r_auto, g_auto, s_auto)
    steady_arm = arm(r_steady, g_steady, s_steady)
    flood_arm = arm(r_flood, g_flood, s_flood)
    chaos_arm = arm(r_chaos, g_chaos, s_chaos)

    # One ramp up + one ramp down across the bounds, plus one event of slack:
    # a controller that oscillates blows straight through this.
    flood_bound = 2 * (max_replicas - min_replicas) + 1
    att_peak = peak_arm["attainment"]
    att_auto = auto_arm["attainment"]
    lost = {name: a["silently_lost"]
            for name, a in (("static_small", small_arm),
                            ("static_peak", peak_arm),
                            ("autoscaled", auto_arm),
                            ("steady", steady_arm),
                            ("flood", flood_arm),
                            ("chaos", chaos_arm))}
    return {
        "schema": "accelerate_tpu.bench.autoscale/v1",
        "preset": preset,
        "policy": policy,
        "generator": "swing",
        "requests": requests,
        "min_replicas": min_replicas,
        "max_replicas": max_replicas,
        "max_slots_per_replica": max_slots,
        "max_queue": max_queue,
        "swing_ratio": swing_ratio,
        "mean_load": mean_load,
        "mean_iat_s": round(mean_iat, 4),
        "period_s": round(period_s, 2),
        "load": load,
        "controller": {k: v for k, v in controller.items() if k != "rules"},
        "rules": controller["rules"],
        "workload_trace_hash": trace_hash(trace),
        "provenance": prov,
        # The headline gates.
        "attainment_band": attainment_band,
        "attainment_within_band": (
            att_peak is not None and att_auto is not None
            and att_auto >= att_peak - attainment_band),
        "replica_hours": {"static_small": small_arm["replica_hours"],
                          "static_peak": peak_arm["replica_hours"],
                          "autoscaled": auto_arm["replica_hours"]},
        "replica_hours_fewer": (
            auto_arm["replica_hours"] < peak_arm["replica_hours"]),
        "silently_lost_by_arm": lost,
        "zero_lost_all_arms": not any(lost.values()),
        "streams_compared": compared,
        "streams_identical": mismatched == 0,
        "streams_mismatched": mismatched,
        # Controller-integrity gates.
        "steady_scale_events": steady_arm["scale_events"],
        "steady_no_scale": steady_arm["scale_events"] == 0,
        "flood_scale_events": flood_arm["scale_events"],
        "flood_bound": flood_bound,
        "flood_bounded": flood_arm["scale_events"] <= flood_bound,
        "chaos_kill": chaos_kill,
        "chaos_scale_down_observed": any(
            e["action"] == "scale_down" for e in s_chaos.events),
        "chaos_streams_compared": chaos_compared,
        "chaos_streams_identical": chaos_mismatched == 0,
        "static_small": small_arm,
        "static_peak": peak_arm,
        "autoscaled": auto_arm,
        "steady": steady_arm,
        "flood": flood_arm,
        "chaos": chaos_arm,
    }


class _EngineMeter:
    """Per-replica busy/stall accounting for the disagg bench, measured where
    the claim lives: inside ONE replica's own host loop. ``stall_lane_s`` is
    decode-lane-seconds held while THIS replica's host loop ran admission work
    (prefill on a mixed replica, handoff adoption on a decode replica) — the
    stall the disaggregation exists to remove; ``decode_lane_s`` is
    lane-seconds inside actual decode dispatches. Cross-replica serialization
    (a single-process simulation artifact — real replicas run in parallel) is
    excluded by construction.

    Each wrapped method's wall time is device work too only where the method waits
    on the device before it returns: ``_plain_step`` and ``_spec_step`` read their
    tokens back, ``_admit`` reads each prefill's first token, and ``adopt_handoff``
    ends in a blocking host-to-device copy of the lane's valid row, which waits for
    the page scatter queued before it."""

    def __init__(self, engine):
        import time

        self.engine = engine
        self.admit_busy_s = 0.0   # prefill / adoption host+device work
        self.decode_busy_s = 0.0  # decode/verify dispatch work
        self.stall_lane_s = 0.0   # active-lane-seconds held during admissions
        self.decode_lane_s = 0.0  # active-lane-seconds inside decode dispatches

        def lanes():
            return sum(r is not None for r in engine.slot_req)

        def wrap(name, lane_kind):
            orig = getattr(engine, name)

            def timed(*args, **kwargs):
                held = lanes()
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                dt = time.perf_counter() - t0
                if lane_kind == "admit":
                    self.admit_busy_s += dt
                    self.stall_lane_s += held * dt
                else:
                    self.decode_busy_s += dt
                    self.decode_lane_s += held * dt
                return out

            setattr(engine, name, timed)

        wrap("_admit", "admit")
        if getattr(engine, "role", "mixed") != "prefill":
            wrap("_plain_step", "decode")
            wrap("_spec_step", "decode")
        if hasattr(engine, "adopt_handoff"):
            wrap("adopt_handoff", "admit")

    def row(self) -> dict:
        eng = self.engine
        busy = self.admit_busy_s + self.decode_busy_s
        lane_total = self.stall_lane_s + self.decode_lane_s
        return {
            "role": getattr(eng, "role", "mixed"),
            "admit_busy_s": round(self.admit_busy_s, 4),
            "decode_busy_s": round(self.decode_busy_s, 4),
            "stall_lane_s": round(self.stall_lane_s, 4),
            "decode_lane_s": round(self.decode_lane_s, 4),
            "stall_share": (
                round(self.stall_lane_s / lane_total, 4) if lane_total else None
            ),
            "decode_tokens": eng.decode_tokens,
            "decode_tokens_per_busy_s": (
                round(eng.decode_tokens / busy, 1) if busy > 0 else None
            ),
        }


def _disagg_stall_share(meters, decode_only: bool) -> float:
    """Arm-level decode-lane stall share: lane-seconds held during the owning
    replica's admission work over total lane-seconds, summed over the replicas
    that HOLD decode lanes (all of a mixed fleet; the decode-capable side of a
    disagg fleet)."""
    picked = [m for m in meters
              if not decode_only or getattr(m.engine, "role", "mixed") != "prefill"]
    stall = sum(m.stall_lane_s for m in picked)
    lane = sum(m.stall_lane_s + m.decode_lane_s for m in picked)
    return round(stall / lane, 4) if lane > 0 else 0.0


def _stream_capture():
    """``(streams, factory)``: ``factory(i)`` gives request ``i``'s ``(on_token,
    on_retry)`` pair, collecting its stream into ``streams[i]`` (reset on a retry)."""
    streams = {}

    def factory(i):
        streams[i] = []

        def on_token(tok, i=i):
            streams[i].append(int(tok))

        def on_retry(i=i):
            streams[i].clear()

        return on_token, on_retry

    return streams, factory


def run_disagg_bench(
    prefill_replicas: int = 1,
    decode_replicas: int = 2,
    preset: str = "smoke",
    requests: int = 48,
    max_slots: int = 4,
    max_len: int = 128,
    prompt_bucket: int = 16,
    max_new: int = 16,
    load: float = 2.0,
    seed: int = 0,
    page_size: int = 8,
    kv_pages=None,
    kill_rate: float = 0.08,
    kills_per_replica: int = 1,
    telemetry=None,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """The disaggregation proof (BENCH_DISAGG.json): replay ONE deterministic
    arrival schedule three ways —

    1. **mixed**: a ``FleetRouter`` over P+D mixed replicas (every replica
       pays prefill AND decode on the same lanes);
    2. **disagg**: a ``DisaggRouter`` over P prefill + D decode replicas of
       the SAME per-replica geometry (same chips, roles split);
    3. **disagg_chaos**: the disagg fleet with seeded crash clauses on both
       roles (prefill dies mid-handoff → re-prefill on restart; decode dies
       mid-decode → re-adoption from the still-refcounted source pages).

    Latencies are wall-clock (prefill genuinely blocks, which is the whole
    point); arrivals are paced per router step at ``load ×`` the mixed fleet's
    steady-state completion rate, so ``load=2.0`` is sustained 2× overload.
    Stamps: decode-replica STALL share (lane-seconds held during the owning
    replica's admission work — the per-replica measure, so single-process
    serialization across replicas doesn't pollute it) vs the mixed fleet's,
    TTFT p50/p95, decode tokens per replica-busy-second, handoff count/bytes/
    latency, per-role trace-report breakdown, stream byte-parity disagg vs
    mixed, and zero silently-lost requests under chaos. ``device``/``dtype``/
    ``params``: see :func:`_model`; ``engine_hook``: see :func:`_engine` (every
    replica, the restarted ones included)."""
    import time

    import numpy as np

    from ..resilience.faults import FaultPlan, FaultSpec
    from ..serving_gateway import DisaggRouter, FleetRouter
    from ..telemetry.provenance import provenance_stamp
    from ..telemetry.slo import latency_summary
    from ..telemetry.tracing import Tracer
    from ..utils.dataclasses import GatewayConfig
    from .trace_report import trace_report

    if prefill_replicas < 1 or decode_replicas < 1:
        raise ValueError("--disagg needs at least 1 prefill and 1 decode replica")
    if page_size < 1:
        raise ValueError(f"page_size={page_size} must be >= 1 (handoffs are pages)")
    cfg, params = _model(preset, max_len, device, dtype, params)
    n_total = prefill_replicas + decode_replicas
    total_lanes = n_total * max_slots
    roles = ["prefill"] * prefill_replicas + ["decode"] * decode_replicas
    prov = provenance_stamp(cfg)

    rng = np.random.default_rng(seed)
    # Mixed lengths including multi-chunk prompts: prefill cost must be real
    # for the stall/TTFT comparison to mean anything.
    prompts = [
        rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
        for n in rng.integers(3, 2 * prompt_bucket + 1, requests)
    ]
    # Offered load: the mixed fleet completes ~total_lanes/max_new requests
    # per router step at full occupancy; load multiplies that arrival rate.
    arrivals_per_step = load * total_lanes / max_new

    def build(role, plan=None):
        return _engine(
            params, cfg, max_new, engine_hook, max_slots=max_slots, max_len=max_len,
            prompt_bucket=prompt_bucket, page_size=page_size, kv_pages=kv_pages,
            role=role, faults=plan,
        )

    def replay(router, factory):
        greqs = []
        i = 0
        due = 0.0
        guard = 0
        t0 = time.perf_counter()
        while i < len(prompts) or router.queue_depth or router.running_count:
            if i < len(prompts):
                due += arrivals_per_step
                while due >= 1.0 and i < len(prompts):
                    on_token, on_retry = factory(i)
                    greqs.append(router.submit(
                        prompts[i], max_new_tokens=max_new,
                        on_token=on_token, on_retry=on_retry,
                    ))
                    due -= 1.0
                    i += 1
            router.step()
            guard += 1
            if guard > 500 * max(1, len(prompts)):
                raise RuntimeError("disagg bench replay stalled")
        return greqs, time.perf_counter() - t0

    def arm_row(router, greqs, meters, spans, wall_s, decode_only: bool) -> dict:
        done = [g for g in greqs if g.status == "done"]
        counters = router.counters
        decoding = [m for m in meters if not decode_only
                    or getattr(m.engine, "role", "mixed") != "prefill"]
        busy = sum(m.admit_busy_s + m.decode_busy_s for m in decoding)
        row = {
            "submitted": len(greqs),
            "terminal": sum(1 for g in greqs if g.terminal),
            "silently_lost": len(greqs) - sum(1 for g in greqs if g.terminal),
            "done": counters["done"],
            "failed": counters["failed"],
            "wall_s": round(wall_s, 3),
            "ttft": latency_summary([g.ttft_s for g in done]),
            "tpot": latency_summary([g.tpot_s for g in done]),
            "queue_wait": latency_summary([g.queue_wait_s for g in done]),
            "decode_stall_share": _disagg_stall_share(meters, decode_only),
            "decode_tokens_per_busy_s": round(
                sum(m.engine.decode_tokens for m in decoding) / max(1e-9, busy), 1),
            "replicas": [m.row() for m in meters],
        }
        if hasattr(router, "transfer_stats"):
            row["handoffs"] = counters.get("handoffs", 0)
            row["readopted"] = counters.get("readopted", 0)
            row["migrated"] = counters.get("migrated", 0)
            row["handoff_transfer"] = router.transfer_stats.summary()
        if spans:
            report = trace_report(spans)
            row["trace"] = {k: report[k] for k in
                            ("critical_path_share", "stall_by_role",
                             "by_status")}
        return row

    gw_cfg = dict(enabled=True, policy="fifo", max_queue=0)

    # ---- arm 1: mixed fleet (same chips, no roles)
    mixed_engines = [build("mixed") for _ in range(n_total)]
    mixed_meters = [_EngineMeter(e) for e in mixed_engines]
    mixed_spans: list = []
    mixed_router = FleetRouter(
        mixed_engines, GatewayConfig(**gw_cfg), telemetry=telemetry,
        tracer=Tracer(sink=mixed_spans.append),
    )
    mixed_streams, mixed_factory = _stream_capture()
    mixed_greqs, mixed_wall = replay(mixed_router, mixed_factory)

    # ---- arm 2: disaggregated fleet
    dis_engines = [build(r) for r in roles]
    dis_meters = [_EngineMeter(e) for e in dis_engines]
    dis_spans: list = []
    dis_router = DisaggRouter(
        dis_engines, GatewayConfig(**gw_cfg), telemetry=telemetry,
        tracer=Tracer(sink=dis_spans.append), roles=roles,
    )
    dis_streams, dis_factory = _stream_capture()
    dis_greqs, dis_wall = replay(dis_router, dis_factory)

    # ---- arm 3: disagg chaos (both roles crash mid-flight; restarts keep plans)
    def kill_plan(rid):
        site = "serving.prefill" if roles[rid] == "prefill" else "serving.decode"
        return FaultPlan(
            [FaultSpec(site, "crash", prob=kill_rate,
                       max_fires=kills_per_replica)],
            seed=seed * 6271 + rid + 1,
        )

    plans = [kill_plan(rid) for rid in range(n_total)]
    chaos_engines = [build(roles[rid], plan=plans[rid]) for rid in range(n_total)]
    chaos_meters = [_EngineMeter(e) for e in chaos_engines]

    def chaos_factory(rid, role):
        # Restarted replicas get a fresh engine AND a fresh meter: the dead
        # engine's meter keeps its pre-crash work, the replacement's work is
        # measured too — the arm row aggregates both, so replica kills never
        # silently undercount busy/stall time.
        eng = build(role, plan=plans[rid])
        chaos_meters.append(_EngineMeter(eng))
        return eng

    chaos_router = DisaggRouter(
        chaos_engines,
        GatewayConfig(**gw_cfg, replica_restarts=4),
        telemetry=telemetry, roles=roles,
        engine_factory=chaos_factory,
    )
    chaos_streams, chaos_stream_factory = _stream_capture()
    chaos_greqs, chaos_wall = replay(chaos_router, chaos_stream_factory)

    def parity(a_streams, a_greqs, b_streams, b_greqs):
        compared = mismatched = 0
        for i in range(len(prompts)):
            if a_greqs[i].status == "done" and b_greqs[i].status == "done":
                compared += 1
                if a_streams.get(i) != b_streams.get(i):
                    mismatched += 1
        return compared, mismatched

    cmp_md, mm_md = parity(mixed_streams, mixed_greqs, dis_streams, dis_greqs)
    cmp_dc, mm_dc = parity(dis_streams, dis_greqs, chaos_streams, chaos_greqs)

    mixed_arm = arm_row(mixed_router, mixed_greqs, mixed_meters, mixed_spans,
                        mixed_wall, decode_only=False)
    dis_arm = arm_row(dis_router, dis_greqs, dis_meters, dis_spans, dis_wall,
                      decode_only=True)
    chaos_arm = arm_row(chaos_router, chaos_greqs, chaos_meters, None,
                        chaos_wall, decode_only=True)
    chaos_arm["replica_kills"] = chaos_router.counters["replica_kills"]
    chaos_arm["replica_restarts"] = chaos_router.counters["replica_restarts"]
    chaos_arm["fault_fires"] = sum(len(p.fired) for p in plans)

    p95_mixed = (mixed_arm["ttft"] or {}).get("p95")
    p95_dis = (dis_arm["ttft"] or {}).get("p95")
    return {
        "schema": "accelerate_tpu.bench.disagg/v1",
        "preset": preset,
        "prefill_replicas": prefill_replicas,
        "decode_replicas": decode_replicas,
        "max_slots_per_replica": max_slots,
        "total_lanes": total_lanes,
        "page_size": page_size,
        "requests": requests,
        "max_new": max_new,
        "offered_load": load,
        "arrivals_per_step": round(arrivals_per_step, 4),
        "seed": seed,
        "provenance": prov,
        "streams_compared_vs_mixed": cmp_md,
        "streams_identical_vs_mixed": mm_md == 0,
        "chaos_streams_compared": cmp_dc,
        "chaos_streams_identical": mm_dc == 0,
        "ttft_p95_ratio_vs_mixed": (
            round(p95_dis / p95_mixed, 4) if p95_mixed and p95_dis else None
        ),
        "decode_stall_share_mixed": mixed_arm["decode_stall_share"],
        "decode_stall_share_disagg": dis_arm["decode_stall_share"],
        "stall_improved": (
            dis_arm["decode_stall_share"] < mixed_arm["decode_stall_share"]
        ),
        "ttft_p95_improved": (
            bool(p95_mixed and p95_dis and p95_dis < p95_mixed)
        ),
        "mixed": mixed_arm,
        "disagg": dis_arm,
        "disagg_chaos": chaos_arm,
    }


def _paged_bytes_per_request(estats: dict) -> int:
    """Measured KV bytes one request charged the page pool (pages actually
    allocated, averaged over admissions) — the ONE definition behind both the
    policy-row columns and the paged-compare artifact."""
    return round(
        estats["kv_alloc_count"] * estats["kv_page_bytes"]
        / max(1, estats["admitted"])
    )


def _kv_columns(engine, estats: dict) -> dict:
    """Per-row KV-memory columns: peak concurrency actually reached at this KV
    budget and the measured bytes one request charged the cache — the dense row
    cost (max_len × per-token bytes, occupancy-independent) vs the paged
    pages-actually-allocated cost. Byte sums come from ``engine.cache_bytes()``
    — the engine's own accounting — so bench columns can never drift from
    ``stats()``'s kv_bytes columns."""
    if estats["paged"]:
        return {
            "page_size": estats["page_size"],
            "kv_pages": estats["pages_total"],
            "kv_bytes_total": estats["kv_bytes_total"],
            "kv_bytes_per_request": _paged_bytes_per_request(estats),
            "max_concurrent_at_fixed_mem": estats["peak_active_slots"],
            "kv_defer_count": estats["kv_defer_count"],
            "kv_shared_pages": estats["kv_shared_pages"],
        }
    cache_bytes = engine.cache_bytes()
    return {
        "page_size": 0,
        "kv_pages": None,
        "kv_bytes_total": cache_bytes,
        "kv_bytes_per_request": cache_bytes // engine.max_slots,
        "max_concurrent_at_fixed_mem": estats["peak_active_slots"],
        "kv_defer_count": 0,
        "kv_shared_pages": 0,
    }


def run_paged_compare(
    preset: str = "smoke",
    max_len: int = 256,
    prompt_bucket: int = 16,
    max_new: int = 16,
    requests: int = 48,
    budget_rows: int = 2,
    page_size: int = 16,
    max_slots: int = 16,
    prefix_cache: int = 4,
    seed: int = 0,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """Dense vs paged at a FIXED KV byte budget: the acceptance artifact
    (BENCH_PAGED.json).

    The budget is ``budget_rows`` dense cache rows. The dense engine can field
    exactly that many lanes (each lane owns a full ``max_len`` row, occupancy be
    damned); the paged engine gets the SAME bytes as a page pool (per-token bytes
    are identical, so ``kv_pages = budget_rows × max_len / page_size``) and
    ``max_slots`` lanes — concurrency then ends where the workload's ACTUAL
    sequence lengths exhaust the pool, not where padded maxima would. Both engines
    replay the same short-request burst (prompt ≤ one bucket + ``max_new`` budget —
    chat-shaped traffic) and a prefix-heavy burst (shared system prompt, prefix
    cache on), measuring peak concurrency, decode throughput at high occupancy,
    per-request KV bytes, and the prefix registry's memory cost (whole row-cache
    snapshots vs refcounted page lists). ``device``/``dtype``/``params``: see
    :func:`_model`; ``engine_hook``: see :func:`_engine`."""
    import time

    import numpy as np

    if page_size < 1:
        raise ValueError(f"page_size={page_size} must be >= 1")
    if page_size > max_len:
        raise ValueError(f"page_size={page_size} must be <= max_len={max_len}")
    cfg, params = _model(preset, max_len, device, dtype, params)
    rng = np.random.default_rng(seed)
    # Per-token KV bytes are identical in both layouts, so the paged pool that
    # fits the dense budget is budget_rows × max_len tokens' worth of pages —
    # FLOORED when page_size doesn't divide max_len (the paged side never gets
    # more bytes than the dense budget; the comparison can only understate it).
    kv_pages = budget_rows * max_len // page_size

    prompts = [
        rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
        for n in rng.integers(3, prompt_bucket + 1, requests)
    ]
    sys_prompt = rng.integers(1, cfg.vocab_size, 2 * prompt_bucket).astype(np.int32)
    prefix_prompts = [
        np.concatenate([sys_prompt,
                        rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)])
        for n in rng.integers(3, prompt_bucket + 1, requests // 2)
    ]

    def build(paged: bool, prefix: int = 0):
        return _engine(
            params, cfg, max_new, engine_hook,
            max_slots=max_slots if paged else budget_rows,
            max_len=max_len, prompt_bucket=prompt_bucket,
            page_size=page_size if paged else 0,
            kv_pages=kv_pages if paged else None,
            prefix_cache=prefix,
        )

    def replay(engine, workload):
        """Drain ``workload`` → (wall_s, total tokens, decode-only wall_s,
        decode-only tokens). The decode-only pair accumulates ONLY steps that
        admitted nothing — pure decode dispatches at the prevailing occupancy —
        so `decode_tokens_per_sec` is not polluted by prefill FLOPs or
        admission-path host work (which the two layouts amortize over very
        different lane counts)."""
        for p in workload:
            engine.submit(p, max_new_tokens=max_new)
        t0 = time.perf_counter()
        decode_wall = 0.0
        decode_tokens = 0
        while engine.queue or any(r is not None for r in engine.slot_req):
            admitted_before = engine.admitted
            tokens_before = engine.decode_tokens
            s0 = time.perf_counter()
            engine.step()
            s1 = time.perf_counter()
            emitted = engine.decode_tokens - tokens_before
            if engine.admitted == admitted_before and emitted:
                decode_wall += s1 - s0
                decode_tokens += emitted
        wall = time.perf_counter() - t0
        tokens = engine.decode_tokens + engine.admitted  # +1 prefill token each
        return wall, tokens, decode_wall, decode_tokens

    rows = []
    for paged in (False, True):
        eng = build(paged)
        budget_bytes = eng.cache_bytes()
        wall, tokens, decode_wall, decode_tokens = replay(eng, prompts)
        s = eng.stats()
        # Prefix-memory pass: same budget, shared system prompt, registry on.
        peng = build(paged, prefix=prefix_cache)
        replay(peng, prefix_prompts)
        ps_ = peng.stats()
        if paged:
            prefix_bytes = ps_["kv_bytes_in_use"]  # drained: only registry pages remain
            per_request = _paged_bytes_per_request(s)
        else:
            row_bytes = budget_bytes // eng.max_slots
            prefix_bytes = ps_["prefix_entries"] * row_bytes
            per_request = row_bytes
        rows.append({
            "layout": "paged" if paged else "dense",
            "kv_budget_bytes": budget_bytes,
            "page_size": page_size if paged else 0,
            "kv_pages": kv_pages if paged else None,
            "max_slots": eng.max_slots,
            "requests": requests,
            "max_new": max_new,
            "max_concurrent_at_fixed_mem": s["peak_active_slots"],
            "tokens_per_sec": round(tokens / wall, 1) if wall > 0 else None,
            "decode_tokens_per_sec": round(decode_tokens / decode_wall, 1)
            if decode_wall > 0 else None,
            "tokens_per_step": s["tokens_per_step"],
            "kv_bytes_per_request": per_request,
            "kv_defer_count": s.get("kv_defer_count", 0),
            "prefix_hit_memory_bytes": prefix_bytes,
            "prefix_entries": ps_["prefix_entries"],
            "prefix_hits": ps_["prefix_hits"],
            "kv_shared_pages": ps_.get("kv_shared_pages", 0),
        })
    dense_row, paged_row = rows
    return {
        "schema": "accelerate_tpu.bench.paged/v1",
        "preset": preset,
        "kv_budget_bytes": dense_row["kv_budget_bytes"],
        "rows": rows,
        "concurrency_ratio": round(
            paged_row["max_concurrent_at_fixed_mem"]
            / max(1, dense_row["max_concurrent_at_fixed_mem"]), 2
        ),
        "prefix_memory_ratio": round(
            dense_row["prefix_hit_memory_bytes"]
            / max(1, paged_row["prefix_hit_memory_bytes"]), 2
        ),
    }


def _sampled(max_new: int):
    """The sampled minority's ``GenerationConfig`` in the multistep and spec sweeps."""
    from ..generation import GenerationConfig

    return GenerationConfig(max_new_tokens=max_new, temperature=0.8, top_p=0.9, top_k=8)


def _decode_sweep(gw):
    """Drain ``gw`` → (wall_s, decode-only wall_s, decode-only tokens, decode-only
    steps): the decode-only sums take ONLY steps that admitted nothing (the
    ``run_paged_compare`` accounting)."""
    import time

    engine = gw.engine
    t0 = time.perf_counter()
    decode_wall = 0.0
    decode_tokens = 0
    decode_dispatch_steps = 0
    while gw.queue_depth or gw.running_count:
        admitted_before = engine.admitted
        tokens_before = engine.decode_tokens
        s0 = time.perf_counter()
        gw.step()
        s1 = time.perf_counter()
        emitted = engine.decode_tokens - tokens_before
        if engine.admitted == admitted_before and emitted:
            decode_wall += s1 - s0
            decode_tokens += emitted
            decode_dispatch_steps += 1
    return time.perf_counter() - t0, decode_wall, decode_tokens, decode_dispatch_steps


def _host_share(records):
    """Host-time share of the decode phase from the decode trace spans' measured
    ``host_s`` inter-dispatch gaps; lanes of one dispatch share its (t0, t1, host_s)
    triple, so the spans are deduplicated to dispatches before summing."""
    from ..telemetry.tracing import TRACE_SPAN_SCHEMA

    dispatches = {(s["t0"], s["t1"], s["host_s"]) for s in records
                  if s.get("schema") == TRACE_SPAN_SCHEMA and s["span"] == "decode"}
    host_s = sum(d[2] for d in dispatches)
    busy_s = sum(d[1] - d[0] for d in dispatches)
    return round(host_s / (host_s + busy_s), 4) if (host_s + busy_s) > 0 else None


def _traced_gateway(engine, decode_steps: int):
    """A gateway over ``engine`` with a fresh enabled ``Telemetry`` and ``Tracer``
    (the decode spans ``_host_share`` reads) → (gateway, telemetry)."""
    from ..serving_gateway import ServingGateway
    from ..telemetry import Telemetry
    from ..telemetry.tracing import Tracer
    from ..utils.dataclasses import GatewayConfig, TelemetryConfig

    tel = Telemetry(TelemetryConfig(enabled=True, compile_events=False,
                                    memory_stats=False))
    gw = ServingGateway(engine, GatewayConfig(enabled=True, decode_steps=decode_steps),
                        telemetry=tel, tracer=Tracer(tel))
    return gw, tel


def run_multistep_bench(
    preset: str = "smoke",
    max_len: int = 256,
    prompt_bucket: int = 16,
    max_new: int = 32,
    requests: int = 32,
    max_slots: int = 8,
    decode_steps=(1, 2, 4, 8),
    page_size: int = 0,
    sampled_frac: float = 0.25,
    seed: int = 0,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """Multi-step decode sweep at high occupancy: the acceptance artifact
    (BENCH_MULTISTEP.json).

    One engine per ``decode_steps`` value replays the SAME saturating burst
    (every lane busy for most of the run — the regime where per-dispatch host
    overhead dominates decode). Each row measures decode-only tokens/s (steps
    that admitted nothing, the ``run_paged_compare`` accounting) and the
    host-time share of the decode phase, reconstructed from the decode trace
    spans' measured ``host_s`` inter-dispatch gaps — the N=1 row is the
    baseline, and the bitwise-parity contract rides along: every row's token
    streams must be IDENTICAL to the N=1 row's (greedy and sampled lanes; a
    sampled request ``i`` takes the seed ``seed * 1000 + i``). ``device``/
    ``dtype``/``params``: see :func:`_model`; ``engine_hook``: see
    :func:`_engine`."""
    import numpy as np

    from ..generation import GenerationConfig
    from ..telemetry.provenance import provenance_stamp

    steps_list = tuple(int(n) for n in decode_steps)
    if not steps_list or steps_list[0] != 1:
        raise ValueError(
            f"decode_steps={decode_steps!r}: the sweep needs the N=1 baseline "
            "first (parity and speedup are measured against it)"
        )
    cfg, params = _model(preset, max_len, device, dtype, params)
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
        for n in rng.integers(3, prompt_bucket + 1, requests)
    ]
    # A sampled minority rides every row (same seeds across rows): parity
    # must hold through the per-lane emission-indexed noise schedule, not just
    # the fused argmax.
    gens = []
    for i in range(requests):
        if rng.random() < sampled_frac:
            gens.append((_sampled(max_new), seed * 1000 + i))
        else:
            gens.append((GenerationConfig(max_new_tokens=max_new), None))
    prov = provenance_stamp(cfg)

    rows = []
    baseline_streams = None
    baseline_tps = None
    baseline_host = None
    for n in steps_list:
        gw, tel = _traced_gateway(
            _engine(params, cfg, max_new, engine_hook, max_slots=max_slots,
                    max_len=max_len, prompt_bucket=prompt_bucket, page_size=page_size,
                    decode_steps=n), n)
        engine = gw.engine
        greqs = [gw.submit(p, gen=g, seed=r) for p, (g, r) in zip(prompts, gens)]
        wall, decode_wall, decode_tokens, decode_dispatch_steps = _decode_sweep(gw)
        streams = [list(r.tokens) for r in greqs]
        host_share = _host_share(tel.records)
        tokens = sum(len(t) for t in streams)
        tps = round(decode_tokens / decode_wall, 1) if decode_wall > 0 else None
        if n == 1:
            baseline_streams = streams
            baseline_tps = tps
            baseline_host = host_share
        rows.append({
            "decode_steps": n,
            "requests": requests,
            "max_slots": max_slots,
            "max_new": max_new,
            "page_size": page_size,
            "tokens_generated": tokens,
            "tokens_per_sec": round(tokens / wall, 1) if wall > 0 else None,
            "decode_tokens_per_sec": tps,
            "decode_dispatches": engine.decode_steps,
            "decode_only_steps": decode_dispatch_steps,
            "host_share": host_share,
            "identical_vs_n1": streams == baseline_streams,
            "provenance": prov,
        })
    best = max((r for r in rows[1:]),
               key=lambda r: r["decode_tokens_per_sec"] or 0.0)
    return {
        "schema": "accelerate_tpu.bench.multistep/v1",
        "preset": preset,
        "max_slots": max_slots,
        "requests": requests,
        "page_size": page_size,
        "rows": rows,
        "all_identical": all(r["identical_vs_n1"] for r in rows),
        "decode_speedup_best": round(
            (best["decode_tokens_per_sec"] or 0.0) / baseline_tps, 2
        ) if baseline_tps else None,
        "best_decode_steps": best["decode_steps"],
        "host_share_n1": baseline_host,
        "host_share_best": best["host_share"],
    }


def _spec_sweep_workload(vocab: int, requests: int, prompt_bucket: int, max_new: int,
                         workload: str, seed: int) -> list:
    """The fused sweep's burst of :func:`run_spec_bench`: ``[(prompt, gen, seed)]``,
    a quarter of the lanes sampled (request ``i`` with the seed ``seed * 1000 + i``)."""
    import numpy as np

    from ..generation import GenerationConfig

    prompts = [p for p, _, _ in _workload(requests, vocab, prompt_bucket, 0.25, seed,
                                          kind=workload)]
    rng = np.random.default_rng(seed + 1)
    out = []
    for i, prompt in enumerate(prompts):
        if rng.random() < 0.25:
            out.append((prompt, _sampled(max_new), seed * 1000 + i))
        else:
            out.append((prompt, GenerationConfig(max_new_tokens=max_new), None))
    return out


def run_spec_bench(
    preset: str = "smoke",
    requests: int = 48,
    max_slots: int = 4,
    max_len: int = 128,
    prompt_bucket: int = 16,
    max_new: int = 16,
    overload: float = 4.0,
    spec_k: int = 3,
    fused_steps: int = 8,
    workload: str = "repeat",
    seed: int = 0,
    sweep_max_len: int = 256,
    sweep_max_slots: int = 8,
    sweep_max_new: int = 32,
    sweep_requests: int = 32,
    device=None,
    dtype=None,
    params=None,
    engine_hook=None,
) -> dict:
    """The speculative-serving acceptance artifact (BENCH_SPEC.json).

    Two measurement regimes, because the fused claim has two halves:

    - **Overload SLO rows**: plain spec_k=0 / host-loop ngram / acceptance-1.0
      oracle fifo rows over the same burst (:func:`run_serve_bench`) —
      speculation's tokens-per-step and wall-clock effect under admission churn.
    - **High-occupancy fused sweep** (the ``run_multistep_bench`` regime —
      every lane decode-bound for most of the run): host-loop spec vs the
      FUSED speculative super-step (``decode_steps=fused_steps``, ngram
      drafter) on the same saturating burst. Each arm measures decode-only
      tokens/s and the host-time share of the decode phase from the trace
      spans' measured inter-dispatch gaps, and the arms' token streams must be
      BITWISE identical (greedy and sampled lanes). A third gate checks fused
      output against the plain spec_k=0 engine; ``mismatched_vs_plain`` lists
      each request where it fails (its row, both streams), for a caller's
      near-tie check at bf16 (verify at T = k+1 and decode at T = 1 round
      differently). ``device``/``dtype``/``params``: see :func:`_model` (one set
      for every row); ``engine_hook``: see :func:`_engine`."""
    from ..spec_decode import NgramDrafter
    from ..telemetry.provenance import provenance_stamp

    cfg, params = _model(preset, max_len, device, dtype, params)
    shared = dict(
        policies=("fifo",), preset=preset, requests=requests,
        max_slots=max_slots, max_len=max_len, prompt_bucket=prompt_bucket,
        max_new=max_new, overload=overload, workload=workload, seed=seed,
        device=device, dtype=dtype, params=params, engine_hook=engine_hook,
    )
    plain = run_serve_bench(spec_k=0, **shared)[0]
    ngram = run_serve_bench(spec_k=spec_k, spec_draft="ngram", **shared)[0]
    oracle = run_serve_bench(spec_k=spec_k, spec_draft="oracle", **shared)[0]

    # ---- fused sweep: decode-bound saturating burst, host-loop vs fused ----
    cfg, params = _model(preset, sweep_max_len, device, dtype, params)
    burst = _spec_sweep_workload(cfg.vocab_size, sweep_requests, prompt_bucket,
                                 sweep_max_new, workload, seed)

    def sweep_arm(n, k):
        gw, tel = _traced_gateway(
            _engine(params, cfg, sweep_max_new, engine_hook, max_slots=sweep_max_slots,
                    max_len=sweep_max_len, prompt_bucket=prompt_bucket, spec_k=k,
                    drafter=NgramDrafter() if k else None, decode_steps=n), n)
        engine = gw.engine
        greqs = [gw.submit(p, gen=g, seed=r) for p, g, r in burst]
        wall, decode_wall, decode_tokens, decode_dispatch_steps = _decode_sweep(gw)
        estats = engine.stats()
        return {
            "decode_steps": n,
            "spec_k": k,
            "spec_draft": "ngram" if k else None,
            "requests": sweep_requests,
            "max_slots": sweep_max_slots,
            "max_new": sweep_max_new,
            "tokens_generated": sum(len(r.tokens) for r in greqs),
            "tokens_per_sec": round(sum(len(r.tokens) for r in greqs) / wall, 1)
            if wall > 0 else None,
            "decode_tokens_per_sec": round(decode_tokens / decode_wall, 1)
            if decode_wall > 0 else None,
            "decode_dispatches": decode_dispatch_steps,
            "tokens_per_step": estats["tokens_per_step"],
            "spec_accept_rate": estats["spec_accept_rate"],
            "host_share": _host_share(tel.records),
            "provenance": provenance_stamp(cfg),
        }, [list(r.tokens) for r in greqs]

    host_loop, host_streams = sweep_arm(1, spec_k)
    fused, fused_streams = sweep_arm(fused_steps, spec_k)
    _, plain_streams = sweep_arm(1, 0)
    identical_host = fused_streams == host_streams
    identical_plain = fused_streams == plain_streams

    ratio = lambda a, b: round(a / b, 3) if a and b else None  # noqa: E731
    return {
        "schema": "accelerate_tpu.bench.serve_spec/v1",
        "note": (
            "Batched speculative decoding on the serve-bench smoke shape (fifo, "
            f"{requests} requests, {max_slots} slots, max_new={max_new}, "
            f"{workload} workload; CPU backend). Outputs are token-for-token "
            "identical across rows (parity-tested). Random smoke weights make a "
            "real drafter's acceptance meaningless-by-construction "
            "(speculative_tpu.py rationale): the ngram rows show the mechanism "
            "at honestly-measured acceptance (the repeat workload's prompt-"
            "lookup hits), the oracle row (proposals from precomputed greedy "
            "references, acceptance 1.0) isolates the fused-verify ceiling; "
            "real deployments interpolate by measured spec_accept_rate. The "
            "fused_sweep section measures the FUSED speculative super-step "
            f"(decode_steps={fused_steps}, serving.spec_multi — N draft-verify-"
            "accept rounds per dispatch, zero host involvement between rounds) "
            "against the host-loop spec engine at high occupancy "
            "(run_multistep_bench regime): same tokens bitwise "
            "(fused_identical_* gates, greedy AND sampled lanes), one host "
            "round-trip per N rounds — host_share is the measured acceptance "
            "column. CPU decode is FLOP-bound (T=k+1 verify costs ~1.4x a T=1 "
            "step for k=3); TPU decode is HBM-bound, where verify ~= decode "
            "cost and the tokens_per_step column converts to TPOT directly."
        ),
        "rows": [plain, ngram, oracle],
        "fused_sweep": {
            "rows": [host_loop, fused],
            "fused_rounds": fused_steps,
        },
        "fused_identical_vs_host_loop": identical_host,
        "fused_identical_vs_plain": identical_plain,
        "mismatched_vs_plain": [
            {"row": i, "fused": f, "plain": p}
            for i, (f, p) in enumerate(zip(fused_streams, plain_streams)) if f != p],
        "comparison": {
            "baseline_tokens_per_sec": plain["tokens_per_sec"],
            "ngram_speedup": ratio(ngram["tokens_per_sec"],
                                   plain["tokens_per_sec"]),
            "ngram_tokens_per_step_ratio": ratio(ngram["tokens_per_step"],
                                                 plain["tokens_per_step"]),
            "oracle_speedup": ratio(oracle["tokens_per_sec"],
                                    plain["tokens_per_sec"]),
            "oracle_tokens_per_step_ratio": ratio(oracle["tokens_per_step"],
                                                  plain["tokens_per_step"]),
            "fused_rounds": fused_steps,
            # Overall wall tokens/s over the identical saturating burst — the
            # decode-only column is a 4-dispatch sample at N=8 (too few
            # super-steps to time), the whole-run wall is not.
            "fused_speedup_vs_host_loop": ratio(
                fused["tokens_per_sec"], host_loop["tokens_per_sec"]),
            "fused_tokens_per_step_ratio_vs_host_loop": ratio(
                fused["tokens_per_step"], host_loop["tokens_per_step"]),
            "host_share_host_loop": host_loop["host_share"],
            "host_share_fused": fused["host_share"],
        },
    }


def serve_bench_command(args) -> int:
    import json

    import torch

    run_kw = dict(preset=args.preset, device=args.device,
                  dtype=None if args.dtype is None else getattr(torch, args.dtype))

    if args.disagg:
        try:
            p_str, d_str = args.disagg.split(":")
            n_prefill, n_decode = int(p_str), int(d_str)
        except ValueError:
            raise SystemExit(
                f"--disagg {args.disagg!r}: expected P:D (e.g. --disagg 1:2)"
            )
        if args.smoke:
            # CI tier-1 disagg shape: tiny trace, 1 prefill + 1 decode
            # replica, 2 lanes each — the correctness gates (zero lost,
            # byte-identical streams) still hold; the wall-clock improvement
            # gates only apply to full runs (too noisy at smoke scale).
            n_prefill, n_decode = 1, 1
            args.requests = min(args.requests, 12)
            args.max_slots = 2
            args.max_len = 64
            args.prompt_bucket = 16
            args.max_new = 8
        artifact = run_disagg_bench(
            prefill_replicas=n_prefill,
            decode_replicas=n_decode,
            **run_kw,
            requests=args.requests,
            max_slots=args.max_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            max_new=args.max_new,
            load=2.0 if args.load is None else args.load,
            seed=args.seed,
            page_size=args.page_size or 8,
            kv_pages=args.kv_pages,
            kill_rate=args.kill_rate,
            kills_per_replica=(1 if args.kills_per_replica is None
                               else args.kills_per_replica),
        )
        with open(args.disagg_out, "w") as f:
            json.dump(artifact, f, indent=2)
        print(json.dumps({k: artifact[k] for k in (
            "schema", "prefill_replicas", "decode_replicas", "offered_load",
            "streams_identical_vs_mixed", "chaos_streams_identical",
            "decode_stall_share_mixed", "decode_stall_share_disagg",
            "ttft_p95_ratio_vs_mixed", "stall_improved", "ttft_p95_improved",
        )} | {
            "silently_lost_chaos": artifact["disagg_chaos"]["silently_lost"],
            "handoffs": artifact["disagg"]["handoffs"],
            "replica_kills": artifact["disagg_chaos"]["replica_kills"],
        }))
        bad = (artifact["disagg"]["silently_lost"]
               or artifact["disagg_chaos"]["silently_lost"]
               or not artifact["streams_identical_vs_mixed"]
               or not artifact["chaos_streams_identical"])
        if not args.smoke:
            bad = bad or not artifact["stall_improved"] \
                or not artifact["ttft_p95_improved"]
        return 1 if bad else 0

    if args.autoscale:
        if args.smoke:
            # CI tier-1 autoscale shape: short swing trace, 2 lanes/replica —
            # the closed-loop gates (attainment within band at fewer replica-
            # hours, zero lost, byte-identical streams, bounded events) hold
            # at smoke scale because every clock is virtual.
            args.requests = min(args.requests, 24)
            args.max_slots = 2
            args.max_len = 64
            args.prompt_bucket = 16
        artifact = run_autoscale_bench(
            **run_kw,
            requests=args.requests,
            max_slots=args.max_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            overload=args.overload,
            load=1.0 if args.load is None else args.load,
            seed=args.seed,
            policy=args.policy if args.policy != "all" else "fifo",
            min_replicas=args.autoscale_min,
            max_replicas=args.autoscale_max,
            swing_ratio=args.swing_ratio,
        )
        with open(args.autoscale, "w") as f:
            json.dump(artifact, f, indent=2)
        print(json.dumps({k: artifact[k] for k in (
            "schema", "min_replicas", "max_replicas", "workload_trace_hash",
            "attainment_within_band", "replica_hours", "replica_hours_fewer",
            "zero_lost_all_arms", "streams_compared", "streams_identical",
            "steady_scale_events", "flood_scale_events", "flood_bound",
            "chaos_streams_identical",
        )} | {
            "attainment_autoscaled": artifact["autoscaled"]["attainment"],
            "attainment_peak": artifact["static_peak"]["attainment"],
            "scale_events": artifact["autoscaled"]["scale_events"],
            "scale_actions": artifact["autoscaled"]["scale_actions"],
            "chaos_kill": artifact["chaos_kill"],
        }))
        return 1 if (not artifact["attainment_within_band"]
                     or not artifact["replica_hours_fewer"]
                     or not artifact["zero_lost_all_arms"]
                     or not artifact["streams_identical"]
                     or not artifact["steady_no_scale"]
                     or not artifact["flood_bounded"]
                     or artifact["autoscaled"]["scale_actions"]["scale_up"] < 1
                     or not artifact["chaos_scale_down_observed"]
                     or not artifact["chaos_streams_identical"]) else 0

    if args.chaos and args.fleet:
        if args.smoke:
            # CI tier-1 fleet chaos shape: small trace, 2 lanes per replica.
            args.requests = min(args.requests, 16)
            args.max_slots = 2
            args.max_len = 64
            args.prompt_bucket = 16
        artifact = run_fleet_chaos_bench(
            n_replicas=args.fleet,
            **run_kw,
            requests=args.requests,
            max_slots=args.max_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            overload=args.overload,
            load=1.0 if args.load is None else args.load,
            seed=args.seed,
            policy=args.policy if args.policy != "all" else "fifo",
            kill_rate=args.kill_rate,
            kills_per_replica=(2 if args.kills_per_replica is None
                               else args.kills_per_replica),
            generator=args.trace_gen or "poisson",
            capsule_dir=args.capsule_dir,
        )
        with open(args.chaos, "w") as f:
            json.dump(artifact, f, indent=2)
        print(json.dumps({k: artifact[k] for k in (
            "schema", "n_replicas", "workload_trace_hash",
            "streams_compared", "streams_identical",
            "failover_ttft_p95_penalty", "fleet_availability_above_single",
            "alerts_clean_silent", "alerts_chaos_fired",
        )} | {
            "silently_lost": artifact["fleet_chaos"]["silently_lost"],
            "availability_fleet": artifact["fleet_chaos"]["availability"],
            "availability_single": artifact["single_chaos"]["availability"],
            "circuit_rejections": artifact["fleet_chaos"]["circuit_rejections"],
            "replica_kills": artifact["fleet_chaos"]["replica_kills"],
            "capsules_clean": artifact["capsules_clean"],
            "capsules_chaos": artifact["capsules"]["count"],
            "capsule_triggers": artifact["capsules"]["triggers"],
        }))
        return 1 if (artifact["fleet_chaos"]["silently_lost"]
                     or not artifact["streams_identical"]
                     or not artifact["fleet_availability_above_single"]
                     or not artifact["alerts_clean_silent"]
                     or not artifact["alerts_chaos_expected"]
                     or not artifact["capsules_clean_zero"]
                     or not artifact["capsules_chaos_expected"]) else 0

    if args.chaos:
        if args.smoke:
            # CI tier-1 chaos shape: small trace, 2 lanes, still >=10% of
            # decode dispatches failing.
            args.requests = min(args.requests, 16)
            args.max_slots = 2
            args.max_len = 64
            args.prompt_bucket = 16
        artifact = run_chaos_bench(
            **run_kw,
            requests=args.requests,
            max_slots=args.max_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            overload=args.overload,
            load=1.0 if args.load is None else args.load,
            seed=args.seed,
            policy=args.policy if args.policy != "all" else "fifo",
            chaos_rate=args.chaos_rate,
            generator=args.trace_gen or "poisson",
            chaos_sites=tuple(
                s.strip() for s in args.chaos_sites.split(",") if s.strip()
            ),
            page_size=args.page_size,
            kv_pages=args.kv_pages,
            capsule_dir=args.capsule_dir,
        )
        with open(args.chaos, "w") as f:
            json.dump(artifact, f, indent=2)
        print(json.dumps({k: artifact[k] for k in (
            "schema", "chaos_rate", "workload_trace_hash",
            "streams_compared", "streams_identical",
            "alerts_clean_silent", "alerts_chaos_fired",
        )} | {
            "silently_lost": artifact["chaos"]["silently_lost"],
            "availability_clean": artifact["clean"]["availability"],
            "availability_chaos": artifact["chaos"]["availability"],
            "step_fault_rate": artifact["chaos"]["engine"]["step_fault_rate"],
            "fired_by_site": artifact["fault_plan"]["fired_by_site"],
            "capsules_clean": artifact["capsules_clean"],
            "capsules_chaos": artifact["capsules"]["count"],
            "capsule_triggers": artifact["capsules"]["triggers"],
        }))
        return 1 if (artifact["chaos"]["silently_lost"]
                     or not artifact["streams_identical"]
                     or not artifact["alerts_clean_silent"]
                     or not artifact["alerts_chaos_expected"]
                     or not artifact["capsules_clean_zero"]
                     or not artifact["capsules_chaos_expected"]) else 0

    if args.trace_curves:
        loads = tuple(float(x) for x in args.loads.split(",") if x.strip())
        artifact = run_trace_curves(
            policies=ALL_POLICIES if args.policy == "all" else (args.policy,),
            loads=loads,
            requests=args.requests,
            **run_kw,
            max_slots=args.max_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            overload=args.overload,
            seed=args.seed,
        )
        with open(args.trace_curves, "w") as f:
            json.dump(artifact, f, indent=2)
        for curve in artifact["curves"]:
            print(json.dumps({
                "generator": curve["generator"],
                "policy": curve["policy"],
                "workload_trace_hash": curve["workload_trace_hash"],
                "attainment": [p["attainment"] for p in curve["points"]],
                "attainment_high": [p["attainment_high"] for p in curve["points"]],
            }))
        return 0

    if args.save_trace:
        if not args.trace_gen:
            raise SystemExit("--save-trace needs --trace-gen <generator>")
        from ..serving_gateway.workload import (
            generate_workload, save_trace, trace_hash,
        )

        trace = generate_workload(
            args.trace_gen, args.requests, seed=args.seed,
            mean_iat_s=_calibrated_iat(args.max_slots),
        )
        save_trace(args.save_trace, trace, generator=args.trace_gen,
                   seed=args.seed)
        print(json.dumps({"trace": args.save_trace, "n": len(trace),
                          "workload_trace_hash": trace_hash(trace)}))
        return 0

    if args.workload_trace or args.trace_gen:
        if args.workload_trace and args.trace_gen:
            raise SystemExit("pass either --workload-trace or --trace-gen, not both")
        from ..serving_gateway.workload import generate_workload, load_trace

        if args.workload_trace:
            trace = load_trace(args.workload_trace)
            generator = "file"
        else:
            trace = generate_workload(
                args.trace_gen, args.requests, seed=args.seed,
                mean_iat_s=_calibrated_iat(args.max_slots),
            )
            generator = args.trace_gen
        rows = run_trace_replay(
            trace,
            policies=ALL_POLICIES if args.policy == "all" else (args.policy,),
            **run_kw,
            max_slots=args.max_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            overload=args.overload,
            load=1.0 if args.load is None else args.load,
            seed=args.seed,
            generator=generator,
            page_size=args.page_size,
            kv_pages=args.kv_pages,
        )
        for row in rows:
            print(json.dumps(row))
        return 0

    if args.multistep:
        steps = tuple(int(n) for n in str(args.decode_steps).split(","))
        if steps == (1,):
            steps = (1, 2, 4, 8)
        parser_defaults = serve_bench_command_parser()
        sweep_kw = dict(
            **run_kw,
            prompt_bucket=args.prompt_bucket,
            requests=args.requests,
            decode_steps=steps,
            page_size=args.page_size,
            seed=args.seed,
        )
        # Sweep-tuned geometry (256-len rows, 8 lanes, 32-token budgets keep
        # lanes decode-bound) unless the user explicitly moved a shared flag.
        if args.max_len != parser_defaults.get_default("max_len"):
            sweep_kw["max_len"] = args.max_len
        if args.max_slots != parser_defaults.get_default("max_slots"):
            sweep_kw["max_slots"] = args.max_slots
        if args.max_new != parser_defaults.get_default("max_new"):
            sweep_kw["max_new"] = args.max_new
        artifact = run_multistep_bench(**sweep_kw)
        with open(args.multistep, "w") as f:
            json.dump(artifact, f, indent=2)
        print(json.dumps({k: artifact[k] for k in
                          ("schema", "all_identical", "decode_speedup_best",
                           "best_decode_steps", "host_share_n1",
                           "host_share_best")}))
        return 0 if artifact["all_identical"] else 1

    if args.spec_bench:
        artifact = run_spec_bench(
            **run_kw,
            requests=args.requests,
            max_slots=args.max_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            max_new=args.max_new,
            overload=args.overload,
            spec_k=args.spec_k or 3,
            fused_steps=int(str(args.decode_steps).split(",")[0])
            if str(args.decode_steps) != "1" else 8,
            # The artifact's committed geometry is the low-entropy repeat
            # workload (the traffic prompt-lookup drafting is for); an explicit
            # --workload choice still wins.
            workload=args.workload if args.workload != "mixed" else "repeat",
            seed=args.seed,
        )
        with open(args.spec_bench, "w") as f:
            json.dump(artifact, f, indent=2)
        print(json.dumps({
            "schema": artifact["schema"],
            "fused_identical_vs_host_loop":
                artifact["fused_identical_vs_host_loop"],
            "fused_identical_vs_plain": artifact["fused_identical_vs_plain"],
            **artifact["comparison"],
        }))
        return 0 if (artifact["fused_identical_vs_host_loop"]
                     and artifact["fused_identical_vs_plain"]) else 1

    if args.paged_compare:
        # Compare-tuned geometry defaults (256-len rows, 16 lanes) unless the
        # user explicitly moved a shared flag off its parser default — the
        # policy-row defaults are tuned for the overload replay, not for the
        # fixed-budget memory comparison. --kv-pages stays derived from the
        # budget (honoring it would break the fixed-budget semantics).
        parser_defaults = serve_bench_command_parser()
        compare_kw = dict(
            **run_kw,
            prompt_bucket=args.prompt_bucket,
            max_new=args.max_new,
            requests=args.requests,
            page_size=args.page_size or 16,
            seed=args.seed,
        )
        if args.max_len != parser_defaults.get_default("max_len"):
            compare_kw["max_len"] = args.max_len
        if args.max_slots != parser_defaults.get_default("max_slots"):
            compare_kw["max_slots"] = args.max_slots
        artifact = run_paged_compare(**compare_kw)
        with open(args.paged_compare, "w") as f:
            json.dump(artifact, f, indent=2)
        print(json.dumps({k: artifact[k] for k in
                          ("schema", "kv_budget_bytes", "concurrency_ratio",
                           "prefix_memory_ratio")}))
        return 0

    if args.smoke:
        # CI tier-1 shape: small enough for the CPU, still overloaded
        # (20 requests into a 2-slot engine behind an 8-deep queue).
        args.requests = min(args.requests, 20)
        args.max_slots = 2
        args.max_len = 64
        args.prompt_bucket = 16
        args.max_new = 8

    policies = ALL_POLICIES if args.policy == "all" else (args.policy,)
    rows = run_serve_bench(
        policies=policies,
        **run_kw,
        requests=args.requests,
        max_slots=args.max_slots,
        max_len=args.max_len,
        prompt_bucket=args.prompt_bucket,
        max_new=args.max_new,
        overload=args.overload,
        high_frac=args.high_frac,
        deadline_tight=args.deadline_tight,
        deadline_loose=args.deadline_loose,
        seed=args.seed,
        spec_k=args.spec_k,
        spec_draft=args.spec_draft,
        workload=args.workload,
        page_size=args.page_size,
        kv_pages=args.kv_pages,
        decode_steps=int(args.decode_steps),
    )
    for row in rows:
        print(json.dumps(row))
    return 0


def main(argv=None) -> int:
    """``python -m accelerate_tpu_torch.commands.serve_bench``."""
    return serve_bench_command(serve_bench_command_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())

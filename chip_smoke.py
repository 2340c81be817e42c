"""Chip smoke test of the PyTorch + CUDA port (``accelerate_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. device — the card's ``nvidia-smi`` name and power limit; build every CUDA kernel
   of the serving path from ``accelerate_tpu_torch/csrc`` (all ``nvcc`` processes
   started together) and print the build seconds.
2. kernel — the paged-attention kernel against its plain PyTorch version on the card:
   the main path's shape (B=8, T=1, H=32, K=8, hd=128, page_size=16, 64 pages per
   lane, bf16) plus T=4, fp32, int8 pools, window, softcap, other head dims, sentinel
   table entries and a never-written lane; then kernel, plain and bound times at the
   main shape: device time from CUDA-graph replay between CUDA events, and call time
   (host work included) from CUDA events around calls; K/V pools rotate past the
   50 MB L2.
3. engine — the paged engine on the card against the same engine on the CPU
   (``debug`` config, fp32, same seeded params and requests): identical greedy tokens,
   first decode step's logits within tolerance.
4. main — the paged continuous-batching engine serving 10 requests at Llama-3-8B's
   full width and depth (bf16, seeded random weights made on the card), with the
   kernel's launch count checked against the decode dispatches; then a few decode
   steps under ``torch.profiler`` for the device's busy time and idle share.

Then the kernels line, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Hardware numbers of one H100 SXM (NVIDIA's data sheet): HBM rate and the dense
# tensor-core peak in bf16 (fp32 math outside the tensor cores: 67 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        run(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int) -> float:
    """Mean time of ``fn(i)`` as a caller sees it, host work included (CUDA events
    around ``iters`` calls, after warm-up)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


def device_ms(fn, n: int, replays: int) -> float:
    """Mean device time of ``fn(i)``: calls ``i = 0..n-1`` captured once into a CUDA
    graph, the graph replayed ``replays`` times between CUDA events (no host work
    between launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(lambda _: graph.replay(), replays) / n


# ------------------------------------------------------------------ phase 2: kernel
def make_paged_inputs(gen, *, B, T, H, K, hd, ps, MP, dtype, quantized, dev):
    """Seeded decode inputs: lane 0 never written (position 0, no valid slot, all
    sentinel entries); lane 1 has an unallocated (sentinel) page inside its range;
    the other lanes random lengths in [T, MP*ps]."""
    from accelerate_tpu_torch.models.common import paged_kv_planes, write_kv_paged

    C = MP * ps
    P = B * MP
    lens = torch.randint(T, C + 1, (B,), generator=gen).tolist()
    lens[0] = 0
    pool = paged_kv_planes(P, ps, K, hd, dtype, quantized, dev)
    tables = np.full((B, MP), P, np.int32)
    valid = np.zeros((B, C), bool)
    perm = torch.randperm(P, generator=gen).numpy()
    for b, n in enumerate(lens):
        n_pages = -(-n // ps)
        tables[b, :n_pages] = perm[b * MP:b * MP + n_pages]
        valid[b, :n] = True
        if b == 1 and n_pages > 2:  # a hole: sentinel entry, its slots not valid
            tables[b, 1] = P
            valid[b, ps:2 * ps] = False
    kv = torch.randn((2, B, C, K, hd), generator=gen).to(dev)
    pos = torch.arange(C)
    page_of = np.minimum(pos.numpy() // ps, MP - 1)
    pages = torch.as_tensor(np.where(valid, tables[:, page_of], P), device=dev)
    offs = (pos % ps).expand(B, C).to(dev)
    write_kv_paged(pool, "k", kv[0].to(dtype), pages, offs)
    write_kv_paged(pool, "v", kv[1].to(dtype), pages, offs)
    q = torch.randn((B, T, H, hd), generator=gen).to(dev, dtype)
    positions = torch.tensor([max(n - T, 0) for n in lens], dtype=torch.int32, device=dev)
    return (q, pool, torch.as_tensor(tables, device=dev), positions,
            torch.as_tensor(valid, device=dev), lens)


def paged_bound_ms(q, pool, lens, *, T, ps) -> tuple[float, str]:
    """Least time for one call on this card: the bytes it must move (live K/V slots,
    their scales, valid bits and table entries, q in and out) over the HBM rate, or
    its QK and PV flops over the peak for q's type, whichever is larger. Lane b's
    live slots are its ``lens[b]`` written ones (no window)."""
    _, _, H, hd = q.shape
    K = pool["k"].shape[2]
    slots = [max(n, 0) for n in lens]
    per_slot = K * hd * pool["k"].element_size() * 2 + 1
    if "k_scale" in pool:
        per_slot += K * 4 * 2
    n = sum(slots)
    nbytes = n * per_slot + sum(-(-s // ps) * 4 for s in slots) + 2 * q.numel() * q.element_size()
    flops = 4 * n * K * (T * H // K) * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel(dev) -> dict:
    from accelerate_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference,
    )

    gen = torch.Generator().manual_seed(1)
    main = dict(B=8, T=1, H=32, K=8, hd=128, ps=16, MP=64, dtype=torch.bfloat16,
                quantized=False)
    cases = [
        ("main", main, {}),
        ("T4", {**main, "T": 4}, {}),
        ("fp32", {**main, "dtype": torch.float32}, {}),
        ("int8_bf16", {**main, "quantized": True}, {}),
        ("int8_fp32", {**main, "dtype": torch.float32, "quantized": True}, {}),
        ("window_softcap_T3", {**main, "T": 3, "dtype": torch.float32},
         {"window": 100, "softcap": 30.0}),
        ("hd64_ps8", {**main, "hd": 64, "ps": 8, "MP": 40, "H": 16, "K": 4}, {}),
        ("hd256_G2", {**main, "hd": 256, "H": 16, "K": 8, "MP": 16}, {"softcap": 50.0}),
    ]
    errors = {}
    for name, shape, kw in cases:
        q, pool, tables, positions, valid, lens = make_paged_inputs(gen, dev=dev, **shape)
        args = dict(page_size=shape["ps"], sm_scale=shape["hd"] ** -0.5, **kw)
        out = paged_attention(q, pool, tables, positions, valid, **args)
        torch.cuda.synchronize()
        ref = paged_attention_reference(q, pool, tables, positions, valid, **args)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[shape["dtype"]]
        ok = bool(torch.isfinite(out).all()) and err <= tol
        emit({"phase": "kernel_check", "case": name, "max_abs_err": err, "tol": tol,
              "ok": ok})
        if not ok:
            raise SystemExit(f"paged_attention kernel disagrees with plain on {name}: "
                             f"{err} > {tol}")
        errors[name] = err

    # Timing at the main shape. Four input sets (each pool 32 MB) rotate so a launch
    # finds its K/V outside the 50 MB L2, as a decode step's per-layer pools are.
    sets = [make_paged_inputs(gen, dev=dev, **main) for _ in range(4)]
    args = dict(page_size=main["ps"], sm_scale=main["hd"] ** -0.5)

    def kernel(i):
        q, pool, tables, positions, valid, _ = sets[i % 4]
        paged_attention(q, pool, tables, positions, valid, **args)

    def plain(i):
        q, pool, tables, positions, valid, _ = sets[i % 4]
        paged_attention_reference(q, pool, tables, positions, valid, **args)

    # Device time in turns (plain, kernel, kernel, plain); the call time adds the
    # wrapper's host work, which a decode step pays once per layer.
    plain_ms = [device_ms(plain, 4, 10)]
    kernel_ms = [device_ms(kernel, 4, 50), device_ms(kernel, 4, 50)]
    plain_ms.append(device_ms(plain, 4, 10))
    kernel_call_ms = call_ms(kernel, 100)
    plain_call_ms = call_ms(plain, 20)
    bounds = [paged_bound_ms(s[0], s[1], s[5], T=main["T"], ps=main["ps"]) for s in sets]
    bound_ms = sum(b for b, _ in bounds) / len(bounds)
    res = {"phase": "kernel_time", "shape": {k: str(v) for k, v in main.items()},
           "kernel_ms": min(kernel_ms), "plain_ms": min(plain_ms),
           "kernel_ms_runs": kernel_ms, "plain_ms_runs": plain_ms,
           "kernel_call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
           "bound_ms": bound_ms, "bound_by": bounds[0][1],
           "live_slots_per_set": [sum(s[5]) for s in sets]}
    emit(res)
    return {"max_abs_err": errors["main"], "kernel_ms": res["kernel_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound_ms, "bound_by": res["bound_by"]}


# ------------------------------------------------------------------ phase 3: engine
def phase_engine(dev) -> None:
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    params_gpu = params_to(params_cpu, dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in (20, 45, 70, 100, 33)]
    runs = {}
    for name, params in (("cpu", params_cpu), ("gpu", params_gpu)):
        eng = ContinuousBatcher(params, cfg, max_slots=4, max_len=256, prompt_bucket=32,
                                page_size=16)
        reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        eng.step()  # admits the first four and runs the first decode step
        first = eng.last_logits.float().cpu()
        eng.run()
        runs[name] = ([r.tokens for r in reqs], first)
    tokens_equal = runs["cpu"][0] == runs["gpu"][0]
    # fp32 on both sides (TF32 off); the sums run in another order on the card's
    # kernels than on the CPU's, over 4 layers: 1e-3 absolute on logits of order 1.
    err = float((runs["cpu"][1] - runs["gpu"][1]).abs().max())
    ok = tokens_equal and err <= 1e-3
    emit({"phase": "engine_vs_cpu", "config": "debug", "tokens_equal": tokens_equal,
          "first_step_logits_max_abs_err": err, "tol": 1e-3, "ok": ok})
    if not ok:
        raise SystemExit("engine on the card disagrees with the engine on the CPU")


# ------------------------------------------------------------------ phase 4: main path
def phase_main(dev) -> int:
    from accelerate_tpu_torch.generation import GenerationConfig
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine_kw = dict(max_slots=8, max_len=1024, prompt_bucket=64, page_size=16)
    rng = np.random.default_rng(8)
    # Warm-up on a throwaway engine (cuBLAS handles, allocator pools).
    warm = ContinuousBatcher(params, cfg, **engine_kw)
    warm.submit(rng.integers(0, cfg.vocab_size, 70), max_new_tokens=4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eng = ContinuousBatcher(params, cfg, **engine_kw)
    lengths = rng.integers(64, 513, 10)
    reqs = []
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, cfg.vocab_size, int(n))
        if i in (3, 7):  # two sampled requests
            gen = GenerationConfig(max_new_tokens=64, temperature=0.8, top_k=50, top_p=0.95)
            reqs.append(eng.submit(prompt, gen=gen, seed=100 + i))
        else:
            reqs.append(eng.submit(prompt, max_new_tokens=64))
    paged_attention.launches = 0
    t0 = time.perf_counter()
    finite = True
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        if eng.last_logits is not None:
            finite &= bool(torch.isfinite(eng.last_logits).all())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    s = eng.stats()
    n_tokens = sum(len(r.tokens) for r in reqs)
    in_range = all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens)
    all_done = all(r.done and len(r.tokens) == 64 for r in reqs)
    launches_ok = s["decode_steps"] > 0 and launches == cfg.n_layers * s["decode_steps"]
    res = {
        "phase": "main", "config": "llama3-8b", "dtype": "bfloat16",
        "engine": engine_kw, "requests": len(reqs), "prompt_lengths": lengths.tolist(),
        "max_new_tokens": 64, "sampled": 2, "params_init_s": init_s,
        "wall_s": wall, "tokens": n_tokens, "tokens_per_s": n_tokens / wall,
        "decode_steps": s["decode_steps"], "decode_tokens": s["decode_tokens"],
        "mean_decode_step_ms": 1e3 * s["decode_s"] / max(s["decode_steps"], 1),
        "prefill_ms_total": 1e3 * s["prefill_s"],
        "prefill_ms_per_request": 1e3 * s["prefill_s"] / len(reqs),
        "paged_attention_launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "finite_logits": finite, "tokens_in_range": in_range, "all_done": all_done,
        "launches_ok": launches_ok, "pages_in_use_after": s["pages_in_use"],
    }
    res["ok"] = finite and in_range and all_done and launches_ok and s["pages_in_use"] == 0
    emit(res)
    if not res["ok"]:
        raise SystemExit("main path failed its checks")
    emit(profile_decode(eng, rng, cfg.vocab_size))
    return launches


def profile_decode(eng, rng, vocab: int, steps: int = 5) -> dict:
    """Where a decode step's time goes: ``steps`` decode steps with all lanes busy,
    under ``torch.profiler`` (after the counted run, so its cost touches no other
    number). Device busy time is the sum of the kernels' own device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, vocab, 200), max_new_tokens=steps + 4)
    eng.step()  # admissions + the first decode step
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    eng.run()
    kernels, n_launch = {}, 0
    for e in prof.key_averages():
        # Device-side events only: a CPU op's entry repeats its kernels' device time.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[e.key] = kernels.get(e.key, 0) + e.self_device_time_total
        n_launch += e.count
    busy_ms = sum(kernels.values()) / 1e3 / steps
    attn_ms = sum(v for k, v in kernels.items() if "paged_attention" in k) / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {
        "phase": "decode_profile", "steps": steps, "lanes": eng.max_slots,
        "wall_ms_per_step_profiled": wall_ms,
        "device_busy_ms_per_step": busy_ms if kernels else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels else None,
        "paged_attention_ms_per_step": attn_ms if kernels else None,
        "device_kernels_per_step": n_launch / steps if kernels else None,
        "top_kernels_ms_per_step": {k[:80]: v / 1e3 / steps for k, v in top},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from accelerate_tpu_torch.ops import _build

    # Full fp32 on the card: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = _build.build(["paged_attention"])
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text(), file=sys.stderr)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s})

    kern = phase_kernel(dev)
    phase_engine(dev)
    launches = phase_main(dev)
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
        "replaces": "accelerate_tpu/ops/paged_attention.py:106",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"], "kernel_ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

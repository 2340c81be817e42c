"""Chip smoke test of the PyTorch + CUDA port (``accelerate_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. device — the card's ``nvidia-smi`` name and power limit; build every CUDA kernel
   of the port from ``accelerate_tpu_torch/csrc`` (all ``nvcc`` processes started
   together) and print the build seconds.
2. kernel — the paged-attention kernel against its plain PyTorch version on the card:
   the serving path's shape (B=8, T=1, H=32, K=8, hd=128, page_size=16, 64 pages per
   lane, bf16) plus T=4, fp32, int8 pools, window, softcap, other head dims, sentinel
   table entries and a never-written lane; then kernel, plain and bound times: device
   time from CUDA-graph replay between CUDA events, and call time (host work included)
   from CUDA events around calls; K/V pools rotate past the 50 MB L2.
3. engine — the paged engine on the card against the same engine on the CPU
   (``debug`` config, fp32, same seeded params and requests): identical greedy tokens,
   first decode step's logits within tolerance.
4. main — the paged continuous-batching engine serving 10 requests at Llama-3-8B's
   full width and depth (bf16, seeded random weights made on the card), with the
   kernel's launch count checked against the decode dispatches; then a few decode
   steps under ``torch.profiler`` for the device's busy time and idle share.
5. flash — the flash-attention forward, dq and dk/dv kernels against their plain
   versions on the same inputs (the training path's shape B=2, H=32, K=8, S=2048,
   hd=128, bf16, causal; plus fp32, GQA 1, S=1000, packed segments with padding,
   window, softcap, offsets, hd 32 and 64), element by element on each row's scale;
   the same check must reject faults planted in the plain versions (a skipped kv
   tile, a cut-off q tile, p and ds left unrounded); then kernel, plain, bound and
   library times (SDPA forward; one aten flash-attention backward for dq, dk and dv).
6. adamw — the fused AdamW kernel against its plain version over the training path's
   leaf shapes, 3 steps, fp32 and bf16 first moments; then the time of one apply over
   the whole 8-layer tree beside ``torch._fused_adamw_``.
7. fused_xent — the fused linear + cross-entropy kernels (forward; one backward for dx
   and dw) against their plain versions on the same inputs: the training path's shape
   T=4096, D=4096, V=128256, bf16; plus fp32 at T=300, D=256, V=1000 (ragged against
   every tile), softcap 30, ignored targets with a cotangent that is zero on some rows,
   and the tied (transposed) head, each element on its row's scale; the same check must
   reject faults planted in the plain versions (the last vocab tile skipped, the
   softcap's chain rule dropped, d left unrounded); then kernel, plain and bound times
   beside the chunked CE the kernels replace (chunk 512, forward and forward+backward).
8. train_parity — ``Accelerator.build_train_step`` on the card against the same step
   on the CPU (``debug`` config, fp32, 3 steps of ``adamw``, of ``fused_adamw`` and of
   ``fused_adamw`` with ``loss_impl="fused"``).
9. train_main — the training main path at Llama-3-8B's full width, depth cut to 8
   layers: bf16 over fp32 masters, remat, flash attention, chunked CE, ``fused_adamw``,
   global-norm clip; 7 steps on one seeded batch with every kernel's launches counted;
   then one step under ``torch.profiler``.
10. train_fused — the same run with ``loss_impl="fused"``: the fused CE kernels launch
   once each per step, and the first step's loss matches train_main's.

Then the kernels line, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
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


# ------------------------------------------------------------ phase 5: flash kernels
FLASH_MAIN = dict(B=2, H=32, K=8, S=2048, T=2048, hd=128, dtype=torch.bfloat16)


def make_flash_inputs(gen, *, B, H, K, S, T, hd, dtype, dev, segments=False):
    """Seeded q [B,H,S,hd], k/v [B,K,T,hd], do, and (optionally) packed segment ids
    with zero padding at each row's end (so some query rows see no key)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    q, k, v, do = randn(B, H, S, hd), randn(B, K, T, hd), randn(B, K, T, hd), randn(B, H, S, hd)
    segs = None
    if segments:
        ids = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(torch.randint(1, S, (3,), generator=gen).numpy())
            ids[b, :cuts[0]], ids[b, cuts[0]:cuts[1]], ids[b, cuts[1]:cuts[2]] = 1, 2, 3
        segs = torch.as_tensor(ids, device=dev)
    return q, k, v, do, segs


# Flash tolerances: every element within ``elem`` of its scale (for o, dq, dk, dv the
# rms of its row of the reference, plus its own magnitude, plus a hundredth of the
# tensor's rms for rows that cancel to ~0; for lse 1 + its magnitude), and the whole
# tensor's rms error within ``rms`` of the reference's rms. Each is set a few times
# above the largest error the kernels showed on the card over all cases (PERF.md); the
# bf16 ``elem`` stays under the 3e-2 cap and the fp32 ones under 1e-4. The gradients'
# ``rms`` also rejects p or ds left unrounded before their products.
FLASH_TOL = {
    torch.bfloat16: {"o": {"elem": 3e-2, "rms": 5e-3}, "grad": {"elem": 2e-2, "rms": 3e-4}},
    torch.float32: {"o": {"elem": 1e-5, "rms": 1e-6}, "grad": {"elem": 1e-5, "rms": 1e-6}},
    "lse": {"elem": 2e-6, "rms": 5e-7},
}


def flash_errors(got: torch.Tensor, want: torch.Tensor, rowwise: bool = False) -> dict:
    """``elem``: max |got - want| / scale; ``rms``: rms(got - want) over rms(want). The
    scale is per row (the rms of the element's row, its own magnitude and a hundredth of
    the tensor's rms) for 4-D and ``rowwise`` tensors, else 1 + |want|."""
    w = want.float()
    d = (got.float() - w).abs()
    rms_w = w.square().mean().sqrt()
    if w.dim() == 4 or rowwise:
        scale = w.square().mean(-1, keepdim=True).sqrt() + w.abs() + 1e-2 * rms_w
    else:
        scale = 1.0 + w.abs()
    elem = torch.where(d == 0, 0.0, d / scale)
    return {"elem": float(elem.max()), "rms": float(d.square().mean().sqrt()
                                                    / rms_w.clamp_min(1e-30))}


def flash_within(errs: dict, dtype) -> dict:
    """Per output, whether its errors are within the tolerances of ``dtype``."""
    def tol(n):
        return FLASH_TOL["lse"] if n == "lse" else FLASH_TOL[dtype]["o" if n == "o" else "grad"]

    return {n: all(e[m] <= tol(n)[m] for m in e) for n, e in errs.items()}


def flash_outputs(fa, q, k, v, do, lse, delta, args, plain: bool) -> dict:
    """o, lse, dq, dk, dv from the kernels or the plain versions; the backward gets the
    given lse and delta."""
    fwd, dq, dkv = ((fa.flash_attention_reference, fa.flash_dq_reference,
                     fa.flash_dkv_reference) if plain else (fa._fwd, fa._bwd_dq, fa._bwd_dkv))
    out = dict(zip(("o", "lse"), fwd(q, k, v, **args)))
    out["dq"] = dq(q, k, v, do, lse, delta, **args)
    out["dk"], out["dv"] = dkv(q, k, v, do, lse, delta, **args)
    return out


def flash_planted_faults(fa, q, k, v, do, ref, delta, args) -> dict:
    """The check of the main case applied to the plain versions with a fault planted:
    kv tile 0 (64 keys) skipped by every later query row; the last q tile cut off from
    every earlier key; p and ds left unrounded before their products (the references
    on the fp32 values of the same inputs, o rounded to the input type as the kernel
    writes it). The backward of each gets the sound lse and delta."""
    B, _, S, _ = q.shape
    ones = torch.ones((B, S), dtype=torch.int32, device=q.device)
    tile0, last = ones.clone(), ones.clone()
    tile0[:, 64:] = 2
    last[:, -64:] = 2
    faults = {}
    for name, seg in (("kv_tile0_skipped", tile0), ("last_q_tile_cut_off", last)):
        bad = flash_outputs(fa, q, k, v, do, ref["lse"], delta, {**args, "segments": seg},
                            plain=True)
        faults[name] = bad
    f32 = [x.float() for x in (q, k, v, do)]
    bad = flash_outputs(fa, *f32, ref["lse"], delta, args, plain=True)
    bad["o"] = bad["o"].to(q.dtype)
    faults["p_ds_unrounded"] = bad
    result = {}
    for name, bad in faults.items():
        errs = {n: flash_errors(bad[n], ref[n]) for n in ref}
        within = flash_within(errs, q.dtype)
        result[name] = {"errors": errs, "caught": [n for n, ok in within.items() if not ok]}
    return result


def flash_bound_ms(S, T, B, H, K, hd, causal, window, itemsize, which) -> tuple[float, str]:
    """Least time of one flash call on this card: its matrix-product flops over the bf16
    (or fp32) peak, or its bytes over the HBM rate, whichever is larger. Flops count the
    (query, key) pairs this call's mask leaves visible (no offsets, no segments), two
    flops per multiply-add: forward 2 products (q·k, p·v), dq 3 (q·k, do·v, ds·k),
    dk/dv 4 (q·k, do·v, pᵀ·do, dsᵀ·q). Bytes: every input read once, every output
    written once (fp32 gradients, fp32 lse/delta)."""
    rows = np.arange(S)[:, None]
    cols = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis &= cols <= rows
    if window:
        vis &= cols > rows - window
    pairs = int(vis.sum())
    products = {"fwd": 2, "dq": 3, "dkv": 4}[which]
    flops = 2 * products * B * H * pairs * hd
    q_bytes, kv_bytes = B * H * S * hd * itemsize, B * K * T * hd * itemsize
    nbytes = {
        "fwd": 2 * q_bytes + 2 * kv_bytes + B * H * S * 4,
        "dq": 2 * q_bytes + 2 * kv_bytes + 2 * B * H * S * 4 + B * H * S * hd * 4,
        "dkv": 2 * q_bytes + 2 * kv_bytes + 2 * B * H * S * 4 + 2 * (kv_bytes // itemsize) * 4,
    }[which]
    peak = PEAK_FLOPS[torch.bfloat16 if itemsize == 2 else torch.float32]
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_flash(dev) -> dict:
    """Forward, dq and dk/dv kernels against their plain versions on the same inputs
    (the backward kernels get the plain forward's lse and delta), then times at the
    main shape."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(2)
    main = FLASH_MAIN
    small = {**main, "S": 512, "T": 512}
    cases = [
        ("main_bf16_causal_G4", main, {}),
        ("fp32_G4", {**small, "H": 8, "K": 2, "dtype": torch.float32}, {}),
        ("G1", {**small, "H": 8, "K": 8}, {}),
        ("S1000_padding", {**main, "S": 1000, "T": 1000, "H": 8, "K": 2}, {}),
        ("segments_zero_pad", {**small, "H": 8, "K": 2}, {"segments": True}),
        ("window256", {**main, "S": 1024, "T": 1024, "H": 8, "K": 2}, {"window": 256}),
        ("softcap50", {**small, "H": 8, "K": 2}, {"softcap": 50.0}),
        ("offsets_q256_kv0", {**small, "S": 256, "H": 8, "K": 2},
         {"q_offset": 256, "kv_offset": 0}),
        ("noncausal_fp32_offsets", {**small, "S": 192, "T": 320, "H": 4, "K": 2,
                                    "dtype": torch.float32},
         {"causal": False, "q_offset": 64, "kv_offset": 32}),
        ("hd32_segments_softcap", {**small, "hd": 32, "H": 8, "K": 4},
         {"segments": True, "softcap": 20.0}),
        ("hd64_window_fp32", {**small, "hd": 64, "H": 4, "K": 1, "dtype": torch.float32},
         {"window": 100}),
    ]
    errors, failed, faults = {}, [], None
    for name, shape, kw in cases:
        kw = dict(kw)
        q, k, v, do, segs = make_flash_inputs(gen, dev=dev, segments=kw.pop("segments", False),
                                              **shape)
        args = dict(causal=kw.pop("causal", True), sm_scale=shape["hd"] ** -0.5,
                    segments=segs, **kw)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, **args)
        delta = (do.float() * o_ref.float()).sum(-1)
        got = flash_outputs(fa, q, k, v, do, lse_ref, delta, args, plain=False)
        torch.cuda.synchronize()
        ref = flash_outputs(fa, q, k, v, do, lse_ref, delta, args, plain=True)
        live = lse_ref > -1e29  # rows that see a key (others: lse = -1e30 on both sides)
        masked_exact = (bool(torch.equal(got["lse"][~live], ref["lse"][~live]))
                        and not bool(got["o"][~live].any()) and not bool(got["dq"][~live].any()))
        got["lse"], ref["lse"] = got["lse"][live], ref["lse"][live]
        errs = {n: flash_errors(got[n], ref[n]) for n in ref}
        max_abs = {n: float((got[n].float() - ref[n].float()).abs().max()) for n in ref}
        within = flash_within(errs, shape["dtype"])
        finite = all(bool(torch.isfinite(got[n]).all()) for n in ("o", "dq", "dk", "dv"))
        ok = finite and masked_exact and all(within.values())
        emit({"phase": "flash_check", "case": name, "errors": errs, "max_abs": max_abs,
              "masked_rows": int((~live).sum()), "masked_rows_exact": masked_exact,
              "tol": FLASH_TOL[shape["dtype"]], "tol_lse": FLASH_TOL["lse"], "ok": ok})
        if not ok:
            failed.append(name)
        errors[name] = {"errors": errs, "max_abs": max_abs}
        if name == "main_bf16_causal_G4":
            ref["lse"] = lse_ref
            faults = flash_planted_faults(fa, q, k, v, do, ref, delta, args)
        del q, k, v, do, got, ref, o_ref, lse_ref, delta
    # The check must reject each planted fault in every output it changes (the
    # unrounded p and ds leave lse as it is, and o within its bf16 rounding).
    must_catch = {"kv_tile0_skipped": ["o", "lse", "dq", "dk", "dv"],
                  "last_q_tile_cut_off": ["o", "lse", "dq", "dk", "dv"],
                  "p_ds_unrounded": ["dq", "dk", "dv"]}
    for name, res in faults.items():
        res["must_catch"] = must_catch[name]
        emit({"phase": "flash_planted_fault", "fault": name, **res})
        if not set(must_catch[name]) <= set(res["caught"]):
            failed.append(f"planted fault {name} passes the check")
    if failed:
        raise SystemExit(f"flash kernels disagree with their plain versions: {failed}")

    # Times at the main shape: device time from CUDA-graph replay (kernels and plain
    # versions), in turns plain, kernel, kernel, plain; SDPA as the library yardstick.
    q, k, v, do, _ = make_flash_inputs(gen, dev=dev, **main)
    args = dict(causal=True, sm_scale=main["hd"] ** -0.5)
    o_ref, lse = fa.flash_attention_reference(q, k, v, **args)
    delta = (do.float() * o_ref.float()).sum(-1)
    del o_ref
    calls = {
        "fwd": (lambda _: fa._fwd(q, k, v, **args),
                lambda _: fa.flash_attention_reference(q, k, v, **args)),
        "dq": (lambda _: fa._bwd_dq(q, k, v, do, lse, delta, **args),
               lambda _: fa.flash_dq_reference(q, k, v, do, lse, delta, **args)),
        "dkv": (lambda _: fa._bwd_dkv(q, k, v, do, lse, delta, **args),
                lambda _: fa.flash_dkv_reference(q, k, v, do, lse, delta, **args)),
    }
    times = {}
    for which, (kernel, plain) in calls.items():
        plain_runs = [device_ms(plain, 1, 3)]
        kernel_runs = [device_ms(kernel, 2, 10), device_ms(kernel, 2, 10)]
        plain_runs.append(device_ms(plain, 1, 3))
        torch.cuda.empty_cache()
        bound, bound_by = flash_bound_ms(main["S"], main["T"], main["B"], main["H"], main["K"],
                                         main["hd"], True, 0, 2, which)
        times[which] = {"kernel_ms": min(kernel_runs), "plain_ms": min(plain_runs),
                        "kernel_ms_runs": kernel_runs, "plain_ms_runs": plain_runs,
                        "bound_ms": bound, "bound_by": bound_by}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times["fwd"]["library_ms"] = device_ms(
        lambda _: sdpa(q, k, v, is_causal=True, enable_gqa=True), 2, 10)
    # The library's backward: one aten flash-attention call computes dq, dk and dv from
    # o and lse. It takes no GQA, so K/V are expanded to H heads once, before timing
    # (its dk/dv come per q head, not yet summed over each group).
    G = main["H"] // main["K"]
    ke, ve = (x.repeat_interleave(G, dim=1) for x in (k, v))
    aten = torch.ops.aten
    out, lse_l, cq, ck, mq, mk, seed, offset = aten._scaled_dot_product_flash_attention(
        q, ke, ve, 0.0, True, False, scale=args["sm_scale"])[:8]
    library_bwd_ms = device_ms(lambda _: aten._scaled_dot_product_flash_attention_backward(
        do, q, ke, ve, out, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset,
        scale=args["sm_scale"]), 2, 10)
    times["dq"]["library_ms"] = times["dkv"]["library_ms"] = library_bwd_ms
    times["library_bwd_covers"] = "dq+dk+dv (aten flash-attention backward, K/V expanded)"
    times["kernels_dq_plus_dkv_ms"] = times["dq"]["kernel_ms"] + times["dkv"]["kernel_ms"]
    del ke, ve, out
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd(_):
        o_ = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o_, (qg, kg, vg), do)

    # SDPA forward + backward as a caller sees it (host work and autograd included).
    times["sdpa_fwd_bwd_call_ms"] = call_ms(sdpa_fwd_bwd, 10)
    times["kernels_fwd_dq_dkv_ms"] = sum(times[w]["kernel_ms"] for w in ("fwd", "dq", "dkv"))
    emit({"phase": "flash_time", "shape": {k_: str(v_) for k_, v_ in main.items()}, **times})
    return {"errors": errors["main_bf16_causal_G4"], "times": times}


# ------------------------------------------------------------- phase 6: AdamW kernel
def llama_leaf_shapes(cfg, n_layers: int) -> dict:
    """The training main path's param leaves (name → shape), ``n_layers`` layers deep."""
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.head_dim
    layer = {"ln_attn": (D,), "wq": (D, cfg.n_heads * hd), "wk": (D, cfg.n_kv_heads * hd),
             "wv": (D, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, D), "ln_mlp": (D,),
             "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
    shapes = {"embed": (V, D), "lm_head": (D, V), "ln_f": (D,)}
    for i in range(n_layers):
        shapes.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    return shapes


def _adam_tree(shapes, dev, gen, mu_dtype):
    """params (normal * 0.02), moments at 0, and 3 steps of gradients, all on the card."""
    def normal(shape, scale):
        return torch.empty(shape, device=dev).normal_(0.0, scale, generator=gen)

    params = {n: normal(s, 0.02) for n, s in shapes.items()}
    mu = {n: torch.zeros(s, device=dev, dtype=mu_dtype) for n, s in shapes.items()}
    nu = {n: torch.zeros(s, device=dev) for n, s in shapes.items()}
    return params, mu, nu


def phase_adamw(dev, main_layers: int) -> dict:
    """The fused AdamW kernel against its plain version over the main path's leaf shapes
    (embed, lm_head, ln_f and one layer), 3 steps, fp32 and bf16 first moments; then
    times of one apply over the full main-path tree (``main_layers`` layers)."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.optim import AdamState

    cfg = llama.CONFIGS["llama3-8b"]
    gen = torch.Generator(dev).manual_seed(3)
    shapes = llama_leaf_shapes(cfg, 1)
    result = {}
    for mu_dtype in (torch.float32, torch.bfloat16):
        opt = {"kernel": fo.fused_adamw(1e-3, mu_dtype=mu_dtype),
               "plain": fo.fused_adamw(1e-3, mu_dtype=mu_dtype, use_kernel=False)}
        params, mu, nu = _adam_tree(shapes, dev, gen, mu_dtype)
        runs = {"kernel": (params, AdamState(0, mu, nu)),
                "plain": ({n: p.clone() for n, p in params.items()},
                          AdamState(0, {n: m.clone() for n, m in mu.items()},
                                    {n: x.clone() for n, x in nu.items()}))}
        for step in range(3):
            grads = {n: torch.empty(s, device=dev).normal_(0.0, 1e-3, generator=gen)
                     for n, s in shapes.items()}
            scale = torch.tensor(0.5 + 0.25 * step, device=dev)  # a clip factor on the card
            for name, (p, st) in runs.items():
                runs[name] = opt[name].fused_apply(grads, st, p, grad_scale=scale)
            del grads
        torch.cuda.synchronize()
        (pk, sk), (pp, sp) = runs["kernel"], runs["plain"]
        rel, absd = 0.0, 0.0
        for a, b in [(pk[n], pp[n]) for n in shapes] + [(sk.mu[n], sp.mu[n]) for n in shapes] \
                + [(sk.nu[n], sp.nu[n]) for n in shapes]:
            d = (a.float() - b.float()).abs()
            absd = max(absd, float(d.max()))
            rel = max(rel, float((d / b.float().abs().clamp_min(1e-30)).max()))
        tag = "fp32" if mu_dtype == torch.float32 else "bf16"
        ok = rel <= 1e-6
        emit({"phase": "adamw_check", "mu_dtype": tag, "steps": 3, "leaves": len(shapes),
              "params": sum(int(np.prod(s)) for s in shapes.values()),
              "max_abs_err": absd, "max_rel_err": rel, "tol_rel": 1e-6, "ok": ok})
        if not ok:
            raise SystemExit(f"fused AdamW kernel disagrees with its plain version ({tag})")
        result[f"max_abs_err_{tag}"] = absd
        del runs, params, mu, nu, pk, pp, sk, sp
        torch.cuda.empty_cache()

    # Times of one apply over the whole main-path tree, fp32 moments (28 B per param).
    shapes = llama_leaf_shapes(cfg, main_layers)
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    params, mu, nu = _adam_tree(shapes, dev, gen, torch.float32)
    grads = {n: torch.empty(s, device=dev).normal_(0.0, 1e-3, generator=gen)
             for n, s in shapes.items()}
    state = AdamState(0, mu, nu)
    kernel_opt = fo.fused_adamw(1e-4)
    plain_opt = fo.fused_adamw(1e-4, use_kernel=False)
    plist, glist = list(params.values()), list(grads.values())
    mlist, vlist = list(mu.values()), list(nu.values())
    steps = [torch.tensor(1.0, device=dev) for _ in plist]

    def library(_):
        torch._fused_adamw_(plist, glist, mlist, vlist, [], steps, lr=1e-4, beta1=0.9,
                            beta2=0.999, weight_decay=1e-4, eps=1e-8, amsgrad=False,
                            maximize=False)

    before = fo.adamw_leaves.launches
    kernel_opt.fused_apply(grads, state, params)
    launches_per_apply = fo.adamw_leaves.launches - before
    times = {
        "plain": [call_ms(lambda _: plain_opt.fused_apply(grads, state, params), 2)],
        "kernel": [call_ms(lambda _: kernel_opt.fused_apply(grads, state, params), 5)
                   for _ in range(2)],
        "library": [call_ms(library, 5)],
    }
    times["plain"].append(call_ms(lambda _: plain_opt.fused_apply(grads, state, params), 2))
    bound_ms = 1e3 * 28 * n_params / HBM_BYTES_PER_S
    res = {"phase": "adamw_time", "layers": main_layers, "leaves": len(shapes),
           "params": n_params, "kernel_ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
           "library_ms": times["library"][0], "runs_ms": times, "bound_ms": bound_ms,
           "bound_by": "bytes", "launches_per_apply": launches_per_apply}
    emit(res)
    del params, mu, nu, grads, state, plist, glist, mlist, vlist
    torch.cuda.empty_cache()
    return {**result, **res}


# ------------------------------------------------------ phase 7: fused cross-entropy
XENT_MAIN = dict(T=4096, D=4096, V=128256, dtype=torch.bfloat16)
XENT_TILE_V = 256  # the bf16 kernels' vocab tile (kBV in csrc/fused_xent.cu)

# Fused-CE tolerances, in flash_errors' terms: nll and lse against 1 + |want|; dx and dw
# element by element on their row's scale, and the whole tensor's rms error. Kernel and
# plain version take the same roundings and differ only in the order of their fp32 sums
# (and the atomics' order, which changes from run to run). bf16 dx/dw flip by one bf16
# step where d or the result sits next to a rounding boundary. Each limit is a few
# times above the largest error the kernels showed on the card over all cases
# (PERF.md); the bf16 gradients' rms limit sits 5x below the error of d left unrounded.
XENT_TOL = {
    torch.bfloat16: {"stat": {"elem": 1e-5, "rms": 2e-6}, "grad": {"elem": 2e-2, "rms": 5e-4}},
    torch.float32: {"stat": {"elem": 1e-5, "rms": 2e-6}, "grad": {"elem": 2e-5, "rms": 2e-6}},
}


def make_xent_inputs(gen, *, T, D, V, dtype, dev, score_std=1.0, tied=False, ignored=0.0,
                     zero_g=0.0):
    """Seeded x [T,D] (unit normal, as post-norm hidden states), w [D,V] scaled so the
    scores have std ``score_std`` (``tied``: the transposed view of an embedding
    [V,D]), targets in [0,V) with every 97th in the last vocab tile and a share
    ``ignored`` of them -1, and the cotangent g [T] uniform in [0,1) with a share
    ``zero_g`` of rows 0."""
    x = torch.randn((T, D), generator=gen, device=dev).to(dtype)
    scale = score_std / math.sqrt(D)
    if tied:
        w = (torch.randn((V, D), generator=gen, device=dev) * scale).to(dtype).T
    else:
        w = (torch.randn((D, V), generator=gen, device=dev) * scale).to(dtype)
    t = torch.randint(0, V, (T,), generator=gen, device=dev)
    t[::97] = V - 1
    t[torch.rand((T,), generator=gen, device=dev) < ignored] = -1
    g = torch.rand((T,), generator=gen, device=dev)
    g[torch.rand((T,), generator=gen, device=dev) < zero_g] = 0.0
    return x, w, t, g


def xent_outputs(fx, x, w, t, g, lse, cap, plain: bool) -> dict:
    """nll, lse, dx, dw from the kernels or the plain versions; the backward gets the
    given lse."""
    if plain:
        nll, lse_out = fx.fused_xent_reference(x, w, t, cap)
        return {"nll": nll, "lse": lse_out,
                "dx": fx.fused_xent_dx_reference(x, w, t, lse, g, cap),
                "dw": fx.fused_xent_dw_reference(x, w, t, lse, g, cap)}
    out = dict(zip(("nll", "lse"), fx._fwd(x, w, t, cap)))
    out["dx"], out["dw"] = fx._bwd(x, w, t, lse, g, cap)
    return out


def xent_check(got: dict, ref: dict, dtype) -> tuple[dict, dict]:
    """Errors of every output (flash_errors, rows for dx and dw) and whether each is
    within XENT_TOL."""
    errs = {n: flash_errors(got[n], ref[n], rowwise=ref[n].dim() == 2) for n in ref}
    tol = XENT_TOL[dtype]
    within = {n: all(e[m] <= tol["grad" if n in ("dx", "dw") else "stat"][m] for m in e)
              for n, e in errs.items()}
    return errs, within


def xent_planted_faults(fx, x, w, t, g, ref, cap, kinds) -> dict:
    """Faulty plain versions, the ``kinds`` named: the last vocab tile skipped (its
    columns dropped from every sum; a target there matches nothing); d left unrounded
    (the references on the fp32 values of the same inputs, outputs in the input type);
    the softcap's chain rule 1 - (capped/cap)^2 dropped. The backward of each gets the
    sound lse."""
    lse = ref["lse"]
    faults = {}
    if "last_vocab_tile_skipped" in kinds:
        cut = (w.shape[1] - 1) // XENT_TILE_V * XENT_TILE_V
        nll_s, lse_s = fx.fused_xent_reference(x, w[:, :cut], t, cap)
        dw_s = torch.zeros_like(ref["dw"])
        dw_s[:, :cut] = fx.fused_xent_dw_reference(x, w[:, :cut], t, lse, g, cap)
        faults["last_vocab_tile_skipped"] = {
            "nll": nll_s, "lse": lse_s,
            "dx": fx.fused_xent_dx_reference(x, w[:, :cut], t, lse, g, cap), "dw": dw_s}
    if "d_unrounded" in kinds:
        faults["d_unrounded"] = {
            **ref, "dx": fx.fused_xent_dx_reference(x, w.float(), t, lse, g, cap),
            "dw": fx.fused_xent_dw_reference(x.float(), w, t, lse, g, cap)}
    if "softcap_chain_dropped" in kinds:
        s, _ = fx._scores(x, w, cap)
        d = fx._dlogits(s, None, lse, g, t)
        faults["softcap_chain_dropped"] = {**ref, "dx": fx._dx_from(d, w, x.dtype),
                                           "dw": fx._dw_from(d, x, w.dtype)}
    result = {}
    for name, bad in faults.items():
        errs, within = xent_check(bad, ref, x.dtype)
        result[name] = {"errors": errs, "caught": [n for n, ok in within.items() if not ok]}
    return result


def xent_bound_ms(T, D, V, itemsize, which) -> tuple[float, str]:
    """Least time of one call on this card: its matrix-product flops over the bf16 (or
    fp32) peak, or its bytes over the HBM rate, whichever is larger. Flops: the forward
    2·T·D·V (the scores); the backward kernel 6·T·D·V (the scores once, d·wᵀ and xᵀ·d).
    Bytes: every input read once (int32 targets; fp32 lse and g), every output written
    once (fp32 nll and lse; dx and dw in the input type)."""
    io = (T * D + D * V) * itemsize + 4 * T
    nbytes = io + 8 * T + ((T * D + D * V) * itemsize if which == "bwd" else 0)
    flops = {"fwd": 2, "bwd": 6}[which] * T * D * V
    peak = PEAK_FLOPS[torch.bfloat16 if itemsize == 2 else torch.float32]
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_fused_xent(dev) -> dict:
    """The fused CE kernels against their plain versions on the same inputs (the
    backward gets the plain forward's lse), then times at the main shape."""
    from accelerate_tpu_torch.models.common import chunked_ce
    from accelerate_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator(dev).manual_seed(5)
    cases = [
        ("main_bf16", XENT_MAIN, {}),
        ("fp32_ragged", dict(T=300, D=256, V=1000, dtype=torch.float32), {}),
        ("softcap30_bf16", dict(T=1000, D=512, V=5000, dtype=torch.bfloat16),
         {"softcap": 30.0, "score_std": 30.0}),
        ("ignored_targets_zero_g", dict(T=700, D=1024, V=32000, dtype=torch.bfloat16),
         {"ignored": 0.125, "zero_g": 0.125}),
        ("tied_head", dict(T=512, D=1024, V=16000, dtype=torch.bfloat16), {"tied": True}),
        ("fp32_softcap_tied", dict(T=300, D=256, V=1000, dtype=torch.float32),
         {"softcap": 30.0, "score_std": 30.0, "tied": True}),
    ]
    errors, failed, faults = {}, [], {}
    for name, shape, kw in cases:
        kw = dict(kw)
        cap = kw.pop("softcap", 0.0)
        x, w, t, g = make_xent_inputs(gen, dev=dev, **shape, **kw)
        _, lse_ref = fx.fused_xent_reference(x, w, t, cap)
        got = xent_outputs(fx, x, w, t, g, lse_ref, cap, plain=False)
        torch.cuda.synchronize()
        ref = xent_outputs(fx, x, w, t, g, lse_ref, cap, plain=True)
        errs, within = xent_check(got, ref, shape["dtype"])
        max_abs = {n: float((got[n].float() - ref[n].float()).abs().max()) for n in ref}
        finite = all(bool(torch.isfinite(got[n]).all()) for n in got)
        shapes_ok = all(got[n].shape == ref[n].shape and got[n].dtype == ref[n].dtype
                        for n in ref)
        ok = finite and shapes_ok and all(within.values())
        emit({"phase": "fused_xent_check", "case": name, "softcap": cap, "errors": errs,
              "max_abs": max_abs, "tol": XENT_TOL[shape["dtype"]], "ok": ok})
        if not ok:
            failed.append(name)
        errors[name] = {"errors": errs, "max_abs": max_abs}
        kinds = {"main_bf16": ("last_vocab_tile_skipped", "d_unrounded"),
                 "softcap30_bf16": ("softcap_chain_dropped",)}.get(name, ())
        faults.update(xent_planted_faults(fx, x, w, t, g, ref, cap, kinds))
        del x, w, t, g, got, ref, lse_ref
        torch.cuda.empty_cache()
    must_catch = {"last_vocab_tile_skipped": ["nll", "lse", "dx", "dw"],
                  "d_unrounded": ["dx", "dw"], "softcap_chain_dropped": ["dx", "dw"]}
    for name, res in faults.items():
        res["must_catch"] = must_catch[name]
        emit({"phase": "fused_xent_planted_fault", "fault": name, **res})
        if not set(must_catch[name]) <= set(res["caught"]):
            failed.append(f"planted fault {name} passes the check")
    if set(faults) != set(must_catch):
        failed.append(f"planted faults run: {sorted(faults)}")
    if failed:
        raise SystemExit(f"fused CE kernels disagree with their plain versions: {failed}")

    # Times at the main shape: device time from CUDA-graph replay, in turns plain,
    # kernel, kernel, plain; the chunked CE the kernels replace beside them.
    main = XENT_MAIN
    T, D, V = main["T"], main["D"], main["V"]
    x, w, t, g = make_xent_inputs(gen, dev=dev, **main)
    _, lse = fx.fused_xent_reference(x, w, t)
    calls = {
        "fwd": (lambda _: fx._fwd(x, w, t), lambda _: fx.fused_xent_reference(x, w, t)),
        "bwd": (lambda _: fx._bwd(x, w, t, lse, g),
                lambda _: (fx.fused_xent_dx_reference(x, w, t, lse, g),
                           fx.fused_xent_dw_reference(x, w, t, lse, g))),
    }
    times = {}
    for which, (kernel, plain) in calls.items():
        plain_runs = [device_ms(plain, 1, 2)]
        torch.cuda.empty_cache()
        kernel_runs = [device_ms(kernel, 2, 5), device_ms(kernel, 2, 5)]
        plain_runs.append(device_ms(plain, 1, 2))
        torch.cuda.empty_cache()
        bound, bound_by = xent_bound_ms(T, D, V, 2, which)
        times[which] = {"kernel_ms": min(kernel_runs), "plain_ms": min(plain_runs),
                        "kernel_ms_runs": kernel_runs, "plain_ms_runs": plain_runs,
                        "bound_ms": bound, "bound_by": bound_by}
    # The chunked CE at the training path's layout ([2, 2048] tokens, chunk 512): its
    # forward from graph replay; forward + backward, and the fused path's, as a caller
    # sees them (autograd and host work included).
    B = 2
    x3, t2 = x.view(B, T // B, D), t.view(B, T // B)
    mask = torch.ones((B, T // B), device=dev)
    with torch.no_grad():
        chunked_fwd_ms = device_ms(lambda _: chunked_ce(x3, w, t2, mask, 512, torch.bfloat16),
                                   1, 3)
    xg, wg = x3.detach().requires_grad_(), w.detach().requires_grad_()

    def chunked_fwd_bwd(_):
        loss = chunked_ce(xg, wg, t2, mask, 512, torch.bfloat16)
        torch.autograd.grad(loss, (xg, wg))

    def fused_fwd_bwd(_):
        loss = fx.fused_cross_entropy(xg.view(T, D), wg, t).sum()
        torch.autograd.grad(loss, (xg, wg))

    chunked_fb = [call_ms(chunked_fwd_bwd, 3)]
    fused_fb = [call_ms(fused_fwd_bwd, 3), call_ms(fused_fwd_bwd, 3)]
    chunked_fb.append(call_ms(chunked_fwd_bwd, 3))
    times["chunked_ce"] = {"chunk": 512, "fwd_ms": chunked_fwd_ms,
                           "fwd_bwd_call_ms": min(chunked_fb), "fwd_bwd_call_ms_runs": chunked_fb}
    times["fused_fwd_bwd_call_ms"] = min(fused_fb)
    times["fused_fwd_bwd_call_ms_runs"] = fused_fb
    times["kernels_fwd_bwd_ms"] = times["fwd"]["kernel_ms"] + times["bwd"]["kernel_ms"]
    emit({"phase": "fused_xent_time", "shape": {k: str(v) for k, v in main.items()}, **times})
    del x, w, t, g, lse, xg, wg, x3
    torch.cuda.empty_cache()
    return {"errors": errors["main_bf16"], "times": times}


# ------------------------------------------------------------ phase 8: train parity
def _clone_to(params, dev):
    from accelerate_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().clone().to(dev), params)


def _fresh_state_singletons():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def phase_train_parity(dev) -> None:
    """``build_train_step`` on the card against the same step on the CPU: ``debug``
    config, fp32 (TF32 off), the same seeded params and batch, 3 steps with
    ``max_grad_norm=1.0``: ``adamw``, ``fused_adamw``, and ``fused_adamw`` with
    ``loss_impl="fused"`` (the kernels on the card, their plain versions on the CPU)."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw

    base = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32, attn_impl="flash")
    params = llama.init_params(base, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": np.random.default_rng(4).integers(0, base.vocab_size, (2, 129))}
    lr = 1e-3
    for opt_name, make_opt, loss_impl in (("adamw", optim.adamw, "auto"),
                                          ("fused_adamw", fused_adamw, "auto"),
                                          ("fused_adamw", fused_adamw, "fused")):
        cfg = dataclasses.replace(base, loss_impl=loss_impl)
        runs = {}
        for where in ("cpu", dev):
            _fresh_state_singletons()
            acc = Accelerator(device=where)
            state = acc.create_train_state(_clone_to(params, where), make_opt(lr))
            step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
            losses = []
            for _ in range(3):
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
            flat = params_to_numpy(state.params)
            runs[where] = (losses, np.concatenate(
                [np.ravel(x) for x in [flat["embed"], flat["lm_head"], flat["ln_f"]]
                 + [v for layer in flat["layers"] for v in layer.values()]]))
        (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs[dev]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
        diff = np.abs(p_gpu - p_cpu)
        tight = float(np.mean(diff <= 2e-6 + 1e-5 * np.abs(p_cpu)))
        # Adam divides by the root of the second moment: an element whose gradient is at
        # the level of rounding noise may move by a fraction of lr on one side only.
        ok = loss_rel <= 1e-4 and float(diff.max()) <= lr / 2 and tight >= 0.999
        emit({"phase": "train_parity", "config": "debug", "optimizer": opt_name,
              "loss_impl": loss_impl, "losses_cpu": l_cpu, "losses_gpu": l_gpu,
              "loss_max_rel_err": loss_rel, "loss_tol_rel": 1e-4,
              "params_max_abs_err": float(diff.max()), "params_tol_abs": lr / 2,
              "params_share_within_2e-6+1e-5rel": tight, "ok": ok})
        if not ok:
            raise SystemExit(f"train step on the card disagrees with the CPU ({opt_name}, "
                             f"loss_impl={loss_impl})")
    _fresh_state_singletons()


# -------------------------------------------------------------- phase 9: train main path
TRAIN_LAYERS = 8  # all 32 layers' fp32 masters + moments + grads (~128 GB) pass 80 GB
TRAIN_B, TRAIN_S = 2, 2048


def phase_train_main(dev, loss_impl: str = "auto", first_loss=None) -> dict:
    """The training main path at Llama-3-8B's full width, depth cut to TRAIN_LAYERS:
    bf16 compute over fp32 masters, every block checkpointed, flash attention, chunked
    CE (``loss_impl="auto"``, phase train_main) or the fused CE kernels (``"fused"``,
    phase train_fused, whose first loss must be within 2e-3 of ``first_loss``),
    ``fused_adamw(1e-4)``, ``max_grad_norm=1.0``; one seeded batch, 2 warm-up steps and
    5 timed steps, with the kernels' launches counted over all 7."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.ops import fused_xent as fx
    from accelerate_tpu_torch.ops.paged_attention import paged_attention

    _fresh_state_singletons()
    L = TRAIN_LAYERS
    fused = loss_impl == "fused"
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=L, dtype=torch.bfloat16,
                              attn_impl="flash", remat=True, remat_policy="full",
                              loss_impl=loss_impl)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                               generator=torch.Generator(dev).manual_seed(0), device=dev)
    acc = Accelerator(mixed_precision="bf16", device=dev)
    state = acc.create_train_state(params, fo.fused_adamw(1e-4))
    del params
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}

    fa._fwd.launches = fa._bwd_dq.launches = fa._bwd_dkv.launches = 0
    fo.adamw_leaves.launches = 0
    fx._fwd.launches = fx._bwd.launches = 0
    paged_attention.launches = 0
    losses, step_s, norms = [], [], []
    for _ in range(7):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = {"flash_fwd": fa._fwd.launches, "flash_bwd_dq": fa._bwd_dq.launches,
                "flash_bwd_dkv": fa._bwd_dkv.launches, "fused_adamw": fo.adamw_leaves.launches,
                "fused_xent_fwd": fx._fwd.launches, "fused_xent_bwd": fx._bwd.launches,
                "paged_attention": paged_attention.launches}
    n_params = llama.num_params(cfg)
    n_leaves = 3 + 9 * L
    flops_per_token = 6 * n_params + 6 * L * TRAIN_S * cfg.d_model  # bench.py's formula
    tokens_per_step = TRAIN_B * TRAIN_S
    step_ms = 1e3 * float(np.mean(step_s[2:]))
    res = {
        "phase": "train_fused" if fused else "train_main", "config": "llama3-8b",
        "loss_impl": loss_impl, "layers": L,
        "cut": f"depth {L} of 32 layers (fp32 masters, moments and grads of all 32 need "
               "~128 GB); widths as published", "batch": [TRAIN_B, TRAIN_S],
        "params": n_params, "params_init_s": init_s, "losses": losses, "grad_norms": norms,
        "step_ms_runs": [1e3 * t for t in step_s], "step_ms": step_ms,
        "tokens_per_s": tokens_per_step / (step_ms / 1e3),
        "mfu": tokens_per_step * flops_per_token / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
        "flops_per_token": flops_per_token,
        "ideal_step_ms_at_peak": 1e3 * tokens_per_step * flops_per_token
        / PEAK_FLOPS[torch.bfloat16],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "leaves": n_leaves,
    }
    # The fused backward is one kernel for dx and dw: one launch per step for the pair.
    expect = {"flash_fwd": 2 * L * 7, "flash_bwd_dq": L * 7, "flash_bwd_dkv": L * 7,
              "fused_adamw": 7, "fused_xent_fwd": 7 * fused, "fused_xent_bwd": 7 * fused,
              "paged_attention": 0}
    res["launches_expected"] = expect
    res["finite"] = all(np.isfinite(losses)) and all(np.isfinite(norms))
    res["losses_decreasing"] = all(b < a for a, b in zip(losses, losses[1:]))
    res["ok"] = res["finite"] and res["losses_decreasing"] and launches == expect
    if first_loss is not None:
        res["first_loss_rel_err_vs_train_main"] = abs(losses[0] - first_loss) / abs(first_loss)
        res["first_loss_tol_rel"] = 2e-3
        res["ok"] = res["ok"] and res["first_loss_rel_err_vs_train_main"] <= 2e-3
    emit(res)
    if not res["ok"]:
        raise SystemExit(f"training main path ({loss_impl} CE) failed its checks")
    emit({**profile_train_step(step, state, batch), "loss_impl": loss_impl})
    _fresh_state_singletons()
    return res


def profile_train_step(step, state, batch) -> dict:
    """Where a training step's time goes: one step under ``torch.profiler`` (after the
    counted run). Device busy time is the sum of the kernels' own device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, n_launch = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[e.key] = kernels.get(e.key, 0) + e.self_device_time_total
        n_launch += e.count
    busy_ms = sum(kernels.values()) / 1e3

    def group(*names):
        return sum(v for k, v in kernels.items() if any(n in k for n in names)) / 1e3

    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    groups = {"matmul": group("nvjet", "gemm", "cutlass", "sm90_xmma"),
              "flash": group("flash_fwd", "flash_bwd"), "adamw": group("adamw_kernel"),
              "fused_xent": group("fxent_"), "copy_cast": group("copy")}
    groups["other"] = busy_ms - sum(groups.values())
    return {
        "phase": "train_profile", "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if kernels else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels else None,
        "device_ms_by_group": groups if kernels else None,
        "device_kernels": n_launch if kernels else None,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }


def _kernel_row(name, source, replaces, launches, max_abs_err, t, library=None,
                **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"), "library": library,
            **extra}


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
    libs = _build.build(list(_build.KERNEL_SOURCES))
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text(), file=sys.stderr)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "sources": list(libs)})

    # Serving (slice 1).
    kern = phase_kernel(dev)
    phase_engine(dev)
    paged_launches = phase_main(dev)
    torch.cuda.empty_cache()
    # Training (slice 2).
    flash = phase_flash(dev)
    torch.cuda.empty_cache()
    adamw = phase_adamw(dev, TRAIN_LAYERS)
    # Fused cross-entropy (slice 3).
    xent = phase_fused_xent(dev)
    phase_train_parity(dev)
    torch.cuda.empty_cache()
    train = phase_train_main(dev)
    torch.cuda.empty_cache()
    train_fused = phase_train_main(dev, "fused", first_loss=train["losses"][0])

    csrc, fa_py = "accelerate_tpu_torch/csrc/", "accelerate_tpu/ops/flash_attention.py"
    ft, fe = flash["times"], flash["errors"]["max_abs"]
    # One library call computes dq, dk and dv together: its time stands in both rows,
    # beside the sum of the two kernels (``kernels_dq_plus_dkv_ms`` of flash_time).
    bwd_library = "one aten flash-attention backward for dq+dk+dv (K/V expanded to H heads)"
    xt, xe = xent["times"], xent["errors"]["max_abs"]
    fx_py = "accelerate_tpu/ops/fused_xent.py"
    # One backward kernel computes dx and dw: rows 7 and 8 name it both, with its time
    # and its launches (one per step for the pair).
    xent_extra = {"chunked_ce_fwd_ms": xt["chunked_ce"]["fwd_ms"],
                  "chunked_ce_fwd_bwd_call_ms": xt["chunked_ce"]["fwd_bwd_call_ms"]}
    bwd_note = {"note": "one backward kernel (fxent_bwd_mma_kernel) computes dx and dw; "
                        "launches count that kernel, once per step for the pair"}
    emit({"kernels": [
        _kernel_row("paged_attention", csrc + "paged_attention.cu",
                    "accelerate_tpu/ops/paged_attention.py:106", paged_launches,
                    kern["max_abs_err"], kern),
        _kernel_row("flash_fwd", csrc + "flash_attention.cu", fa_py + ":155",
                    train["launches"]["flash_fwd"], max(fe["o"], fe["lse"]), ft["fwd"],
                    "scaled_dot_product_attention forward (flash, enable_gqa)"),
        _kernel_row("flash_bwd_dq", csrc + "flash_attention.cu", fa_py + ":343",
                    train["launches"]["flash_bwd_dq"], fe["dq"], ft["dq"], bwd_library),
        _kernel_row("flash_bwd_dkv", csrc + "flash_attention.cu", fa_py + ":422",
                    train["launches"]["flash_bwd_dkv"], max(fe["dk"], fe["dv"]), ft["dkv"],
                    bwd_library),
        _kernel_row("fused_adamw", csrc + "fused_adamw.cu",
                    "accelerate_tpu/ops/fused_optim.py:101", train["launches"]["fused_adamw"],
                    max(adamw["max_abs_err_fp32"], adamw["max_abs_err_bf16"]), adamw,
                    "torch._fused_adamw_"),
        _kernel_row("fused_xent_fwd", csrc + "fused_xent.cu", fx_py + ":82",
                    train_fused["launches"]["fused_xent_fwd"], max(xe["nll"], xe["lse"]),
                    xt["fwd"], None, **xent_extra),
        _kernel_row("fused_xent_bwd_dx", csrc + "fused_xent.cu", fx_py + ":128",
                    train_fused["launches"]["fused_xent_bwd"], xe["dx"], xt["bwd"], None,
                    **xent_extra, **bwd_note),
        _kernel_row("fused_xent_bwd_dw", csrc + "fused_xent.cu", fx_py + ":151",
                    train_fused["launches"]["fused_xent_bwd"], xe["dw"], xt["bwd"], None,
                    **xent_extra, **bwd_note),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

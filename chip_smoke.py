"""Chip smoke test of the PyTorch + CUDA port (``accelerate_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero, after one
line ``{"phase": "failed", "in": ..., "cases": ..., "error": ..., "traceback": ...}``
that names the phase, its failed cases and the exception:

1. device — the card's ``nvidia-smi`` name and power limit; build every CUDA kernel
   of the port from ``accelerate_tpu_torch/csrc`` (all ``nvcc`` processes started
   together) and print the build seconds.
2. kernel — the paged-attention kernel against its plain PyTorch version and against
   ``paged_chunked_reference`` (the bf16 kernel's split of each lane over its cluster,
   with the plain math) on the card, each element on its row's scale: the serving
   path's shape (B=8, T=1, H=32, K=8, hd=128, page_size=16, 64 pages per lane, bf16)
   plus T=4, fp32, int8 pools, window, softcap, other head dims and page sizes, G from
   1 to 8, sentinel table entries and a never-written lane, then the cluster schedule's
   edges (a lane with more tiles than its cluster has blocks, lanes of one live slot,
   lanes ending on a tile boundary, all-sentinel tail pages); every bf16 call made twice
   must repeat its bits; faults planted in the chunked reference (the last live tile
   skipped, the window's edge off by one, p left unrounded, the int8 V scale dropped)
   must fail the same check; then kernel, plain and bound times: device time from
   CUDA-graph replay between CUDA events, and call time (host work included) from CUDA
   events around calls; K/V pools rotate past the 50 MB L2.
3. engine — the paged engine on the card against the same engine on the CPU
   (``debug`` config, fp32, same seeded params and requests): identical greedy tokens,
   first decode step's logits within tolerance.
4. main — the paged continuous-batching engine serving 10 requests at Llama-3-8B's
   full width and depth (bf16, seeded random weights made on the card), with the
   kernel's launch count checked against the decode dispatches; then a few decode
   steps under ``torch.profiler`` for the device's busy time and idle share, where each
   launch of the paged kernel must show as exactly one device kernel (and, in phase 13,
   each int8 launch too).
5. flash — the flash-attention forward, dq and dk/dv kernels against their plain
   versions on the same inputs (the training path's shape B=2, H=32, K=8, S=2048,
   hd=128, bf16, causal; plus fp32, GQA 1, S=1000, packed segments with padding,
   window, softcap, offsets, hd 32 and 64; then the bf16 kernels' edges: the model's
   transposed [B,S,H,hd] views, S=1088, a group of 8 q heads per kv head, hd 64 at
   S=2048, non-causal with offsets at S=192, T=320), element by element on each row's scale; the same check must reject faults
   planted in the plain versions (a skipped kv tile, a cut-off q tile, p and ds left
   unrounded); then kernel, plain, bound and library times (SDPA forward; one aten
   flash-attention backward for dq, dk and dv), with each kernel's TFLOP/s.
6. adamw — the fused AdamW kernel against its plain version over the training path's
   leaf shapes, 3 steps, fp32 and bf16 first moments; then the time of one apply over
   the whole 8-layer tree beside ``torch._fused_adamw_``.
7. fused_xent — the fused linear + cross-entropy kernels (forward: the score tiles'
   statistics kernel and the combine; the backward's d, dw and dx kernels over vocab
   slabs) against their plain versions on the same inputs: the training path's shape
   T=4096, D=4096, V=128256, bf16; plus fp32 at T=300, D=256, V=1000 (ragged against
   every tile), softcap 30, ignored targets with a cotangent that is zero on some rows,
   the tied (transposed) head, the slabs' edges (V ragged against the slab and the tile,
   the tp shard VL=64128, T=4100, V=200), and the forward tile's edges (T=1, T=65 under
   softcap 30, D=1000 ragged against the 64-deep stage), each element on its row's
   scale; every bf16 forward and backward called twice must give the same bits; the
   same check must reject faults planted in the plain versions (the last vocab tile
   skipped, the softcap's chain rule dropped, d left unrounded); then kernel, plain and
   bound times (the forward's device kernels per call, counted as the kernel nodes of a
   CUDA graph captured from one call, and cuBLAS's ``x @ w`` beside it as the card's product rate at that shape; each
   backward kernel alone on one slab; the SM clock, power and temperature sampled by
   ``nvidia-smi`` beside the backward) beside the chunked CE the kernels replace (chunk
   512, forward and forward+backward).
8. train_parity — ``Accelerator.build_train_step`` on the card against the same step
   on the CPU (``debug`` config, fp32, 3 steps of ``adamw``, of ``fused_adamw`` and of
   ``fused_adamw`` with ``loss_impl="fused"``).
9. train_main — the training main path at Llama-3-8B's full width, depth cut to 8
   layers: bf16 over fp32 masters, remat, flash attention, chunked CE, ``fused_adamw``,
   global-norm clip; 7 steps on one seeded batch with every kernel's launches counted;
   then one step under ``torch.profiler``.
10. train_fused — the same run with ``loss_impl="fused"``: the fused CE kernels launch
   once each per step, and the first step's loss matches train_main's.
11. int8_matmul — the int8 weight-only matmul kernels against their plain version on
   the card: the serving path's four (K, N) at M = 8 and 64 in bf16, M = 1, 16, 65 and
   128, fp32 x, fp32 out, 3-D x, the ragged 130×200 @ 200×72 (bf16 and fp32) and an
   all-zero column, each element on its row's scale, each case on the route its shape
   picks (cluster, ragged or fp32) and every bf16 call made twice repeating its bits;
   the same check must reject faults planted in the plain version (the scale left out,
   the last K tile skipped, the codes read as unsigned, one middle K range of the plan
   skipped); then kernel, plain and bound times per shape (weight copies rotate past the
   50 MB L2) beside the dense bf16 cuBLAS product and ``torch._weight_int8pack_mm``, and
   the cluster kernel's time against its number of K ranges at three shapes.
12. quant_engine_vs_cpu — phase 3 with every projection quantized (int8 through the
   kernel, then nf4 through dequantize-then-multiply).
13. main_int8 — phase 4's workload at Llama-3-8B's full width and depth with every
   projection int8 (quantized on the card), each projection's launch counted; top-1
   agreement of the first decode step with a bf16 engine; then a profiled decode window
   and ``decode_ab``: bf16 and int8 engines' prefill and decode steps in alternation.
14. fused_xent_partial — kernel #6, the vocab-sharded partial forward of the fused CE,
   against its plain version: one tp rank's slice of Llama-3-8B's head (T = D = 4096,
   VL = 64128 and 32064, bf16), an fp32 case ragged against every tile and softcap 30,
   targets other ranks own and -1; faults planted in the plain version (the last vocab
   tile skipped, a target outside the slice matched, l not rescaled to the final max)
   must fail the same check; every bf16 call made twice must repeat its bits; the tp
   slices' partials, merged in torch, must equal kernel #5's (nll, lse) on the whole
   head; then kernel, plain and bound times and the device kernels per call.
15. train_tp_parity — the tensor-parallel train step (``Accelerator(mesh_config=dp1×tp2)``,
   ``partition_specs``, ``loss_impl="fused_tp"``) in two gloo ranks that share the card
   (``notebook_launcher``), against the same steps on the CPU in one process (``debug``,
   fp32, 3 steps of ``fused_adamw``): losses, each step's global grad norm and the
   gathered params; each rank also checks gloo's all-reduce of CUDA tensors (SUM and
   MAX, fp32 and bf16).
16. train_tp — the tensor-parallel training path at Llama-3-8B's full width, depth cut
   to 8 layers, in two gloo ranks sharing the card (dp1×tp2): ``train_main``'s seeded
   weights and batch, bf16 over fp32 masters, remat, flash attention, ``fused_tp``,
   ``fused_adamw``, global-norm clip; the first loss against ``train_main``'s, each
   rank's launches per step, peak memory of the set-up and of the steps, and step time
   (two ranks on one card with collectives staged through host memory: not a
   tensor-parallel speed).

Then the kernels line, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.

    python3 chip_smoke.py --xent-fwd-times

builds only the fused CE kernels and prints one line of forward times (#5 at the main
shape, #6 at the tp shards), the phases skipped: run from another tree's root (with a
copy of this script), it times that tree's kernels for a same-call comparison.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

# Hardware numbers of one H100 SXM (NVIDIA's data sheet): HBM rate and the dense
# tensor-core peak in bf16 (fp32 math outside the tensor cores: 67 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(SystemExit):
    """A phase's checks failed; ``cases`` names the failed cases."""

    def __init__(self, what: str, cases):
        super().__init__(f"{what}: {list(cases)}")
        self.cases = list(cases)


def run_phase(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``. Any failure first leaves a record on stdout: one JSON line
    naming the phase, its failed cases (where it names them), the exception's text and
    the end of its traceback; then it propagates."""
    try:
        return fn(*args, **kw)
    except BaseException as e:
        emit({"phase": "failed", "in": name, "cases": getattr(e, "cases", None),
              "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]})
        raise


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


#: NVML's clock-event (throttle) reason bits, as ``nvidia-smi`` reports them in hex.
CLOCK_REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks_setting", 0x4: "sw_power_cap",
                 0x8: "hw_slowdown", 0x10: "sync_boost", 0x20: "sw_thermal_slowdown",
                 0x40: "hw_thermal_slowdown", 0x80: "hw_power_brake_slowdown",
                 0x100: "display_clock_setting"}


def _smi_query(fields: str):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=10)
    return out.stdout.strip().splitlines()[0].split(", ") if out.returncode == 0 else None


def clock_probe(run, n: int) -> dict:
    """``run()`` ``n`` times back to back, each between CUDA events, while ``nvidia-smi``
    samples the card every 0.1 s: SM clock (MHz), power draw (W; the driver's average
    and, where it reports one, the instantaneous draw), temperature (°C) and the active
    clock-event reasons → {"call_ms": [...], "fields": [...], "samples": [[s, value per
    field], ...]}. Its own window: no reported time is taken beside it."""
    fields = ["clocks.sm", "power.draw", "temperature.gpu"]
    # Drivers since 535 name the reasons clocks_event_reasons, older ones throttle; the
    # instantaneous draw is newer still. A field the driver does not know is left out.
    for choices in (("power.draw.instant",),
                    ("clocks_event_reasons.active", "clocks_throttle_reasons.active")):
        fields += [f for f in choices if _smi_query(f) is not None][:1]
    samples, stop = [], threading.Event()
    t0 = time.perf_counter()

    def value(field, text):
        try:
            if field.startswith("clocks_"):
                bits = int(text, 16)
                return [name for b, name in CLOCK_REASONS.items() if bits & b]
            return float(text)
        except ValueError:  # "[N/A]"
            return None

    def sample():
        while not stop.is_set():
            vals = _smi_query(",".join(fields))
            if vals is not None:
                samples.append([round(time.perf_counter() - t0, 3),
                                *(value(f, v) for f, v in zip(fields, vals))])
            stop.wait(0.1)

    thread = threading.Thread(target=sample, daemon=True)
    torch.cuda.synchronize()
    thread.start()
    try:
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(n)]
        for start, end in events:
            start.record()
            run()
            end.record()
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    return {"call_ms": [a.elapsed_time(b) for a, b in events], "fields": fields,
            "samples": samples}


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


def device_kernels(fn) -> int:
    """The device kernels one call of ``fn`` runs: the kernel nodes of a CUDA graph
    captured from one call (after a warm-up call), counted through the driver API.
    (``torch.profiler``'s kernel records missed kernels of a window's first call in
    some runs on this card, so it is not used for counting.)"""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle, n = graph.raw_cuda_graph(), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    kind, kernels = ctypes.c_int(), 0
    if n.value and cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    for node in nodes:
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


# ------------------------------------------------------------------ phase 2: kernel
def make_paged_inputs(gen, *, B, T, H, K, hd, ps, MP, dtype, quantized, dev, lens=None,
                      alloc=None):
    """Seeded decode inputs. By default lane 0 is never written (position 0, no valid
    slot, all sentinel entries), lane 1 has an unallocated (sentinel) page inside its
    range and the other lanes random lengths in [T, MP*ps]. ``lens`` sets every lane's
    length (its live slots end at lens[b]); ``alloc`` caps each lane's allocated,
    written and valid slots (the pages past them keep sentinel entries: all-sentinel
    tail pages inside the live range)."""
    from accelerate_tpu_torch.models.common import paged_kv_planes, write_kv_paged

    C = MP * ps
    P = B * MP
    if lens is None:
        lens = torch.randint(T, C + 1, (B,), generator=gen).tolist()
        lens[0] = 0
        hole = True
    else:
        lens, hole = list(lens), False
    written = [min(n, a) for n, a in zip(lens, alloc or lens)]
    pool = paged_kv_planes(P, ps, K, hd, dtype, quantized, dev)
    tables = np.full((B, MP), P, np.int32)
    valid = np.zeros((B, C), bool)
    perm = torch.randperm(P, generator=gen).numpy()
    for b, n in enumerate(written):
        n_pages = -(-n // ps)
        tables[b, :n_pages] = perm[b * MP:b * MP + n_pages]
        valid[b, :n] = True
        if hole and b == 1 and n_pages > 2:  # a hole: sentinel entry, its slots not valid
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


#: Faults :func:`paged_chunked_reference` can plant, each of which the kernel check
#: must catch, with the case of :func:`paged_cases` each is planted in.
PAGED_FAULTS = {"last_chunk_skipped": "main", "window_edge_off_by_one": "window_softcap_T3_bf16",
                "p_unrounded": "main", "int8_v_scale_dropped": "int8_bf16"}


def sm_count(dev) -> int:
    """SMs of ``dev``'s card (an H100's 132 for the CPU, as the CPU tests plan for it)."""
    dev = torch.device(dev)
    return (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else 132)


def paged_split(q, pool, tables) -> tuple[int, int]:
    """(slots a tile, blocks a lane) of the kernel that ``ops.paged_attention.paged_plan``
    chooses for these inputs: the cluster kernel's 64-slot tiles over its blocks, or the
    partial + combine pair's chunks (their size from the built library), one per block.
    For fp32 q the split only orders fp32 sums, and the cluster's stands in for it."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    B, T, H, hd = q.shape
    ps, K = pool["k"].shape[1], pool["k"].shape[2]
    MP = tables.shape[1]
    bf16 = q.dtype == torch.bfloat16
    plan = pa.paged_plan(bf16, B, T, H, K, hd, ps, MP, sm_count(q.device),
                         q.data_ptr() % 16 == 0)
    if plan.route == "cluster" or not bf16:
        return pa.TILE_SLOTS, pa.cluster_blocks(B, K, MP, ps, sm_count(q.device))
    chunk = pa._lib().paged_attention_chunk(hd, 2 if "k_scale" in pool else 1)
    return chunk, -(-(MP * ps) // chunk)


def paged_chunked_reference(q, pool, tables, positions, valid, *, page_size, sm_scale,
                            window: int = 0, softcap: float = 0.0, fault=None, split=None):
    """The paged attention as the kernel splits it, with the plain math: each block of a
    lane walks its tiles (``ops.paged_attention.lane_tiles``) with an online softmax in
    fp32 — scores in fp32 (int8 pools dequantized to fp32 first), the tile's max, p
    rounded to V's type before P·V (bf16 pools; fp32 for fp32 and int8 pools, as the
    Pallas kernel's ``p.astype(v.dtype)``) — and the blocks' (m, l, acc) merge in rank
    order; a row that sees no key gives zeros. ``split`` (slots a tile, blocks a lane)
    defaults to :func:`paged_split`'s. ``fault`` (one of :data:`PAGED_FAULTS`) plants a
    fault: the lane's last live tile skipped, the window's edge slot kept, p left in
    fp32, the int8 V scale left out."""
    from accelerate_tpu_torch.ops.paged_attention import lane_tiles

    B, T, H, hd = q.shape
    P, ps, K = pool["k"].shape[0], pool["k"].shape[1], pool["k"].shape[2]
    MP, C = tables.shape[1], valid.shape[1]
    G, R = H // K, T * (H // K)
    dev = q.device
    quantized = "k_scale" in pool
    p_type = q.dtype if not quantized and fault != "p_unrounded" else torch.float32
    qf = q.float().reshape(B, T, K, G, hd).permute(0, 2, 1, 3, 4).reshape(B, K, R, hd)
    tile_slots, blocks = split or paged_split(q, pool, tables)
    neg = -1e30
    tables_h, valid_h = tables.cpu(), valid.cpu()
    out = torch.zeros((B, K, R, hd), dtype=torch.float32, device=dev)
    r_t = torch.arange(R, device=dev) // G

    def plane(name, pages, offs):
        x = pool[name][pages, offs].float()  # [TS, K, hd]
        if quantized and not (name == "v" and fault == "int8_v_scale_dropped"):
            x = x * pool[f"{name}_scale"][pages, offs].float()
        return x

    for b in range(B):
        pos0 = int(positions[b])
        shares = [list(r) for r in lane_tiles(pos0, T, MP, ps, window, blocks, tile_slots)]
        if fault == "last_chunk_skipped":
            last = max(i for i, sh in enumerate(shares) if sh)
            shares[last] = shares[last][:-1]
        qpos = pos0 + r_t  # [R]
        parts = []
        for share in shares:
            if not share:
                continue
            m = torch.full((K, R), neg, device=dev)
            l = torch.zeros((K, R), device=dev)
            acc = torch.zeros((K, R, hd), device=dev)
            for tile in share:
                slots = torch.arange(tile * tile_slots, (tile + 1) * tile_slots)
                lp = slots // ps
                pages = torch.where(lp < MP, tables_h[b, lp.clamp(max=MP - 1)],
                                    torch.tensor(P - 1)).clamp(max=P - 1)
                offs = slots % ps
                ok = torch.where(slots < C, valid_h[b, slots.clamp(max=C - 1)], False).to(dev)
                k = plane("k", pages.to(dev), offs.to(dev))
                v = plane("v", pages.to(dev), offs.to(dev))
                sc = torch.einsum("krd,jkd->krj", qf[b], k) * sm_scale
                if softcap:
                    sc = softcap * torch.tanh(sc / softcap)
                sl = slots.to(dev)[None, :]
                vis = ok[None, :] & (sl <= qpos[:, None])
                if window > 0:
                    edge = qpos[:, None] - window
                    vis = vis & ((sl >= edge) if fault == "window_edge_off_by_one" else (sl > edge))
                sc = torch.where(vis[None], sc, neg)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(vis[None], torch.exp(sc - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "krj,jkd->krd", p.to(p_type).float(), v)
                m = m_new
            parts.append((m, l, acc))
        if not parts:  # every tile dropped (a planted fault): the lane reads as zeros
            continue
        mm = torch.stack([pm for pm, _, _ in parts]).amax(0)
        lsum = torch.zeros_like(mm)
        osum = torch.zeros((K, R, hd), device=dev)
        for pm, pl_, pa in parts:  # rank order
            w = torch.exp(pm - mm)
            lsum = lsum + pl_ * w
            osum = osum + pa * w[..., None]
        out[b] = osum / torch.where(lsum == 0, 1.0, lsum)[..., None]
    return out.reshape(B, K, T, G, hd).permute(0, 2, 1, 3, 4).reshape(B, T, H, hd).to(q.dtype)


# Paged-attention limits in flash_errors' terms (each element on its row's scale; the
# whole tensor's rms error). "chunked": against paged_chunked_reference, which rounds
# where the kernel rounds, so only fp32 summation orders and the output's one rounding
# differ (a bf16 output may sit one bf16 step away); "plain": against the module's plain
# version, whose bf16 scores are rounded to bf16 before the softmax (and int8 pools
# dequantized in bf16). Each is set a few times above the largest error the kernels
# showed on the card (PERF.md); the planted faults move the chunked check's rms error by
# about 1e-3 (p unrounded) or far more.
PAGED_TOL = {
    "chunked": {torch.bfloat16: {"elem": 1e-2, "rms": 3e-4},
                torch.float32: {"elem": 1e-5, "rms": 2e-6}},
    "plain": {torch.bfloat16: {"elem": 1e-1, "rms": 2e-2},
              torch.float32: {"elem": 1e-5, "rms": 2e-6}},
}

PAGED_MAIN = dict(B=8, T=1, H=32, K=8, hd=128, ps=16, MP=64, dtype=torch.bfloat16,
                  quantized=False)


def paged_cases() -> list:
    """(name, shape, kwargs, lens, alloc) of the kernel check: the serving path's shape
    and its variants, then the cluster schedule's edges."""
    main = PAGED_MAIN
    f32 = torch.float32
    long_lane = [4000, 4096, 3000, 2049, 64, 1, 700, 128]
    return [
        ("main", main, {}, None, None),
        ("T4", {**main, "T": 4}, {}, None, None),
        ("fp32", {**main, "dtype": f32}, {}, None, None),
        ("int8_bf16", {**main, "quantized": True}, {}, None, None),
        ("int8_fp32", {**main, "dtype": f32, "quantized": True}, {}, None, None),
        ("window_softcap_T3", {**main, "T": 3, "dtype": f32}, {"window": 100, "softcap": 30.0},
         None, None),
        ("window_softcap_T3_bf16", {**main, "T": 3}, {"window": 100, "softcap": 30.0},
         None, None),
        ("int8_bf16_window_T2", {**main, "T": 2, "quantized": True}, {"window": 77}, None, None),
        ("hd64_ps8", {**main, "hd": 64, "ps": 8, "MP": 40, "H": 16, "K": 4}, {}, None, None),
        ("hd256_G2", {**main, "hd": 256, "H": 16, "K": 8, "MP": 16}, {"softcap": 50.0},
         None, None),
        ("hd32_G8_T4", {**main, "hd": 32, "H": 32, "K": 4, "T": 4}, {}, None, None),
        ("G1_ps32", {**main, "H": 8, "ps": 32, "MP": 32}, {}, None, None),
        # A lane with more tiles than its cluster has blocks (4096 slots: 64 tiles over
        # 8 blocks), ragged lanes beside it.
        ("lanes_past_cluster_MP256", {**main, "MP": 256}, {}, long_lane, None),
        # Lanes of one live slot.
        ("one_live_slot", main, {}, [1, 1, 2, 1, 1, 1, 1, 1], None),
        # Lanes that end exactly on a tile (and page) boundary.
        ("ends_on_tile_boundary", main, {}, [64, 128, 192, 256, 512, 640, 960, 1024], None),
        # Pages past the written ones left as sentinel entries inside the live range.
        ("sentinel_tail_pages", main, {}, [1024, 700, 300, 129, 64, 900, 500, 1000],
         [200, 100, 300, 64, 1, 450, 16, 999]),
        # bf16 shapes outside the cluster kernel's rules take the pair: page sizes of 24
        # and 4 (the JAX package's program lowering and engine tests use them) and more
        # than 64 query rows.
        ("bf16_ps24", {**main, "ps": 24, "MP": 43}, {}, None, None),
        ("int8_bf16_ps4_T2", {**main, "ps": 4, "MP": 256, "T": 2, "quantized": True},
         {"window": 300}, None, None),
        ("bf16_rows80", {**main, "T": 20}, {}, None, None),
    ]


def paged_check(got, want, dtype, which) -> tuple[dict, bool]:
    errs = flash_errors(got, want)
    return errs, all(errs[m] <= PAGED_TOL[which][dtype][m] for m in errs)


def phase_kernel(dev) -> dict:
    """The paged-attention kernel against its plain version and the chunked reference on
    the card; each case's launches take the route ``paged_plan`` gives its shape (bf16
    pair launches counted in ``launches_ragged``); faults planted in the chunked
    reference must fail the same check; two calls on the same bf16 inputs give the same
    bits; then kernel, plain and bound times."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference,
    )

    gen = torch.Generator().manual_seed(1)
    main = PAGED_MAIN
    failed, errors, faults = [], {}, {}
    fault_of = {c: [f for f, fc in PAGED_FAULTS.items() if fc == c]
                for c in set(PAGED_FAULTS.values())}
    for name, shape, kw, lens, alloc in paged_cases():
        q, pool, tables, positions, valid, lens = make_paged_inputs(
            gen, dev=dev, lens=lens, alloc=alloc, **shape)
        args = dict(page_size=shape["ps"], sm_scale=shape["hd"] ** -0.5, **kw)
        ragged = paged_attention.launches_ragged
        out = paged_attention(q, pool, tables, positions, valid, **args)
        again = paged_attention(q, pool, tables, positions, valid, **args)
        torch.cuda.synchronize()
        ragged = paged_attention.launches_ragged - ragged
        ref = paged_attention_reference(q, pool, tables, positions, valid, **args)
        chunked = paged_chunked_reference(q, pool, tables, positions, valid, **args)
        dtype = shape["dtype"]
        e_chunked, ok_c = paged_check(out, chunked, dtype, "chunked")
        e_plain, ok_p = paged_check(out, ref, dtype, "plain")
        same_bits = bool(torch.equal(out, again))
        finite = bool(torch.isfinite(out).all())
        bf16 = dtype == torch.bfloat16
        plan = pa.paged_plan(bf16, *(shape[k] for k in ("B", "T", "H", "K", "hd", "ps", "MP")),
                             sm_count(dev))
        route_ok = ragged == 2 * (bf16 and plan.route == "pair")
        ok = ok_c and ok_p and finite and (same_bits or not bf16) and route_ok
        res = {"phase": "kernel_check", "case": name, "dtype": str(dtype),
               "quantized": shape["quantized"], "lens": lens, "route": plan.route,
               "cluster_blocks": plan.blocks, "split": paged_split(q, pool, tables),
               "errors_vs_chunked": e_chunked, "errors_vs_plain": e_plain,
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "max_abs_err_vs_chunked": float((out.float() - chunked.float()).abs().max()),
               "same_bits_twice": same_bits, "tol": {k: PAGED_TOL[k][dtype] for k in PAGED_TOL},
               "ok": ok}
        emit(res)
        if not ok:
            failed.append(name)
        errors[name] = res["max_abs_err"]
        for fault in fault_of.get(name, []):
            bad = paged_chunked_reference(q, pool, tables, positions, valid, fault=fault, **args)
            e_bad, ok_bad = paged_check(bad, chunked, dtype, "chunked")
            faults[fault] = {"case": name, "errors": e_bad, "caught": not ok_bad}
        del q, pool, tables, positions, valid, out, again, ref, chunked
    for name, res in faults.items():
        emit({"phase": "kernel_planted_fault", "fault": name, **res})
        if not res["caught"]:
            failed.append(f"planted fault {name} passes the check")
    if sorted(faults) != sorted(PAGED_FAULTS):
        failed.append(f"planted faults run: {sorted(faults)}")
    if failed:
        raise PhaseFailed("paged_attention kernel disagrees with its references", failed)

    # Timing at the main shape. Four input sets (each pool 32 MB) rotate so a launch
    # finds its K/V outside the 50 MB L2, as a decode step's per-layer pools are; they
    # come from their own seed, whatever cases the check above holds.
    tgen = torch.Generator().manual_seed(2)
    sets = [make_paged_inputs(tgen, dev=dev, **main) for _ in range(4)]
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
           "design": PAGED_DESIGN,
           "kernel_ms": min(kernel_ms), "plain_ms": min(plain_ms),
           "kernel_ms_runs": kernel_ms, "plain_ms_runs": plain_ms,
           "kernel_call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
           "bound_ms": bound_ms, "bound_by": bounds[0][1],
           "kernel_over_bound": min(kernel_ms) / bound_ms,
           "live_slots_per_set": [sum(s[5]) for s in sets]}
    emit(res)
    return {"max_abs_err": errors["main"], "kernel_ms": res["kernel_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound_ms, "bound_by": res["bound_by"]}


PAGED_DESIGN = ("one launch; a thread block cluster (<= 8 blocks, one wave) per (lane, kv "
                "head) over 64-slot tiles, TMA page copies into a 2-stage mbarrier ring, "
                "mma.sync swap-AB (S^T = K Q^T, O^T = V^T P^T), merge through distributed "
                "shared memory")


# ------------------------------------------------------------------ phase 3: engine
def phase_engine(dev, scheme=None) -> None:
    """The paged engine on the card against the CPU (``debug``, fp32). ``scheme``
    (int8 | nf4) quantizes every projection first (embedding and head skipped): phase
    ``quant_engine_vs_cpu``, int8 through the kernel on the card."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to
    from accelerate_tpu_torch.ops import quantization as qz
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    if scheme is not None:
        kw = (dict(load_in_8bit=True) if scheme == "int8"
              else dict(load_in_4bit=True, bnb_4bit_quant_type=scheme))
        params_cpu = qz.load_and_quantize_model(params_cpu, qz.BnbQuantizationConfig(
            skip_modules=["embed", "lm_head"], min_weight_size=1, **kw))
    params_gpu = params_to(params_cpu, dev)
    launches = qz.int8_matmul.launches
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
    res = {"phase": "engine_vs_cpu" if scheme is None else "quant_engine_vs_cpu",
           "config": "debug", "tokens_equal": tokens_equal,
           "first_step_logits_max_abs_err": err, "tol": 1e-3}
    if scheme is not None:
        # int8 leaves must have gone through the kernel on the card (nf4: no kernel).
        res["scheme"] = scheme
        res["int8_matmul_launches"] = qz.int8_matmul.launches - launches
        ok = ok and (res["int8_matmul_launches"] > 0) == (scheme == "int8")
    res["ok"] = ok
    emit(res)
    if not ok:
        raise SystemExit(f"engine on the card disagrees with the engine on the CPU "
                         f"({scheme or 'dense'} weights)")


# ------------------------------------------------------------------ phase 4: main path
MAIN_ENGINE = dict(max_slots=8, max_len=1024, prompt_bucket=64, page_size=16)


def main_workload(vocab: int):
    """The main path's seeded requests: ``(rng, warm-up prompt, prompt lengths,
    [(prompt, submit kwargs)])`` — 10 prompts of 64–512 tokens, 64 new tokens each,
    requests 3 and 7 sampled; ``rng`` goes on to the profiled window."""
    from accelerate_tpu_torch.generation import GenerationConfig

    rng = np.random.default_rng(8)
    warm = rng.integers(0, vocab, 70)
    lengths = rng.integers(64, 513, 10)
    reqs = []
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, vocab, int(n))
        if i in (3, 7):  # two sampled requests
            gen = GenerationConfig(max_new_tokens=64, temperature=0.8, top_k=50, top_p=0.95)
            reqs.append((prompt, dict(gen=gen, seed=100 + i)))
        else:
            reqs.append((prompt, dict(max_new_tokens=64)))
    return rng, warm, lengths, reqs


def serve_main(params, cfg, dev, reset_counts) -> dict:
    """Warm up on a throwaway engine (cuBLAS handles, allocator pools), then serve the
    main workload on a fresh engine with the peak-memory statistics and the launch
    counts (``reset_counts()``) reset just before; the drain is timed to its final
    sync. Returns the engine, requests, stats and checks."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    rng, warm_prompt, lengths, workload = main_workload(cfg.vocab_size)
    warm = ContinuousBatcher(params, cfg, **MAIN_ENGINE)
    warm.submit(warm_prompt, max_new_tokens=4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()

    eng = ContinuousBatcher(params, cfg, **MAIN_ENGINE)
    reqs = [eng.submit(prompt, **kw) for prompt, kw in workload]
    reset_counts()
    t0 = time.perf_counter()
    finite, first_logits = True, None
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        if eng.last_logits is not None:
            finite &= bool(torch.isfinite(eng.last_logits).all())
            if first_logits is None:
                first_logits = eng.last_logits.clone()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats()
    n_tokens = sum(len(r.tokens) for r in reqs)
    return {
        "eng": eng, "rng": rng, "reqs": reqs, "stats": s, "lengths": lengths, "wall": wall,
        "first_logits": first_logits, "finite": finite, "n_tokens": n_tokens,
        "in_range": all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
        "all_done": all(r.done and len(r.tokens) == 64 for r in reqs),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start_bytes": allocated_at_start,
    }


def _serve_result(run: dict, phase: str, init_s: float) -> dict:
    """The JSON line of a served main workload (the keys ``phase_main`` reports)."""
    s = run["stats"]
    return {
        "phase": phase, "config": "llama3-8b", "dtype": "bfloat16",
        "engine": MAIN_ENGINE, "requests": len(run["reqs"]),
        "prompt_lengths": run["lengths"].tolist(),
        "max_new_tokens": 64, "sampled": 2, "params_init_s": init_s,
        "wall_s": run["wall"], "tokens": run["n_tokens"],
        "tokens_per_s": run["n_tokens"] / run["wall"],
        "decode_steps": s["decode_steps"], "decode_tokens": s["decode_tokens"],
        "mean_decode_step_ms": 1e3 * s["decode_s"] / max(s["decode_steps"], 1),
        "prefill_ms_total": 1e3 * s["prefill_s"],
        "prefill_ms_per_request": 1e3 * s["prefill_s"] / len(run["reqs"]),
        "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
        "memory_allocated_at_start_bytes": run["memory_allocated_at_start_bytes"],
        "finite_logits": run["finite"], "tokens_in_range": run["in_range"],
        "all_done": run["all_done"], "pages_in_use_after": s["pages_in_use"],
    }


def phase_main(dev) -> int:
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def reset_counts():
        paged_attention.launches = 0
        paged_attention.launches_ragged = 0

    run = serve_main(params, cfg, dev, reset_counts)
    launches, ragged = paged_attention.launches, paged_attention.launches_ragged
    s = run["stats"]
    launches_ok = (s["decode_steps"] > 0 and launches == cfg.n_layers * s["decode_steps"]
                   and ragged == 0)
    res = {**_serve_result(run, "main", init_s), "paged_attention_launches": launches,
           "paged_attention_launches_ragged": ragged, "launches_ok": launches_ok}
    res["ok"] = (run["finite"] and run["in_range"] and run["all_done"] and launches_ok
                 and s["pages_in_use"] == 0)
    emit(res)
    if not res["ok"]:
        raise SystemExit("main path failed its checks")
    prof = profile_decode(run["eng"], run["rng"], cfg.vocab_size)
    emit(prof)
    one_kernel_per_call(prof, int8=False)
    return {"launches": launches, "profile": prof}


def one_kernel_per_call(prof: dict, int8: bool) -> None:
    """The profiled decode window ran one device kernel per launch of each port kernel
    (paged attention; with ``int8``, the int8 matmul too), and launched it."""
    names = ["paged_attention"] + (["int8_mm"] if int8 else [])
    launch_key = {"paged_attention": "paged_attention_launches_per_step",
                  "int8_mm": "int8_matmul_launches_per_step"}
    bad = [n for n in names if prof[f"{n}_kernels_per_step"] is None
           or prof[launch_key[n]] <= 0
           or prof[f"{n}_kernels_per_step"] != prof[launch_key[n]]]
    if bad:
        raise PhaseFailed("device kernels per step differ from the wrapper's launches", bad)


def profile_decode(eng, rng, vocab: int, steps: int = 5) -> dict:
    """Where a decode step's time goes: ``steps`` decode steps with all lanes busy,
    under ``torch.profiler`` (after the counted run, so its cost touches no other
    number). Device busy time is the sum of the kernels' own device time."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.ops.quantization import int8_matmul

    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, vocab, 200), max_new_tokens=steps + 4)
    eng.step()  # admissions + the first decode step
    eng.step()
    torch.cuda.synchronize()
    before = (paged_attention.launches, int8_matmul.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = (paged_attention.launches - before[0], int8_matmul.launches - before[1])
    eng.run()
    # Device time as the union of the kernels' intervals: a kernel launched as a
    # programmatic dependent (the int8 matmul) starts before the one ahead of it ends,
    # so the sum of kernel durations counts that overlap twice.
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]

    def union_ms(stem=""):
        ivs = sorted((a, b) for n, a, b in spans if stem in n)
        total, end = 0.0, -math.inf
        for a, b in ivs:
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3 / steps

    kernels, counts, n_launch = {}, {}, 0
    for e in prof.key_averages():
        # Device-side events only: a CPU op's entry repeats its kernels' device time.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[e.key] = kernels.get(e.key, 0) + e.self_device_time_total
        counts[e.key] = counts.get(e.key, 0) + e.count
        n_launch += e.count
    busy_ms = sum(kernels.values()) / 1e3 / steps
    def group_ms(*names):
        return sum(v for k, v in kernels.items() if any(n in k for n in names)) / 1e3 / steps

    def group_count(name):
        return sum(c for k, c in counts.items() if name in k) / steps

    attn_ms = group_ms("paged_attention")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {
        "phase": "decode_profile", "steps": steps, "lanes": eng.max_slots,
        "wall_ms_per_step_profiled": wall_ms,
        "device_busy_ms_per_step": busy_ms if kernels else None,
        "device_busy_union_ms_per_step": union_ms() if kernels else None,
        "device_idle_share": (1 - union_ms() / wall_ms) if kernels else None,
        "paged_attention_ms_per_step": attn_ms if kernels else None,
        "int8_matmul_ms_per_step": group_ms("int8_mm") if kernels else None,
        "int8_matmul_union_ms_per_step": union_ms("int8_mm") if kernels else None,
        "cublas_matmul_ms_per_step": (group_ms("nvjet", "gemm", "cutlass", "sm90_xmma")
                                      if kernels else None),
        "device_kernels_per_step": n_launch / steps if kernels else None,
        # Device kernels of each port kernel per step, and the wrapper's launches per step
        # in the same window: one device kernel per launch is one launch per call.
        "paged_attention_kernels_per_step": group_count("paged_attention") if kernels else None,
        "int8_mm_kernels_per_step": group_count("int8_mm") if kernels else None,
        "paged_attention_launches_per_step": launches[0] / steps,
        "int8_matmul_launches_per_step": launches[1] / steps,
        "top_kernels_ms_per_step": {k[:80]: v / 1e3 / steps for k, v in top},
    }


# ------------------------------------------------------------ phase 5: flash kernels
FLASH_MAIN = dict(B=2, H=32, K=8, S=2048, T=2048, hd=128, dtype=torch.bfloat16)
FLASH_DESIGN = "wgmma+tma, warp-specialised"


def make_flash_inputs(gen, *, B, H, K, S, T, hd, dtype, dev, segments=False,
                      transposed=False):
    """Seeded q [B,H,S,hd], k/v [B,K,T,hd], do, and (optionally) packed segment ids
    with zero padding at each row's end (so some query rows see no key). ``transposed``
    makes each tensor a ``.transpose(1, 2)`` view of ``[B,S,H,hd]`` memory, as the
    model passes them."""
    def randn(b, h, s, d):
        if transposed:
            return torch.randn((b, s, h, d), generator=gen).to(dev, dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen).to(dev, dtype)

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


def flash_flops(S, T, B, H, hd, causal, window, which) -> int:
    """Matrix-product flops of one flash call over the (query, key) pairs its mask
    leaves visible (no offsets, no segments), two flops per multiply-add: forward 2
    products (q·k, p·v), dq 3 (q·k, do·v, ds·k), dk/dv 4 (q·k, do·v, pᵀ·do, dsᵀ·q)."""
    rows = np.arange(S)[:, None]
    cols = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis &= cols <= rows
    if window:
        vis &= cols > rows - window
    products = {"fwd": 2, "dq": 3, "dkv": 4}[which]
    return 2 * products * B * H * int(vis.sum()) * hd


def flash_bound_ms(S, T, B, H, K, hd, causal, window, itemsize, which) -> tuple[float, str]:
    """Least time of one flash call on this card: its matrix-product flops
    (``flash_flops``) over the bf16 (or fp32) peak, or its bytes over the HBM rate,
    whichever is larger. Bytes: every input read once, every output written once (fp32
    gradients, fp32 lse/delta)."""
    flops = flash_flops(S, T, B, H, hd, causal, window, which)
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
        # The edges of the bf16 wgmma kernels (128-row q and kv tiles, TMA maps over
        # strided views): the model's transposed layout at the main shape, S ragged
        # against 128, a group of 8 q heads per kv head, hd 64 (the 128-byte swizzle
        # with one column block) at S = 2048, and the non-causal masks with offsets and
        # S != T, both ragged against 128.
        ("model_layout_main", main, {"transposed": True}),
        ("S1088_ragged128", {**main, "S": 1088, "T": 1088, "H": 8, "K": 2}, {}),
        ("H32_K4_G8", {**small, "K": 4}, {}),
        ("hd64_S2048", {**main, "hd": 64, "H": 8, "K": 2}, {}),
        ("noncausal_bf16_offsets", {**small, "S": 192, "T": 320, "H": 4, "K": 2},
         {"causal": False, "q_offset": 64, "kv_offset": 32}),
    ]
    errors, failed, faults = {}, [], None
    for name, shape, kw in cases:
        kw = dict(kw)
        q, k, v, do, segs = make_flash_inputs(gen, dev=dev, segments=kw.pop("segments", False),
                                              transposed=kw.pop("transposed", False), **shape)
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
        raise PhaseFailed("flash kernels disagree with their plain versions", failed)

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
        flops = flash_flops(main["S"], main["T"], main["B"], main["H"], main["hd"], True, 0,
                            which)
        times[which] = {"kernel_ms": min(kernel_runs), "plain_ms": min(plain_runs),
                        "kernel_ms_runs": kernel_runs, "plain_ms_runs": plain_runs,
                        "bound_ms": bound, "bound_by": bound_by,
                        "kernel_tflops": flops / min(kernel_runs) / 1e9,
                        "bound_over_kernel": bound / min(kernel_runs)}
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
XENT_BWD_DESIGN = ("vocab slabs; per slab d, dw and dx kernels, each output tile owned by "
                   "one block (no atomics); wgmma+tma, warp-specialised")
XENT_FWD_DESIGN = ("fxent_ws_kernel's statistics epilogue (128 x 256 tiles, a persistent "
                   "block an SM; a TMA producer warp, a 4-stage mbarrier ring, two wgmma "
                   "m64n256k16 consumer warpgroups; (m, l, tgt) per row and 256 columns), "
                   "then a fixed-order combine")

# Fused-CE tolerances, in flash_errors' terms: nll and lse against 1 + |want|; dx and dw
# element by element on their row's scale, and the whole tensor's rms error. Kernel and
# plain version take the same roundings and differ only in the order of their fp32 sums
# (on the fp32 path also the atomics' order, which changes from run to run; the bf16
# backward's order is fixed). bf16 dx/dw flip by one bf16 step where d or the result
# sits next to a rounding boundary. Each limit is a few
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
        tile = fx.FWD_TILE[x.dtype]
        cut = (w.shape[1] - 1) // tile * tile
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
    backward gets the plain forward's lse; the bf16 backward runs twice and must repeat
    its bits), then times at the main shape."""
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
        # The edges of the bf16 backward's vocab slabs (16384 columns at T = 4096, 16128
        # at T = 4100): V ragged against the slab and the 256-column tile (three slabs,
        # the last 7309 wide), the tp shard of Llama-3-8B's head (VL = 64128: four slabs),
        # T not a multiple of 128 with several slabs, and a head narrower than one tile.
        ("slabs_V40077_ragged", dict(T=4096, D=1024, V=40077, dtype=torch.bfloat16), {}),
        ("tp_shard_V64128", dict(T=4096, D=4096, V=64128, dtype=torch.bfloat16), {}),
        ("T4100_ragged_slabs", dict(T=4100, D=1024, V=33000, dtype=torch.bfloat16),
         {"ignored": 0.125, "zero_g": 0.125}),
        ("V200_one_tile", dict(T=300, D=256, V=200, dtype=torch.bfloat16), {}),
        # The forward tile's edges: one row, 65 rows (a 128-row tile mostly past T) under
        # the cap, and D ragged against the 64-deep stage; V ragged against the tile.
        ("T1", dict(T=1, D=1024, V=32008, dtype=torch.bfloat16), {}),
        ("T65_softcap30", dict(T=65, D=1024, V=32008, dtype=torch.bfloat16),
         {"softcap": 30.0, "score_std": 30.0}),
        ("D1000_ragged_stage", dict(T=300, D=1000, V=5000, dtype=torch.bfloat16),
         {"ignored": 0.125}),
    ]
    errors, failed, faults = {}, [], {}
    for name, shape, kw in cases:
        kw = dict(kw)
        cap = kw.pop("softcap", 0.0)
        x, w, t, g = make_xent_inputs(gen, dev=dev, **shape, **kw)
        _, lse_ref = fx.fused_xent_reference(x, w, t, cap)
        got = xent_outputs(fx, x, w, t, g, lse_ref, cap, plain=False)
        # The bf16 forward and backward sum in a fixed order: a second call gives the same
        # bits. (The fp32 backward adds with atomics, whose order changes from run to run.)
        deterministic = None
        if shape["dtype"] == torch.bfloat16:
            again = xent_outputs(fx, x, w, t, g, lse_ref, cap, plain=False)
            deterministic = {n: bool(torch.equal(again[n], got[n])) for n in got}
            del again
        torch.cuda.synchronize()
        ref = xent_outputs(fx, x, w, t, g, lse_ref, cap, plain=True)
        errs, within = xent_check(got, ref, shape["dtype"])
        max_abs = {n: float((got[n].float() - ref[n].float()).abs().max()) for n in ref}
        finite = all(bool(torch.isfinite(got[n]).all()) for n in got)
        shapes_ok = all(got[n].shape == ref[n].shape and got[n].dtype == ref[n].dtype
                        for n in ref)
        ok = (finite and shapes_ok and all(within.values())
              and all((deterministic or {}).values()))
        emit({"phase": "fused_xent_check", "case": name, "softcap": cap, "errors": errs,
              "max_abs": max_abs, "deterministic": deterministic,
              "tol": XENT_TOL[shape["dtype"]], "ok": ok})
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
        raise PhaseFailed("fused CE kernels disagree with their plain versions", failed)

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
                        "bound_ms": bound, "bound_by": bound_by,
                        "tflops": {"fwd": 2, "bwd": 6}[which] * T * D * V
                        / min(kernel_runs) / 1e9}
    # The forward is the statistics kernel and the combine: two device kernels a call
    # (int32 targets, so the wrapper casts nothing). cuBLAS's x @ w (the logits written
    # in bf16) is the card's product rate at this shape: a yardstick, not the same
    # function.
    t32 = t.to(torch.int32)
    times["fwd"]["device_kernels_per_call"] = device_kernels(lambda: fx._fwd(x, w, t32))
    cublas_ms = device_ms(lambda _: x @ w, 2, 5)
    times["fwd"]["cublas_x_at_w_ms"] = cublas_ms
    times["fwd"]["cublas_x_at_w_tflops"] = 2 * T * D * V / cublas_ms / 1e9
    torch.cuda.empty_cache()
    if times["fwd"]["device_kernels_per_call"] != 2:
        raise PhaseFailed("the forward is not two device kernels a call",
                          [times["fwd"]["device_kernels_per_call"]])
    # The backward's three kernels on the first slab, each alone (2·T·D·vn flops each).
    slab = fx._slab_width(T, V)
    vn = min(slab, V)
    lib, ti, gf = fx._lib(), t.to(torch.int32), g.float()
    d = torch.empty((T, slab), dtype=x.dtype, device=dev)
    dx, dx32 = torch.empty_like(x), torch.empty((T, D), dtype=torch.float32, device=dev)
    dw = torch.empty_like(w)

    def step(i):
        return fx._cuda_slab_steps(lib, torch.cuda.current_stream().cuda_stream)[i]

    slab_ms = {
        "d": device_ms(lambda _: step(0)(x, w, ti, lse, gf, 0.0, 0, vn, d), 2, 5),
        "dw": device_ms(lambda _: step(1)(x, d, 0, vn, dw), 2, 5),
        "dx": device_ms(lambda _: step(2)(d, w, 0, vn, dx32, dx, False, False), 2, 5),
    }
    times["bwd"].update({
        "slab": slab, "slab_kernel_ms": slab_ms,
        "slab_kernel_tflops": {k: 2 * T * D * vn / ms / 1e9 for k, ms in slab_ms.items()}})
    del d, dx, dx32, dw
    # The clock under sustained load, in a window of its own after the timings: 80
    # backward calls back to back (≈ 1.7 s), each timed, beside nvidia-smi's samples.
    times["bwd"]["clock_probe"] = clock_probe(lambda: fx._bwd(x, w, t, lse, g), 80)
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
    fx._fwd.launches = fx._bwd.launches = fx._bwd.slab_launches = 0
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
                "fused_xent_bwd_slab_kernels": fx._bwd.slab_launches,
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
    # The fused backward is one call for dx and dw: one per step for the pair, and in it
    # a d, a dw and a dx kernel per vocab slab.
    n_slabs = -(-cfg.vocab_size // fx._slab_width(TRAIN_B * TRAIN_S, cfg.vocab_size))
    expect = {"flash_fwd": 2 * L * 7, "flash_bwd_dq": L * 7, "flash_bwd_dkv": L * 7,
              "fused_adamw": 7, "fused_xent_fwd": 7 * fused, "fused_xent_bwd": 7 * fused,
              "fused_xent_bwd_slab_kernels": 7 * fused * 3 * n_slabs,
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
    kernels, n_launch, collective_cpu_us = {}, 0, 0.0
    for e in prof.key_averages():
        if e.key.startswith(("gloo:", "nccl:")):  # a collective's annotation, no kernel
            if e.device_type == torch.autograd.DeviceType.CPU:
                collective_cpu_us += e.cpu_time_total
            continue
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
              "fused_xent": group("fxent_"), "copy_cast": group("copy"),
              "memcpy": group("Memcpy")}
    groups["other"] = busy_ms - sum(groups.values())
    return {
        "phase": "train_profile", "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if kernels else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels else None,
        "device_ms_by_group": groups if kernels else None,
        "device_kernels": n_launch if kernels else None,
        "collective_cpu_ms": collective_cpu_us / 1e3,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }


# ------------------------------------------------------------- phase 11: int8 matmul
# The serving path's int8 projections at Llama-3-8B's widths: leaf → (K, N).
INT8_LAYER = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
              "wo": (4096, 4096), "w_gate": (4096, 14336), "w_up": (4096, 14336),
              "w_down": (14336, 4096)}
INT8_M = {"decode": 8, "prefill": 64}  # max_slots=8 lanes at T=1; one 64-token chunk
INT8_DESIGN = ("one launch; swap-AB wgmma (weight columns on the 64-row side, tokens on n) "
               "with int8 dequantized to bf16 A fragments in registers, TMA ring of the "
               "[K, N] weight and x, K split over a thread block cluster (<= 7; <= 16 at "
               "N = 1024, one block an SM), partials "
               "pushed to their owners through distributed shared memory and summed in "
               "rank order, programmatic dependent launch")

# int8 matmul tolerances by output type, in flash_errors' terms (each element on its
# row's scale; the whole tensor's rms error). Kernel and plain version take the same
# exact products (bf16 × int8 and fp32 × int8 are exact in fp32) and differ only in the
# order of their fp32 sums, so a bf16 result may sit one bf16 step (≤ 2^-7 of |y|) away
# where the sum lies next to a rounding boundary. Each limit is a few times above the
# largest error the kernel showed on the card (PERF.md); a skipped K tile moves every
# element by about sqrt(64/K) of its row's rms and fails both.
INT8_TOL = {torch.bfloat16: {"elem": 1e-2, "rms": 1e-3},
            torch.float32: {"elem": 1e-5, "rms": 2e-6}}


def make_int8_inputs(gen, *, K, N, x_dtype, dev, M=8, lead=None, zero_col=None):
    """Seeded x (unit normal, ``[M, K]`` or ``lead``) and an int8 weight quantized on
    the card from a normal ``[K, N]`` weight of std 1/sqrt(K) (``zero_col``: one
    all-zero column, whose scale is 1e-8/127)."""
    from accelerate_tpu_torch.ops.quantization import quantize_weight

    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    x = torch.randn(lead or (M, K), generator=gen, device=dev).to(x_dtype)
    return x, quantize_weight(w)


def int8_check(got: torch.Tensor, want: torch.Tensor, out_dtype) -> tuple[dict, bool]:
    errs = flash_errors(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]),
                        rowwise=True)
    return errs, all(errs[m] <= INT8_TOL[out_dtype][m] for m in errs)


def int8_planted_faults(x, qw, out_dtype, want) -> dict:
    """Faulty plain versions, each held to the same check: the column scale left out;
    the last K tile (64 rows) skipped; the codes read as unsigned bytes; one middle K
    range of the launch plan (the rows one block of the cluster sums) skipped."""
    from accelerate_tpu_torch.ops.quantization import split_plan

    d, s = qw.data, qw.scales
    K, N = d.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = split_plan(math.prod(x.shape[:-1]), N, K, sms)
    z = plan.splits // 2
    keep = torch.ones(K, dtype=torch.bool, device=x.device)
    keep[z * plan.k_chunk:(z + 1) * plan.k_chunk] = False
    bad = {
        "scale_left_out": (x.float() @ d.float()).to(out_dtype),
        "last_k_tile_skipped": ((x[..., :K - 64].float() @ d[:K - 64].float()) * s)
        .to(out_dtype),
        "codes_unsigned": ((x.float() @ d.view(torch.uint8).float()) * s).to(out_dtype),
        "middle_k_range_skipped": (((x.float() * keep) @ d.float()) * s).to(out_dtype),
    }
    result = {}
    for name, out in bad.items():
        errs, ok = int8_check(out, want, out_dtype)
        result[name] = {"errors": errs, "caught": not ok}
    return result


def int8_bound_ms(M, K, N, out_itemsize=2) -> tuple[float, str]:
    """Least time of one call on this card: x (bf16), the int8 weight, its fp32 scales
    and y read or written once over the HBM rate, or 2·M·K·N flops over the bf16 peak,
    whichever is larger."""
    nbytes = M * K * 2 + K * N + 4 * N + M * N * out_itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * M * K * N / PEAK_FLOPS[torch.bfloat16]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def in_context_ms(call, n: int, replays: int) -> float:
    """Device time of ``call(i)`` when a PyTorch kernel runs between calls, as in a decode
    step (where a kernel launched as a programmatic dependent cannot start before the one
    ahead of it ends): the graph of call + a one-element add, less the adds alone."""
    z = torch.zeros(1, device="cuda")
    adds = device_ms(lambda i: z.add_(1), n, replays)
    return device_ms(lambda i: (call(i), z.add_(1)), n, replays) - adds


def int8_times(gen, dev, M, K, N) -> dict:
    """Device times at one shape (bf16 x and out) from CUDA-graph replay, in turns plain,
    kernel, kernel, plain, then the kernel's time in context (``in_context_ms``). Weight
    copies rotate past the 50 MB L2 (a 4096 × 4096 int8 weight is 16.8 MB and would
    otherwise be served from L2). Beside them: the dense bf16 product the quantization
    replaces (cuBLAS ``x @ w_bf16``) and ``torch._weight_int8pack_mm`` (weight [N, K], bf16
    scales), where this build runs it."""
    from accelerate_tpu_torch.ops import quantization as qz

    copies = max(2, math.ceil(100e6 / (K * N)))
    ws = [make_int8_inputs(gen, M=M, K=K, N=N, x_dtype=torch.bfloat16, dev=dev)[1]
          for _ in range(copies)]
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)

    def kernel(i):
        qz.int8_matmul(x, ws[i].data, ws[i].scales, torch.bfloat16)

    def plain(i):
        qz.int8_matmul_reference(x, ws[i].data, ws[i].scales, torch.bfloat16)

    plain_runs = [device_ms(plain, copies, 3)]
    kernel_runs = [device_ms(kernel, copies, 20), device_ms(kernel, copies, 20)]
    plain_runs.append(device_ms(plain, copies, 3))
    bound, bound_by = int8_bound_ms(M, K, N)
    res = {"M": M, "K": K, "N": N, "weight_copies": copies,
           "kernel_ms": min(kernel_runs), "plain_ms": min(plain_runs),
           "kernel_ms_runs": kernel_runs, "plain_ms_runs": plain_runs,
           "kernel_in_context_ms": in_context_ms(kernel, copies, 20),
           "bound_ms": bound, "bound_by": bound_by,
           "kernel_gb_per_s": (M * K * 2 + K * N + 4 * N + 2 * M * N) / min(kernel_runs) / 1e6}
    dense_copies = max(2, math.ceil(100e6 / (2 * K * N)))
    dense = [qz.dequantize_weight(w, torch.bfloat16) for w in ws[:dense_copies]]
    while len(dense) < dense_copies:
        dense.append(dense[-1].clone())
    res["dense_bf16_ms"] = device_ms(lambda i: x @ dense[i], dense_copies, 20)
    # Call times (CUDA events around eager calls): what a host-bound caller pays per call.
    res["kernel_call_ms"] = call_ms(lambda i: kernel(i % copies), 200)
    res["dense_bf16_call_ms"] = call_ms(lambda i: x @ dense[i % dense_copies], 200)
    del dense
    packed = [(w.data.T.contiguous(), w.scales.to(torch.bfloat16)) for w in ws]
    try:
        torch._weight_int8pack_mm(x, *packed[0])
        torch.cuda.synchronize()
        res["int8pack_ms"] = device_ms(lambda i: torch._weight_int8pack_mm(x, *packed[i]),
                                       copies, 20)
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as err:
        res["int8pack_ms"] = None
        res["int8pack_error"] = str(err).splitlines()[0][:200]
    del ws, packed
    torch.cuda.empty_cache()
    return res


def int8_split_sweep(gen, dev) -> list:
    """The cluster kernel's device time in context (``in_context_ms``) at five serving
    shapes against its tokens a block (the plan's and down to a quarter of it) and the
    number of K ranges (blocks of a cluster, 1..16), launched through the C entry point
    with the plan forced, beside the plan's own choice: the measurement behind
    ``split_plan``'s rule (``quantization._MOST_SPLITS`` and ``MAX_CLUSTER``). Weight
    copies rotate past the L2 as in ``int8_times``. Run only when asked:
    ``python3 chip_smoke.py --int8-split-sweep``."""
    from accelerate_tpu_torch.ops import quantization as qz

    fn = qz._launcher()
    out = []
    for M, K, N in ((8, 4096, 4096), (8, 14336, 4096), (64, 4096, 4096), (8, 4096, 1024),
                    (64, 4096, 1024)):
        copies = max(2, math.ceil(100e6 / (K * N)))
        ws = [make_int8_inputs(gen, M=M, K=K, N=N, x_dtype=torch.bfloat16, dev=dev)[1]
              for _ in range(copies)]
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        ys = [torch.empty((M, N), dtype=torch.bfloat16, device=dev) for _ in range(copies)]
        plan = qz.split_plan(M, N, K, sm_count(dev))
        k_tiles = -(-K // 64)

        def launch(i, bm, splits):
            per = -(-k_tiles // splits)
            err = fn(x.data_ptr(), ws[i].data.data_ptr(), ws[i].scales.data_ptr(),
                     ys[i].data_ptr(), None, M, N, K, 1, 1, bm, -(-k_tiles // per),
                     per * 64, 1, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"int8 cluster kernel launch failed: CUDA error {err}")

        ms = {f"bm{bm}_s{s}": in_context_ms(lambda i: launch(i, bm, s), copies, 20)
              for bm in (8, 16, 32, 64) if plan.bm // 4 <= bm <= plan.bm
              for s in range(1, qz.MAX_CLUSTER + 1)}
        out.append({"M": M, "K": K, "N": N, "plan": f"bm{plan.bm}_s{plan.splits}",
                    "ms": ms, "best": min(ms, key=ms.get),
                    "bound_ms": int8_bound_ms(M, K, N)[0]})
        del ws, ys
    return out


def int8_fresh_weight_check(gen, dev) -> dict:
    """Weights written by the kernel just before the call: the cluster kernel launches as
    a programmatic dependent of the kernel ahead of it and must not read the weight or
    its scales before that kernel's writes. 12 rounds at M = 8, 4096 × 1024 (a cluster of
    16 blocks), each writing one of two weights into the same buffers (the codes or the
    scales last) or quantizing a new one, then calling the kernel at once; each result is
    held against the plain version on the weight it should have read."""
    from accelerate_tpu_torch.ops import quantization as qz

    K, N = 4096, 1024
    x, a = make_int8_inputs(gen, M=8, K=K, N=N, x_dtype=torch.bfloat16, dev=dev)
    b = make_int8_inputs(gen, M=8, K=K, N=N, x_dtype=torch.bfloat16, dev=dev)[1]
    data, scales = a.data.clone(), a.scales.clone()
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    outs, copies = [], 0
    for r in range(12):
        if r % 3 == 2:  # quantized by the kernels just before the call
            src = qz.quantize_weight(w * (1 + r))
            got = qz.int8_matmul(x, src.data, src.scales, torch.bfloat16)
        else:  # the buffers hold the other weight until these copies
            src = (b, a)[copies % 2]
            copies += 1
            if r % 3 == 0:
                scales.copy_(src.scales)
                data.copy_(src.data)
            else:
                data.copy_(src.data)
                scales.copy_(src.scales)
            got = qz.int8_matmul(x, data, scales, torch.bfloat16)
        outs.append((got, src))
    torch.cuda.synchronize()
    worst, ok = {"elem": 0.0, "rms": 0.0}, True
    for got, src in outs:
        errs, good = int8_check(got, qz.int8_matmul_reference(x, src.data, src.scales,
                                                              torch.bfloat16), torch.bfloat16)
        worst = {k: max(worst[k], errs[k]) for k in worst}
        ok = ok and good
    return {"rounds": len(outs), "errors": worst, "ok": ok,
            "splits": qz.split_plan(8, N, K, sm_count(dev)).splits}


def phase_int8_matmul(dev) -> dict:
    """The int8 matmul kernel against its plain version on the card, then times at the
    serving path's shapes."""
    from accelerate_tpu_torch.ops import quantization as qz

    gen = torch.Generator(dev).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    shapes = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024), "w_gate_w_up": (4096, 14336),
              "w_down": (14336, 4096)}
    cases = [(f"{leaf}_M{M}", dict(M=M, K=K, N=N, x_dtype=bf), bf)
             for M in INT8_M.values() for leaf, (K, N) in shapes.items()]
    cases += [(f"wq_wo_M{M}", dict(M=M, K=4096, N=4096, x_dtype=bf), bf) for M in (1, 16, 65)]
    cases += [("w_gate_w_up_M128", dict(M=128, K=4096, N=14336, x_dtype=bf), bf)]
    cases += [
        ("fp32_x_M8", dict(M=8, K=4096, N=4096, x_dtype=f32), f32),
        ("bf16_x_out_fp32_M8", dict(M=8, K=4096, N=1024, x_dtype=bf), f32),
        ("x3d_2x3", dict(lead=(2, 3, 4096), K=4096, N=1024, x_dtype=bf), bf),
        ("ragged_130x200_at_200x72_bf16", dict(M=130, K=200, N=72, x_dtype=bf), bf),
        ("ragged_130x200_at_200x72_fp32", dict(M=130, K=200, N=72, x_dtype=f32), f32),
        ("zero_column_M8", dict(M=8, K=4096, N=1024, x_dtype=bf, zero_col=5), bf),
    ]
    failed, max_abs, faults = [], {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, shape, out_dtype in cases:
        x, qw = make_int8_inputs(gen, dev=dev, **shape)
        ragged = qz.int8_matmul.launches_ragged
        got = qz.int8_matmul(x, qw.data, qw.scales, out_dtype)
        again = qz.int8_matmul(x, qw.data, qw.scales, out_dtype)
        torch.cuda.synchronize()
        ragged = qz.int8_matmul.launches_ragged - ragged
        want = qz.int8_matmul_reference(x, qw.data, qw.scales, out_dtype)
        errs, ok = int8_check(got, want, out_dtype)
        ok = ok and got.shape == want.shape and got.dtype == want.dtype
        ok = ok and bool(torch.isfinite(got).all())
        K, N = qw.data.shape
        plan = qz.split_plan(math.prod(x.shape[:-1]), N, K, sms, x.dtype == bf)
        same_bits = bool(torch.equal(got, again))
        # bf16 x on the cluster route repeats its bits; the route is the shape's.
        ok = ok and (same_bits or x.dtype != bf) and ragged == 2 * (plan.route == "ragged")
        res = {"phase": "int8_matmul_check", "case": name, "x_dtype": str(x.dtype),
               "out_dtype": str(out_dtype), "x_shape": list(x.shape),
               "w_shape": list(qw.data.shape), "errors": errs,
               "max_abs": float((got.float() - want.float()).abs().max()),
               "route": plan.route, "cluster": plan.splits if plan.route == "cluster" else None,
               "bm": plan.bm, "same_bits_twice": same_bits, "tol": INT8_TOL[out_dtype]}
        if "zero_col" in shape:
            c = shape["zero_col"]
            res["zero_column_exact"] = (not bool(got[..., c].any())
                                        and float(qw.scales[c])
                                        == float(np.float32(1e-8) / np.float32(127.0)))
            ok = ok and res["zero_column_exact"]
        res["ok"] = ok
        emit(res)
        if not ok:
            failed.append(name)
        max_abs[name] = res["max_abs"]
        if name == "wq_wo_M8":
            faults = int8_planted_faults(x, qw, out_dtype, want)
        del x, qw, got, again, want
    for name, res in faults.items():
        emit({"phase": "int8_matmul_planted_fault", "fault": name, **res})
        if not res["caught"]:
            failed.append(f"planted fault {name} passes the check")
    if len(faults) != 4:
        failed.append(f"planted faults run: {sorted(faults)}")
    fresh = int8_fresh_weight_check(gen, dev)
    emit({"phase": "int8_matmul_fresh_weight", **fresh})
    if not fresh["ok"]:
        failed.append("weight written just before the call")
    if failed:
        raise PhaseFailed("int8 matmul kernel disagrees with its plain version", failed)
    torch.cuda.empty_cache()

    per_shape = {(M, K, N): int8_times(gen, dev, M, K, N)
                 for M in INT8_M.values() for K, N in shapes.values()}
    for t in per_shape.values():
        emit({"phase": "int8_matmul_time", **t})

    def layer(M, key):
        vals = [per_shape[(M, K, N)][key] for K, N in INT8_LAYER.values()]
        return None if any(v is None for v in vals) else sum(vals)

    totals = {stage: {k: layer(M, k) for k in ("kernel_ms", "kernel_in_context_ms",
                                               "plain_ms", "bound_ms", "dense_bf16_ms",
                                               "int8pack_ms")}
              for stage, M in INT8_M.items()}
    for key in ("kernel_call_ms", "dense_bf16_call_ms"):
        for stage, M in INT8_M.items():
            totals[stage][key] = layer(M, key)
    res = {"phase": "int8_matmul_layer_time",
           "covers": "one layer's 7 projections (wq, wk, wv, wo, w_gate, w_up, w_down) at "
                     "Llama-3-8B widths, bf16 x and out", **totals,
           "int8pack_error": next((t["int8pack_error"] for t in per_shape.values()
                                   if "int8pack_error" in t), None)}
    emit(res)
    decode = totals["decode"]
    return {"max_abs_err": max(max_abs.values()), "kernel_ms": decode["kernel_ms"],
            "kernel_in_context_ms": decode["kernel_in_context_ms"],
            "kernel_call_ms": decode["kernel_call_ms"],
            "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
            "bound_by": "bytes", "library_ms": decode["int8pack_ms"],
            "dense_bf16_ms": decode["dense_bf16_ms"], "prefill": totals["prefill"],
            "int8pack_error": res["int8pack_error"]}


# ----------------------------------------------------------- phase 13: int8 main path
def phase_main_int8(dev) -> int:
    """The main path with int8 weight-only projections: Llama-3-8B at full width and
    depth, bf16 params made on the card, every projection of every layer quantized on
    the card (embedding and head skipped) and the bf16 projections freed; the main
    workload served with ``phase_main``'s engine settings; every projection's launch
    counted. The first decode step's top-1 tokens are held beside those of a bf16
    engine on the same requests (informative, not a limit)."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import quantization as qz
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bf16_bytes = sum(leaf.nbytes for leaf in tree_leaves(params))
    ref = ContinuousBatcher(params, cfg, **MAIN_ENGINE)
    for prompt, kw in main_workload(cfg.vocab_size)[3]:
        ref.submit(prompt, **kw)
    ref.step()  # admits the first 8 requests, then the first decode step
    bf16_top1 = ref.last_logits.argmax(-1)
    del ref

    t0 = time.perf_counter()
    params = qz.load_and_quantize_model(params, qz.BnbQuantizationConfig(
        load_in_8bit=True, skip_modules=["embed", "lm_head"]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quantize_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_quantized = sum(isinstance(leaf, qz.QuantizedWeight) for leaf in leaves)
    int8_bytes = sum(leaf.nbytes for leaf in leaves)

    def reset_counts():
        paged_attention.launches = 0
        paged_attention.launches_ragged = 0
        qz.int8_matmul.launches = 0
        qz.int8_matmul.launches_ragged = 0

    run = serve_main(params, cfg, dev, reset_counts)
    launches, paged = qz.int8_matmul.launches, paged_attention.launches
    ragged = qz.int8_matmul.launches_ragged
    paged_ragged = paged_attention.launches_ragged
    s = run["stats"]
    chunks = sum(max(1, -(-int(n) // MAIN_ENGINE["prompt_bucket"])) for n in run["lengths"])
    expect = len(INT8_LAYER) * cfg.n_layers * (s["decode_steps"] + chunks)
    top1 = float((run["first_logits"].argmax(-1) == bf16_top1).float().mean())
    res = {**_serve_result(run, "main_int8", init_s),
           "weights": "int8 weight-only projections (load_in_8bit, embed and lm_head bf16)",
           "quantize_s": quantize_s, "quantized_leaves": n_quantized,
           "param_bytes_int8": int8_bytes, "param_bytes_bf16": bf16_bytes,
           "int8_matmul_launches": launches, "int8_matmul_launches_expected": expect,
           "int8_matmul_launches_ragged": ragged,
           "prefill_chunks": chunks, "paged_attention_launches": paged,
           "paged_attention_launches_ragged": paged_ragged,
           "top1_agreement_first_decode_step_vs_bf16": top1}
    res["ok"] = (run["finite"] and run["in_range"] and run["all_done"]
                 and s["pages_in_use"] == 0 and s["decode_steps"] > 0 and launches == expect
                 and ragged == 0 and paged_ragged == 0
                 and paged == cfg.n_layers * s["decode_steps"]
                 and n_quantized == len(INT8_LAYER) * cfg.n_layers)
    emit(res)
    if not res["ok"]:
        raise SystemExit("int8 main path failed its checks")
    prof = {**profile_decode(run["eng"], run["rng"], cfg.vocab_size), "weights": "int8"}
    emit(prof)
    one_kernel_per_call(prof, int8=True)
    del run
    dense = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    emit(decode_ab({"bf16": dense, "int8": params}, cfg))
    return {"launches": launches, "profile": prof}


def decode_ab(weights: dict, cfg, steps: int = 8) -> dict:
    """Prefill and decode-step wall times of two weight sets served alike, in
    alternation (A, B, B, A, ...) so that the host's load drifts alike over both: each
    window is a fresh engine that admits 8 lanes from the same 200-token prompts (the
    engine's prefill time per request), then ``steps`` decode steps timed on the host
    clock to a final sync."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (8, 200))
    a, b = list(weights)

    def window(params) -> tuple[float, float]:
        eng = ContinuousBatcher(params, cfg, **MAIN_ENGINE)
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=steps + 2)
        eng.step()  # admissions + the first decode step
        torch.cuda.synchronize()
        prefill_ms = 1e3 * eng.stats()["prefill_s"] / len(prompts)
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return prefill_ms, 1e3 * (time.perf_counter() - t0) / steps

    runs = {a: [], b: []}
    prefill = {a: [], b: []}
    for name in (a, b, b, a) * 2:
        p_ms, s_ms = window(weights[name])
        prefill[name].append(p_ms)
        runs[name].append(s_ms)
    med = {name: float(np.median(r)) for name, r in runs.items()}
    p_med = {name: float(np.median(r)) for name, r in prefill.items()}
    return {"phase": "decode_ab", "steps_per_window": steps, "lanes": 8,
            "order": f"({a}, {b}, {b}, {a}) x 2", "step_ms_runs": runs,
            "step_ms_median": med, f"{b}_over_{a}": med[b] / med[a],
            f"{b}_faster_in_every_pair": all(x < y for x, y in zip(runs[b], runs[a])),
            "prefill_ms_per_request_runs": prefill, "prefill_ms_per_request_median": p_med,
            f"prefill_{b}_over_{a}": p_med[b] / p_med[a]}


# ------------------------------------------- phase 14: vocab-sharded partial forward
XENT_TP_SIZES = (2, 4)  # tp ranks over Llama-3-8B's head: shards of 64128 and 32064


def make_partial_inputs(gen, *, T, D, VL, dtype, dev, score_std=1.0):
    """Seeded x [T,D], one rank's head slice w [D,VL] (scores of std ``score_std``) and
    shard-local targets: a third inside [0,VL), the rest on either side of it (ids the
    other ranks own), every 89th -1 and every 97th in the last vocab tile."""
    x = torch.randn((T, D), generator=gen, device=dev).to(dtype)
    w = (torch.randn((D, VL), generator=gen, device=dev) * (score_std / math.sqrt(D))).to(dtype)
    t = torch.randint(-VL, 2 * VL, (T,), generator=gen, device=dev)
    t[::89] = -1
    t[::97] = VL - 1
    return x, w, t


# Kernel #6 against its plain version, in flash_errors' terms (each element against
# 1 + |want|; the rms error). Both sum the same products in fp32 in other orders (mma
# tiles against cuBLAS), so at D = 4096 in bf16 a score differs by up to ≈ 4e-5: m and
# tgt are scores and carry that error as it is, and l = Σ exp(s - m) (≥ 1) as a relative
# one. The merged lse averages it out, so kernel #5's nll/lse limits are tighter. Each
# limit is about 3x the largest error the kernel showed on the card (PERF.md); every
# planted fault moves its statistic by 1e-2 or more.
PARTIAL_TOL = {
    torch.bfloat16: {"m": {"elem": 3e-5, "rms": 1.5e-5}, "l": {"elem": 1e-4, "rms": 4e-5},
                     "tgt": {"elem": 3e-5, "rms": 1.5e-5}},
    torch.float32: {n: {"elem": 1e-5, "rms": 2e-6} for n in ("m", "l", "tgt")},
}


def partial_check(got, ref, dtype) -> tuple[dict, dict]:
    """Errors of m, l and tgt and whether each is within PARTIAL_TOL."""
    errs = {n: flash_errors(g, r) for n, g, r in zip(("m", "l", "tgt"), got, ref)}
    tol = PARTIAL_TOL[dtype]
    return errs, {n: all(e[k] <= tol[n][k] for k in e) for n, e in errs.items()}


def partial_planted_faults(fx, x, w, t, cap, ref) -> dict:
    """Faulty plain versions of #6: the last vocab tile skipped; a target outside
    [0,VL) matched (its id clamped into the shard); l summed tile by tile at each
    tile's own max, never rescaled to the row's final max."""
    tile = fx.FWD_TILE[x.dtype]
    cut = (w.shape[1] - 1) // tile * tile
    faults = {"last_vocab_tile_skipped": fx.fused_xent_partial_reference(x, w[:, :cut], t, cap)}
    s, _ = fx._scores(x, w, cap)
    m, l, _ = ref
    idx = t.long().clamp(0, w.shape[1] - 1)
    faults["target_outside_matched"] = (m, l, s.gather(1, idx[:, None])[:, 0])
    tiles = s.split(tile, dim=1)
    l_bad = sum(torch.exp(c - c.max(dim=1, keepdim=True).values).sum(1) for c in tiles)
    faults["l_not_rescaled"] = (m, l_bad, ref[2])
    out = {}
    for name, bad in faults.items():
        errs, within = partial_check(bad, ref, x.dtype)
        out[name] = {"errors": errs, "caught": [n for n, ok in within.items() if not ok]}
    return out


def partial_bound_ms(T, D, VL, itemsize) -> tuple[float, str]:
    """Least time of one #6 call: 2·T·D·VL flops over the bf16 (fp32) peak, or x, w and
    the targets read once and m, l, tgt written once over the HBM rate."""
    flops = 2 * T * D * VL
    nbytes = (T * D + D * VL) * itemsize + 4 * T + 12 * T
    t_ops = flops / PEAK_FLOPS[torch.bfloat16 if itemsize == 2 else torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_fused_xent_partial(dev) -> dict:
    """Kernel #6 (the vocab-sharded partial forward) against its plain version: the
    training path's shards of Llama-3-8B's head (T = D = 4096, VL = 64128 and 32064,
    bf16) and an fp32 case ragged against every tile (T=300, D=256, VL=250), softcap
    30, targets of other ranks and -1; faults planted in the plain version must fail the
    same check; the partials of every tp slice of the whole head, merged in torch, must
    equal kernel #5's (nll, lse); then kernel, plain and bound times at VL = 64128."""
    from accelerate_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator(dev).manual_seed(14)
    T, D, V = XENT_MAIN["T"], XENT_MAIN["D"], XENT_MAIN["V"]
    cases = [(f"tp{n}_bf16", dict(T=T, D=D, VL=V // n, dtype=torch.bfloat16), 0.0)
             for n in XENT_TP_SIZES]
    cases += [("fp32_ragged_softcap30", dict(T=300, D=256, VL=250, dtype=torch.float32,
                                             score_std=30.0), 30.0),
              ("bf16_softcap30", dict(T=1000, D=512, VL=5000, dtype=torch.bfloat16,
                                      score_std=30.0), 30.0)]
    failed, errors, faults = [], {}, {}
    for name, shape, cap in cases:
        x, w, t = make_partial_inputs(gen, dev=dev, **shape)
        got = fx._fwd_partial(x, w, t, cap)
        repeats = None  # the bf16 kernels sum in a fixed order: a second call, same bits
        if shape["dtype"] == torch.bfloat16:
            repeats = all(torch.equal(a, b) for a, b in zip(fx._fwd_partial(x, w, t, cap), got))
        torch.cuda.synchronize()
        ref = fx.fused_xent_partial_reference(x, w, t, cap)
        errs, within = partial_check(got, ref, shape["dtype"])
        max_abs = {n: float((g - r).abs().max()) for n, g, r in zip(("m", "l", "tgt"), got, ref)}
        off = (t < 0) | (t >= shape["VL"])
        ok = (all(within.values()) and all(bool(torch.isfinite(g).all()) for g in got)
              and all(g.shape == (shape["T"],) and g.dtype == torch.float32 for g in got)
              and bool((got[2][off] == 0).all()) and repeats is not False)
        emit({"phase": "fused_xent_partial_check", "case": name, "softcap": cap,
              "rows_owned_elsewhere": int(off.sum()), "errors": errs, "max_abs": max_abs,
              "repeats_bits": repeats, "tol": PARTIAL_TOL[shape["dtype"]], "ok": ok})
        if not ok:
            failed.append(name)
        errors[name] = max_abs
        if name == "tp2_bf16" or name == "fp32_ragged_softcap30":
            for fault, res in partial_planted_faults(fx, x, w, t, cap, ref).items():
                faults[f"{fault}/{name}"] = res
        del x, w, t, got, ref
        torch.cuda.empty_cache()
    must_catch = {"last_vocab_tile_skipped": ["l", "tgt"], "target_outside_matched": ["tgt"],
                  "l_not_rescaled": ["l"]}
    for key, res in faults.items():
        res["must_catch"] = must_catch[key.split("/")[0]]
        emit({"phase": "fused_xent_partial_planted_fault", "fault": key, **res})
        if not set(res["must_catch"]) <= set(res["caught"]):
            failed.append(f"planted fault {key} passes the check")

    # The tp slices of one whole head, merged in fp32 as fused_cross_entropy_tp merges
    # them, against kernel #5 on the whole head.
    x = torch.randn((T, D), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((D, V), generator=gen, device=dev) / math.sqrt(D)).to(torch.bfloat16)
    t = torch.randint(0, V, (T,), generator=gen, device=dev)
    t[::89] = -1
    nll5, lse5 = fx._fwd(x, w, t)
    merge = {}
    for n in XENT_TP_SIZES:
        vl = V // n
        parts = [fx._fwd_partial(x, w[:, r * vl:(r + 1) * vl], t - r * vl) for r in range(n)]
        m, l, tgt = (torch.stack(p) for p in zip(*parts))
        m_g = m.max(0).values
        lse = m_g + torch.log((l * torch.exp(m - m_g)).sum(0))
        errs, within = xent_check({"nll": lse - tgt.sum(0), "lse": lse},
                                  {"nll": nll5, "lse": lse5}, torch.bfloat16)
        merge[f"tp{n}"] = errs
        if not all(within.values()):
            failed.append(f"tp{n} merge disagrees with kernel #5")
    emit({"phase": "fused_xent_partial_merge", "vs": "kernel #5 (nll, lse) on the whole head",
          "errors": merge, "tol": XENT_TOL[torch.bfloat16]["stat"], "ok": not failed})
    del x, w, t, nll5, lse5
    torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("kernel #6 disagrees with its plain version", failed)

    # Times at the tp=2 shard: graph-replayed device time, plain, kernel, kernel, plain.
    times = {}
    for n in XENT_TP_SIZES:
        vl = V // n
        x, w, t = make_partial_inputs(gen, T=T, D=D, VL=vl, dtype=torch.bfloat16, dev=dev)
        plain_runs = [device_ms(lambda _: fx.fused_xent_partial_reference(x, w, t), 1, 2)]
        torch.cuda.empty_cache()
        kernel_runs = [device_ms(lambda _: fx._fwd_partial(x, w, t), 2, 5) for _ in range(2)]
        plain_runs.append(device_ms(lambda _: fx.fused_xent_partial_reference(x, w, t), 1, 2))
        bound, bound_by = partial_bound_ms(T, D, vl, 2)
        t32 = t.to(torch.int32)
        kernels = device_kernels(lambda: fx._fwd_partial(x, w, t32))
        times[f"tp{n}"] = {"VL": vl, "kernel_ms": min(kernel_runs), "plain_ms": min(plain_runs),
                           "kernel_ms_runs": kernel_runs, "plain_ms_runs": plain_runs,
                           "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                           "tflops": 2 * T * D * vl / min(kernel_runs) / 1e9,
                           "device_kernels_per_call": kernels}
        del x, w, t
        torch.cuda.empty_cache()
    emit({"phase": "fused_xent_partial_time", "T": T, "D": D, "dtype": "bf16", **times})
    if any(tm["device_kernels_per_call"] != 2 for tm in times.values()):
        raise PhaseFailed("kernel #6 is not two device kernels a call",
                          [tm["device_kernels_per_call"] for tm in times.values()])
    return {"errors": errors, "times": times}


def xent_fwd_times(dev) -> dict:
    """Device ms of the fused CE forward kernels alone, each the best of two
    graph-replayed runs: #5 at the main shape and #6 at the tp shards of its head. It
    calls only the package's ``_fwd`` and ``_fwd_partial``, so it times another tree's
    kernels too (``--xent-fwd-times``)."""
    from accelerate_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator(dev).manual_seed(9)
    T, D, V = XENT_MAIN["T"], XENT_MAIN["D"], XENT_MAIN["V"]
    x, w, t, _ = make_xent_inputs(gen, dev=dev, **XENT_MAIN)
    out = {"fwd_ms": min(device_ms(lambda _: fx._fwd(x, w, t), 2, 5) for _ in range(2))}
    del x, w, t
    for n in XENT_TP_SIZES:
        x, w, t = make_partial_inputs(gen, T=T, D=D, VL=V // n, dtype=torch.bfloat16, dev=dev)
        out[f"partial_tp{n}_ms"] = min(
            device_ms(lambda _: fx._fwd_partial(x, w, t), 2, 5) for _ in range(2))
        del x, w, t
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ phases 15-16: tensor-parallel training
TP_MESH = {"dp": 1, "tp": 2}  # two gloo ranks share the card


def _rank_device(dev) -> str:
    """The device both ranks use: the parent's card (``cuda:0`` for ``cuda``)."""
    dev = torch.device(dev)
    return f"cuda:{dev.index or 0}" if dev.type == "cuda" else str(dev)


def _tp_counts(fa, fo, fx) -> dict:
    return {"fused_xent_partial": fx._fwd_partial.launches, "fused_xent_bwd": fx._bwd.launches,
            "fused_xent_fwd": fx._fwd.launches, "flash_fwd": fa._fwd.launches,
            "flash_bwd_dq": fa._bwd_dq.launches, "flash_bwd_dkv": fa._bwd_dkv.launches,
            "fused_adamw": fo.adamw_leaves.launches}


def _reset_tp_counts(fa, fo, fx) -> None:
    fx._fwd_partial.launches = fx._bwd.launches = fx._fwd.launches = 0
    fa._fwd.launches = fa._bwd_dq.launches = fa._bwd_dkv.launches = 0
    fo.adamw_leaves.launches = 0


def gloo_cuda_probe(device) -> dict:
    """What gloo's all-reduce does with tensors on ``device`` (the card): SUM and MAX of
    fp32 and bf16 against the values every rank can compute."""
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for op, want in (("sum", sum(range(1, n + 1))), ("max", n)):
            t = torch.full((1024,), rank + 1.0, dtype=dtype, device=device)
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()))
            out[f"{op}_{str(dtype).split('.')[-1]}"] = bool((t == want).all())
    return out


def tp_rank_parity(tokens, lr: float, steps: int, device: str) -> dict:
    """One rank of ``train_tp_parity``: the ``debug`` config in fp32 on dp1×tp2, the
    params made on the CPU from seed 0 and sharded by ``partition_specs``,
    ``fused_adamw`` and ``loss_impl="fused_tp"``; losses, grad norms, the gathered params
    and the kernels' launches."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.ops import fused_xent as fx
    from accelerate_tpu_torch.parallel import MeshConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = gloo_cuda_probe(device)
    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32, attn_impl="flash",
                              loss_impl="fused_tp")
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    acc = Accelerator(device=device, mesh_config=MeshConfig(**TP_MESH), backend="gloo")
    specs = llama.partition_specs(cfg)
    state = acc.create_train_state(params, fo.fused_adamw(lr), partition_specs=specs)
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    _reset_tp_counts(fa, fo, fx)
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    flat = params_to_numpy(state.params, mesh=acc.mesh, specs=specs)
    return {"rank": acc.process_index, "gloo_cuda_all_reduce": probe, "losses": losses,
            "grad_norms": norms,
            "launches": _tp_counts(fa, fo, fx), "params": _flat_params(flat),
            "backend": acc.state.backend, "device": str(acc.device)}


def _flat_params(flat: dict) -> np.ndarray:
    return np.concatenate([np.ravel(x) for x in [flat["embed"], flat["lm_head"], flat["ln_f"]]
                           + [v for layer in flat["layers"] for v in layer.values()]])


def phase_train_tp_parity(dev) -> None:
    """The tensor-parallel train step on the card (2 gloo ranks sharing it, dp1×tp2,
    ``loss_impl="fused_tp"``, kernel #6 and the fused-CE backward on each rank's vocab
    slice) against the same step on the CPU in one process (``loss_impl="fused"``, the
    plain versions): ``debug`` config, fp32, TF32 off, 3 steps of ``fused_adamw`` with
    ``max_grad_norm=1.0``; losses, the gathered params, and each step's global grad norm
    (AdamW's update barely moves when a leaf's gradient is scaled by a constant, so a
    tp-scaled or twice-reduced gradient shows in the norm, not in the params)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.launchers import notebook_launcher
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw

    lr, steps = 1e-3, 3
    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32, attn_impl="flash",
                              loss_impl="fused")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 129))
    _fresh_state_singletons()
    acc = Accelerator(device="cpu")
    state = acc.create_train_state(
        llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        fused_adamw(lr))
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    l_cpu, n_cpu = [], []
    for _ in range(steps):
        state, metrics = step(state, {"tokens": tokens})
        l_cpu.append(float(metrics["loss"]))
        n_cpu.append(float(metrics["grad_norm"]))
    p_cpu = _flat_params(params_to_numpy(state.params))
    _fresh_state_singletons()
    t0 = time.perf_counter()
    card = _rank_device(dev)
    ranks = notebook_launcher(tp_rank_parity, (tokens, lr, steps, card), 2, device=card,
                              backend="gloo", timeout_s=600)
    launch_s = time.perf_counter() - t0
    L = cfg.n_layers
    expect = {"fused_xent_partial": steps, "fused_xent_bwd": steps, "fused_xent_fwd": 0,
              "flash_fwd": L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
              "fused_adamw": steps}
    res = {"phase": "train_tp_parity", "config": "debug", "mesh": TP_MESH,
           "loss_impl": "fused_tp (card, 2 gloo ranks) vs fused (CPU, one process)",
           "losses_cpu": l_cpu, "grad_norms_cpu": n_cpu, "launch_s": launch_s, "launches_expected_per_rank": expect,
           "ranks": []}
    ok = True
    for r in ranks:
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], l_cpu))
        norm_rel = max(abs(a - b) / abs(b) for a, b in zip(r["grad_norms"], n_cpu))
        diff = np.abs(r["params"] - p_cpu)
        tight = float(np.mean(diff <= 2e-6 + 1e-5 * np.abs(p_cpu)))
        r_ok = (loss_rel <= 1e-4 and norm_rel <= 1e-5 and float(diff.max()) <= lr / 2
                and tight >= 0.999
                and r["launches"] == expect and all(r["gloo_cuda_all_reduce"].values()))
        ok = ok and r_ok
        res["ranks"].append({k: v for k, v in r.items() if k != "params"} | {
            "loss_max_rel_err": loss_rel, "grad_norm_max_rel_err": norm_rel,
            "params_max_abs_err": float(diff.max()),
            "params_share_within_2e-6+1e-5rel": tight, "ok": r_ok})
    res.update({"loss_tol_rel": 1e-4, "grad_norm_tol_rel": 1e-5, "params_tol_abs": lr / 2,
                "ok": ok})
    emit(res)
    if not ok:
        raise SystemExit("tensor-parallel train step on the card disagrees with the CPU")


TP_STEPS = 5  # 2 warm-up steps and 3 timed


def tp_rank_main(tokens, device: str) -> dict:
    """One rank of ``train_tp``: ``train_main``'s model (Llama-3-8B widths, TRAIN_LAYERS
    layers, the same seeded fp32 params made on the card) sharded by
    ``partition_specs`` over dp1×tp2, bf16 over fp32 masters, remat, flash attention,
    ``loss_impl="fused_tp"``, ``fused_adamw(1e-4)``, ``max_grad_norm=1.0``."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.ops import fused_xent as fx
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.utils.tree import tree_leaves

    dev = torch.device(device)
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=TRAIN_LAYERS,
                              dtype=torch.bfloat16, attn_impl="flash", remat=True,
                              remat_policy="full", loss_impl="fused_tp")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc = Accelerator(mixed_precision="bf16", device=dev, mesh_config=MeshConfig(**TP_MESH),
                      backend="gloo")
    params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                               generator=torch.Generator(dev).manual_seed(0), device=dev)
    state = acc.create_train_state(params, fo.fused_adamw(1e-4),
                                   partition_specs=llama.partition_specs(cfg))
    del params
    torch.cuda.empty_cache()
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()  # the whole fp32 model made, then sliced
    torch.cuda.reset_peak_memory_stats()
    _reset_tp_counts(fa, fo, fx)
    losses, norms, step_s = [], [], []
    for _ in range(TP_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = _tp_counts(fa, fo, fx)
    step_peak = torch.cuda.max_memory_allocated()
    shard_sizes = sorted({leaf.numel() % 1024 for leaf in state.params["layers"][0].values()})
    # One more step under the profiler (both ranks step: the collectives need both). The
    # card time-slices the two ranks' kernels, so a kernel's span may hold the other
    # rank's work too: the sum of the ranks' busy times bounds the card's from above.
    profile = profile_train_step(step, state, batch)
    return {"rank": acc.process_index, "losses": losses, "grad_norms": norms,
            "step_ms_runs": [1e3 * s for s in step_s], "step_ms": 1e3 * float(np.mean(step_s[2:])),
            "init_s": init_s, "init_peak_bytes": init_peak, "step_peak_bytes": step_peak,
            "launches": launches, "profile": profile,
            "local_params": sum(leaf.numel() for leaf in tree_leaves(state.params)),
            "layer_leaf_sizes_mod_1024": shard_sizes}


def phase_train_tp(dev, first_loss: float) -> dict:
    """The tensor-parallel training path at Llama-3-8B's full width, depth TRAIN_LAYERS:
    two gloo ranks share the card (dp1×tp2), each holding half of every projection, of
    the embedding and of the head, on ``train_main``'s seeded weights and batch. The
    first loss must be within 2e-3 of ``train_main``'s, and each rank's launches per step
    must be kernel #6 once, the fused-CE backward once, the flash forward 2L (remat), dq
    and dk/dv L each, AdamW once. The step time is two ranks on one card with the
    collectives staged through host memory by gloo: no tensor-parallel speed."""
    from accelerate_tpu_torch.launchers import notebook_launcher

    _fresh_state_singletons()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parent_bytes = torch.cuda.memory_allocated()
    tokens = np.random.default_rng(0).integers(0, 128256, (TRAIN_B, TRAIN_S + 1))
    t0 = time.perf_counter()
    card = _rank_device(dev)
    ranks = notebook_launcher(tp_rank_main, (tokens, card), 2, device=card, backend="gloo",
                              timeout_s=900)
    launch_s = time.perf_counter() - t0
    L, n = TRAIN_LAYERS, TP_STEPS
    expect = {"fused_xent_partial": n, "fused_xent_bwd": n, "fused_xent_fwd": 0,
              "flash_fwd": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dkv": L * n,
              "fused_adamw": n}
    res = {"phase": "train_tp", "config": "llama3-8b", "layers": L, "mesh": TP_MESH,
           "backend": "gloo (2 ranks share one card; collectives staged through host memory)",
           "batch": [TRAIN_B, TRAIN_S], "steps": n, "launch_s": launch_s,
           "parent_allocated_bytes": parent_bytes, "first_loss_train_main": first_loss,
           "first_loss_tol_rel": 2e-3, "launches_expected_per_rank": expect,
           "launches_per_step_expected": {k: v // n for k, v in expect.items()}, "ranks": []}
    ok = True
    for r in ranks:
        rel = abs(r["losses"][0] - first_loss) / abs(first_loss)
        r_ok = (rel <= 2e-3 and all(np.isfinite(r["losses"])) and all(np.isfinite(r["grad_norms"]))
                and all(b < a for a, b in zip(r["losses"], r["losses"][1:]))
                and r["launches"] == expect and r["layer_leaf_sizes_mod_1024"] == [0])
        ok = ok and r_ok
        res["ranks"].append({**r, "launches_per_step": {k: v / n for k, v in r["launches"].items()},
                             "first_loss_rel_err_vs_train_main": rel, "ok": r_ok})
    res["same_losses_on_every_rank"] = all(r["losses"] == ranks[0]["losses"] for r in ranks)
    busy = [r["profile"]["device_busy_ms"] for r in ranks]
    if all(b is not None for b in busy):
        wall = max(r["profile"]["wall_ms_profiled"] for r in ranks)
        res["profiled_step"] = {"wall_ms": wall, "device_busy_ms_by_rank": busy,
                                "card_idle_share_at_least": 1 - sum(busy) / wall}
    res["ok"] = ok and res["same_losses_on_every_rank"]
    emit(res)
    if not res["ok"]:
        raise SystemExit("tensor-parallel training path failed its checks")
    return {"launches": ranks[0]["launches"], "ranks": ranks}


def kernel_spills(libs: dict) -> dict:
    """Spill bytes (stores + loads) of every redesigned Hopper kernel (``*_ws_kernel``,
    ``*_cluster_kernel``) in the build's ``-Xptxas -v`` logs, by mangled name."""
    out = {}
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if not log.exists():
            continue
        name = None
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "spill stores" in line and name is not None:
                if "_ws_kernel" in name or "_cluster_kernel" in name:
                    nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                    out[name] = sum(nums[1:3]) if len(nums) >= 3 else None
                name = None
    return out


def check_spills(libs: dict) -> None:
    """Every redesigned Hopper kernel of the build spills 0 bytes."""
    spills = kernel_spills(libs)
    emit({"phase": "spills", "kernels": len(spills),
          "spilling": {k: v for k, v in spills.items() if v != 0}})
    if not spills or any(v != 0 for v in spills.values()):
        raise PhaseFailed("a Hopper kernel spills (or the build logs name none)",
                          [k for k, v in spills.items() if v != 0])


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
    fwd_only = "--xent-fwd-times" in sys.argv[1:]
    libs = run_phase("device", _build.build,
                     ["fused_xent"] if fwd_only else list(_build.KERNEL_SOURCES))
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text(), file=sys.stderr)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "sources": list(libs)})
    if fwd_only:  # a probe for same-call comparisons
        emit({"phase": "xent_fwd_times", "nvidia_smi": smi,
              **run_phase("xent_fwd_times", xent_fwd_times, dev)})
        return 0
    run_phase("spills", check_spills, libs)
    if "--int8-split-sweep" in sys.argv[1:]:  # a probe, run only when asked
        for t in run_phase("int8_split_sweep", int8_split_sweep,
                           torch.Generator(dev).manual_seed(6), dev):
            emit({"phase": "int8_split_sweep", **t})
        return 0

    # Serving (slice 1).
    kern = run_phase("kernel", phase_kernel, dev)
    run_phase("engine", phase_engine, dev)
    serve = run_phase("main", phase_main, dev)
    torch.cuda.empty_cache()
    # Training (slice 2).
    flash = run_phase("flash", phase_flash, dev)
    torch.cuda.empty_cache()
    adamw = run_phase("adamw", phase_adamw, dev, TRAIN_LAYERS)
    # Fused cross-entropy (slice 3).
    xent = run_phase("fused_xent", phase_fused_xent, dev)
    run_phase("train_parity", phase_train_parity, dev)
    torch.cuda.empty_cache()
    train = run_phase("train_main", phase_train_main, dev)
    torch.cuda.empty_cache()
    train_fused = run_phase("train_fused", phase_train_main, dev, "fused",
                            first_loss=train["losses"][0])

    # Int8 weight-only serving (slice 4).
    torch.cuda.empty_cache()
    int8 = run_phase("int8_matmul", phase_int8_matmul, dev)
    run_phase("quant_engine_vs_cpu", phase_engine, dev, "int8")
    run_phase("quant_engine_vs_cpu", phase_engine, dev, "nf4")
    serve_int8 = run_phase("main_int8", phase_main_int8, dev)

    # Tensor-parallel training (slice 5): the parent frees its cached memory first, since
    # the two ranks share the card.
    gc.collect()
    torch.cuda.empty_cache()
    partial = run_phase("fused_xent_partial", phase_fused_xent_partial, dev)
    run_phase("train_tp_parity", phase_train_tp_parity, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_tp = run_phase("train_tp", phase_train_tp, dev, train["losses"][0])
    emit({"kernels": run_phase("kernels", kernel_rows, kern, serve, flash, adamw,
                               xent, train, train_fused, int8, serve_int8, partial,
                               train_tp)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_rows(kern, serve, flash, adamw, xent, train, train_fused, int8, serve_int8,
                partial, train_tp) -> list:
    """The kernels line: one row per kernel of the port, from the phases' results."""
    csrc, fa_py = "accelerate_tpu_torch/csrc/", "accelerate_tpu/ops/flash_attention.py"
    ft, fe = flash["times"], flash["errors"]["max_abs"]
    # One library call computes dq, dk and dv together: its time stands in both rows,
    # beside the sum of the two kernels (``kernels_dq_plus_dkv_ms`` of flash_time).
    bwd_library = "one aten flash-attention backward for dq+dk+dv (K/V expanded to H heads)"
    xt, xe = xent["times"], xent["errors"]["max_abs"]
    fx_py = "accelerate_tpu/ops/fused_xent.py"
    # One backward call computes dx and dw: rows 7 and 8 name it both, with its time and
    # its launches (one per step for the pair).
    xent_extra = {"chunked_ce_fwd_ms": xt["chunked_ce"]["fwd_ms"],
                  "chunked_ce_fwd_bwd_call_ms": xt["chunked_ce"]["fwd_bwd_call_ms"]}
    bwd_note = {"design": XENT_BWD_DESIGN, "slab": xt["bwd"]["slab"],
                # Counted in train_fused's run: slab-kernel launches per _bwd call.
                "device_kernels_per_call": train_fused["launches"]["fused_xent_bwd_slab_kernels"]
                / train_fused["launches"]["fused_xent_bwd"],
                "slab_kernel_ms": xt["bwd"]["slab_kernel_ms"],
                "note": "one _bwd call computes dx and dw: per vocab slab one d, one dw and "
                        "one dx kernel (fxent_ws_kernel); launches count _bwd calls, "
                        "once per step for the pair"}
    return [
        _kernel_row("paged_attention", csrc + "paged_attention.cu",
                    "accelerate_tpu/ops/paged_attention.py:106", serve["launches"],
                    kern["max_abs_err"], kern, design=PAGED_DESIGN,
                    device_kernels_per_decode_step=serve["profile"][
                        "paged_attention_kernels_per_step"],
                    device_kernels_per_decode_step_int8=serve_int8["profile"][
                        "paged_attention_kernels_per_step"]),
        _kernel_row("flash_fwd", csrc + "flash_attention.cu", fa_py + ":155",
                    train["launches"]["flash_fwd"], max(fe["o"], fe["lse"]), ft["fwd"],
                    "scaled_dot_product_attention forward (flash, enable_gqa)",
                    design=FLASH_DESIGN),
        _kernel_row("flash_bwd_dq", csrc + "flash_attention.cu", fa_py + ":343",
                    train["launches"]["flash_bwd_dq"], fe["dq"], ft["dq"], bwd_library,
                    design=FLASH_DESIGN),
        _kernel_row("flash_bwd_dkv", csrc + "flash_attention.cu", fa_py + ":422",
                    train["launches"]["flash_bwd_dkv"], max(fe["dk"], fe["dv"]), ft["dkv"],
                    bwd_library, design=FLASH_DESIGN),
        _kernel_row("fused_adamw", csrc + "fused_adamw.cu",
                    "accelerate_tpu/ops/fused_optim.py:101", train["launches"]["fused_adamw"],
                    max(adamw["max_abs_err_fp32"], adamw["max_abs_err_bf16"]), adamw,
                    "torch._fused_adamw_"),
        _kernel_row("fused_xent_fwd", csrc + "fused_xent.cu", fx_py + ":82",
                    train_fused["launches"]["fused_xent_fwd"], max(xe["nll"], xe["lse"]),
                    xt["fwd"], None, **xent_extra, design=XENT_FWD_DESIGN,
                    device_kernels_per_call=xt["fwd"]["device_kernels_per_call"],
                    cublas_x_at_w_ms=xt["fwd"]["cublas_x_at_w_ms"]),
        _kernel_row("fused_xent_bwd_dx", csrc + "fused_xent.cu", fx_py + ":128",
                    train_fused["launches"]["fused_xent_bwd"], xe["dx"], xt["bwd"], None,
                    **xent_extra, **bwd_note),
        _kernel_row("fused_xent_bwd_dw", csrc + "fused_xent.cu", fx_py + ":151",
                    train_fused["launches"]["fused_xent_bwd"], xe["dw"], xt["bwd"], None,
                    **xent_extra, **bwd_note),
        _kernel_row("int8_matmul", csrc + "int8_matmul.cu",
                    "accelerate_tpu/ops/quantization.py:153", serve_int8["launches"],
                    int8["max_abs_err"], int8,
                    "torch._weight_int8pack_mm (weight [N, K], bf16 scales)",
                    shape="one decode step's 7 projections of a layer (M = 8, bf16), "
                          "Llama-3-8B widths", design=INT8_DESIGN,
                    dense_bf16_ms=int8["dense_bf16_ms"],
                    kernel_in_context_ms=int8["kernel_in_context_ms"],
                    prefill_layer=int8["prefill"],
                    device_kernels_per_decode_step=serve_int8["profile"][
                        "int8_mm_kernels_per_step"],
                    int8pack_error=int8["int8pack_error"]),
        _kernel_row("fused_xent_partial", csrc + "fused_xent.cu", fx_py + ":96",
                    train_tp["launches"]["fused_xent_partial"], max(partial["errors"]["tp2_bf16"].values()),
                    partial["times"]["tp2"], None, design=XENT_FWD_DESIGN,
                    device_kernels_per_call=partial["times"]["tp2"]["device_kernels_per_call"],
                    shape="one tp=2 rank's slice of Llama-3-8B's head: T = D = 4096, "
                          "VL = 64128, bf16", tp4=partial["times"]["tp4"],
                    note="launches: rank 0 of train_tp (each rank launches it once per step)"),
    ]


if __name__ == "__main__":
    sys.exit(main())

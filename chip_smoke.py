"""Chip smoke test of the PyTorch + CUDA port (``accelerate_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero, after one
line ``{"phase": "failed", "in": ..., "cases": ..., "error": ..., "traceback": ...}``
that names the phase, its failed cases and the exception. Since slice 22, phases 5-10
(flash to train_fused) and train_accumulate run right after the training kernels are
built, while paged attention's source, the longest to compile, still compiles; phase 1
then waits for the rest of the build (``device_serving``) and prints its line:

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
   lanes ending on a tile boundary, all-sentinel tail pages), and lanes whose block
   tables share a prefix's page ids with its partial page copied on write (bf16 and
   int8 pools, as the prefix cache lays them out), and the speculative verify's T = 4
   (bf16 and int8 pools; every lane's window across a page boundary, one ending on a
   sentinel page whose slots are marked valid); every bf16 call made twice
   must repeat its bits; faults planted in the chunked reference (the last live tile
   skipped, the window's edge off by one, p left unrounded, the int8 V scale dropped)
   must fail the same check; then kernel, plain and bound times: device time from
   CUDA-graph replay between CUDA events, and call time (host work included) from CUDA
   events around calls; K/V pools rotate past the 50 MB L2; the same at T = 4.
3. engine — the paged engine on the card against the same engine on the CPU
   (``debug`` config, fp32, same seeded params and requests): identical greedy tokens,
   first decode step's logits within tolerance. engine_multistep — the same engine on
   the card with ``decode_steps=4`` (super-steps replayed from CUDA graphs), dense and
   paged, against the CPU's ``decode_steps=1``: identical greedy tokens, an EOS inside a
   super-step; two sampled requests: identical to the card's ``decode_steps=1``; each
   graph holds one paged-attention launch per layer and step (none when dense).
   engine_prefix — the admission path against the CPU (``debug``, fp32,
   ``decode_steps=4``): dense and paged engines with ``prefix_cache=4`` (pages of 24
   cutting the 32-token chunks: copy-on-write; a 16-page pool: registry eviction and
   deferral under pressure) and a paged engine with ``prompt_buckets``; a shared
   system prompt, the system prompt alone, a prompt past the top rung. On the card
   each engine runs ``warm_programs()`` first and captures no graph in traffic; tokens
   and every admission, prefix, bucket and page counter equal the CPU's after every
   step; every page free once the registry is evicted. engine_spec — speculative serving
   (``spec_k=3``) against the CPU (``debug``, fp32): n-gram host loop and fused
   super-step (``decode_steps=4``), dense and paged; the perfect ModelDrafter and a
   1-layer one; residual acceptance; ``prefix_cache=4``; an int8 paged fused engine.
   Staggered greedy and sampled requests, an EOS mid-stream, budgets ending inside a
   round, speculation switched off and on mid-drain: tokens and every ``spec_*``
   counter equal the CPU's after every step, tokens equal the card's ``spec_k=0``
   engine's, the perfect drafter accepts everything, no page leaked.
   engine_disagg — disaggregated serving against the CPU (``debug``, fp32, pages of 8):
   ``DisaggRouter`` fleets of a prefill and a decode replica (1P:1D; the decode replica
   at ``decode_steps=4``, with ``spec_k=2`` n-gram, with a ModelDrafter over the
   target's params; P:D:mixed; a prefill pool sized for context pages only; a decode
   pool small enough to defer adoptions; pages of 12 and a prefix-cached prefill
   replica, whose boundary pages are copied on write; int8 projections; int8 KV pools;
   ``kill(1)`` of a P:D:D fleet; ``kill(0)`` with a restart factory): tokens and
   streams equal a mixed engine's on the card, tokens and every router and replica
   counter equal the CPU's after every router step, pools drained, kernel #1's
   launches one per layer per token step on each decode-capable replica (plus the
   drafter's rounds) and none on a prefill replica.
4. main — the paged continuous-batching engine serving 10 requests at Llama-3-8B's
   full width and depth (bf16, seeded random weights made on the card), with the
   kernel's launch count checked against the decode dispatches; then a few decode
   steps under ``torch.profiler`` for the device's busy time and idle share, where each
   launch of the paged kernel must show as exactly one device kernel (and, in phase 13,
   each int8 launch too). main_multistep — the same workload with ``decode_steps=8``:
   every token (greedy and sampled) equal to main's, each graph exactly 32·8 paged
   attention launches, launches (eager plus graph nodes × replays) 32·8 a super-step;
   its profiled window (and the graph replayed back to back: device time per
   super-step); ``decode_ab`` of N = 1 and N = 8 engines (ms per decode token) and
   ``drain_ab`` (the whole workload on warm engines: tokens/s), each alternated.
   On the card every engine's prefill programs replay CUDA graphs, one per
   (program, width), captured at each program's first call or by ``warm_programs()``.
   main_prefill — the same workload with ``prompt_buckets=(128, 256, 512)`` and
   ``decode_steps=8`` after ``warm_programs()``: no graph captured in traffic, every
   token equal to the same engine's with eager prefill programs, exactly 32·8 paged
   attention launches a super-step; ``prefill_ab`` (ms per admission, graph against
   eager, alternated, per rung and past the top rung) and fresh engines draining it
   without and with ``warm_programs()`` (tokens/s, the first request's time to first
   token, warm-up seconds and pool bytes). main_prefix — 16 requests sharing a
   384-token system prompt (suffixes of 16–160 tokens, 64 new tokens each), paged,
   ``prefix_cache=8``, ``decode_steps=8``: each request's tokens equal to the same
   request's served with the registry cleared first (all misses), launches exact over
   shared pages; hits, shared pages, COW copies, peak memory, ms per admission on a hit
   against a miss and tokens/s beside a ``prefix_cache=0`` engine (each alternated).
   main_spec — the same workload with ``decode_steps=8``, ``spec_k=3`` and the n-gram
   drafter after ``warm_programs()``: no graph captured in traffic, tokens equal a
   host-loop spec engine's bitwise, kernel #1 exactly 32·8 launches a fused super-step
   on the cluster route, every divergence from ``main``'s tokens a near tie; tokens/s
   against spec_k=0 at N = 8 (``drain_ab``), accept rate, tokens per round, one
   super-step's device profile, noise seconds, peak memory. main_spec_draft — the host
   loop with a ModelDrafter over the target's own params, 4 greedy requests of 32
   tokens: accept rate ≥ 0.9, ms per token against N = 1 (alternated), the draft
   round's graph time.
   main_disagg — ``main``'s 10 requests through a ``DisaggRouter`` over a prefill
   replica and a decode replica (``decode_steps=8``) sharing the card and the params,
   after ``warm_programs()``: tokens equal ``main``'s bitwise, one handoff each, pools
   drained, no graph captured in traffic, kernel #1 exactly 32·8 a decode super-step
   and never on the prefill replica; each handoff's pages and bytes against the
   table-width block; device ms of the export gather, import scatter and copy on write
   beside bytes / 3.35 TB/s; an adoption's host ms; time to first token and tokens/s
   against a mixed engine at N = 8 (alternated); the decode replica's idle share; peak
   memory; then a P:D:D fleet killing decode replica 1 mid-drain (streams equal
   ``main``'s, requests adopted again from the prefill replica's pages).
   generate — ``llama.generate``, ``score`` and ``perplexity``: ``debug`` fp32 on the
   card against the CPU, then Llama-3-8B bf16, 4 left-padded prompts, 64 new tokens
   (the decode step one graph, replayed; time per token).
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
   agreement of the first decode step with a bf16 engine; then a profiled decode window,
   the same workload with ``decode_steps=8`` (tokens equal to the N = 1 run's, graphs of
   exactly 224·8 int8 and 32·8 paged-attention launches) and its profiled window, and
   ``decode_ab``: bf16 and int8 engines' prefill and decode steps in alternation, at
   N = 1 and at N = 8.
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
   tensor-parallel speed). Since slice 20, 3 steps (2 warm-up, 1 timed), and phases
   15, 16 and 30 share one launch of the two ranks (``train_ranks``, after 29): a rank
   process pays its start and its first step's warm-up once.
17. train_resume (run right after train_fused) — save and resume at ``train_main``'s
   configuration with the depth cut to 1 layer (``RESUME_LAYERS``: two 8-layer
   checkpoints wrote 67 GB, past the 45 GiB of disk a run on the card's host may write;
   2 layers until slice 19, cut to keep the whole script's time in bound),
   fed by a stateful ``DataLoaderShard`` over a ``TokenDataset`` of 2^24 seeded tokens
   (the native C++ gather required) with a custom object and a scheduler registered:
   3 steps, ``save_state()``, 3 steps, ``load_state()`` in place, the loader re-iterated
   from its restored position and the 3 steps again: losses bitwise, every state leaf's
   checksums, the first layer's leaves (``torch.equal``), the counts and
   the loader's batches equal; then the same round with ``save_state(async_save=True)``
   and the steps run while the files are written. Printed: free disk and
   ``MemAvailable``, state bytes and bytes on disk, the save's seconds (device copies,
   write and hash thread-seconds, commit) and GB/s, the async save's blocking seconds
   against its time to commit, the load's (verify, read, host-to-device), peak device
   memory of the save and the load against the training peak (at most the staging
   buffers above it), step ms with loader batches against the fixed on-device batch
   (alternated), the native gather's host ms per batch, and the kernels' launches per
   step (2L/L/L flash, 1 AdamW).
18. checkpoint_debug — ``debug``, fp32, on the card: the same round, bitwise; a
   committed checkpoint with one byte flipped and an uncommitted one quarantined on
   load, the previous valid one selected (``checkpoints_quarantined == 2``); an explicit
   corrupt ``input_dir`` raises ``CheckpointCorruptError``; rotation with
   ``total_limit=2`` keeps the JAX rule's survivors; the card's checkpoint loads into a
   CPU ``Accelerator``'s state, whose next loss matches the card's within 1e-4.

19. engine_faults — the fault boundary against the CPU (``debug``, fp32, the same six
   requests): under the same seeded ``FaultPlan`` on both sides, an attributed decode
   poison (dense), an unattributed poison bisected to its request (paged
   ``decode_steps=4``; the fused speculative super-step), a ``hang`` past the step
   watchdog rebuilt in place (paged; int8 projections at ``decode_steps=4``),
   ``kv_admit`` and ``prefill`` faults (paged prefix cache), a decode-role replica's
   hang (re-prefilled through its row cache) and ``crash`` clauses failing a P:D:D
   fleet over: the same quarantined requests, reasons, tokens (greedy and sampled),
   fired list, counters and fault/recovery records as the CPU, no page leaked, every
   record valid, no graph captured after ``warm_programs()``, the cache planes at the
   same addresses after a rebuild, kernel #1 once per layer per token step of every
   dispatch that ran; and a telemetry step record's fence waiting for 20 fp32
   products of 4096² on the card (``fence_check``).
20. main_faults — ``main``'s 10 requests through a ``ServingGateway`` over a paged
   ``decode_steps=8`` engine after ``warm_programs()``, with an enabled ``Telemetry``
   and a ``Tracer``, under an unattributed poison of request 2 (bisected to it) and a
   3 s ``hang`` past a 1 s step watchdog (a rebuild in place): request 2 ``FAILED``
   with ``step_fault:error``; every other request done, its tokens ``main``'s or
   diverging only after its re-admission at a near tie; no graph captured, the cache
   at the same addresses, no page leaked, kernel #1 exact, every record valid; the
   rebuild's ms, bisection rounds and seconds to quarantine. Then warm drains through
   gateways with telemetry and tracer off and on (alternated: tokens/s), the on
   drains' spans against each request's TTFT and TPOT and ``trace_report``'s TTFT
   percentiles against the gateway's; then a P:D:D fleet whose decode replica 1 dies
   by a ``crash`` clause at its third dispatch (``EngineCrashed`` out of its
   ``step()``): streams equal ``main``'s, requests adopted again
   (``main_disagg_crash``). Both run right after ``main_disagg`` (their numbers in the
   list are those of the slice that added them), before ``main_control``.
21. main_control — the serving control plane at Llama-3-8B's full width, depth cut to
   BENCH_LAYERS (8; main_bench likewise), through the port's serve-bench entry points on the virtual clock (every engine,
   spawned and restarted ones included, warmed before traffic): a trace replay whose
   live metrics plane one HTTP scrape on 127.0.0.1 and ``metrics_dump``'s offline
   re-aggregation must equal; the chaos proof at ``main``'s geometry (decode, prefill
   and kv_admit faults; alerts, flight recorder, capsules read back; every stream that
   left the clean arm's at a near tie after its re-admission); the fleet chaos proof
   (crash kills, restarts, failover; replayed streams bitwise); the autoscaling proof
   (a scale-up through ``spawn_replica`` and a scale-down; streams bitwise). No graph
   captured in traffic; kernel #1 exact on the paged engines.
22. elastic_train (run right after checkpoint_debug) — elastic, fault-injected training at
   Llama-3-8B's width, depth cut to 1 layer (B=1, S=2048, 6 steps, chunked CE,
   ``fused_adamw``, a ``DataLoaderShard`` over the native ``TokenDataset``), in worker
   processes (``--elastic-worker``) that load the kernels built by phase 1 and build
   none: one worker under ``elastic.ElasticSupervisor(max_restarts=2)`` whose first
   attempt saves a good checkpoint at step 2, one corrupted after its marker at step 4
   (``ckpt.save:corrupt``) and dies in step 5's save (``ckpt.save:crash``); the second
   quarantines both, resumes from step 2 through ``skip_first_batches`` and saves with
   ``safe_serialization=True``; an uninterrupted worker beside it. Final leaves and
   losses bitwise equal to the uninterrupted worker's, one ``elastic.restart/v1`` record,
   ``model.safetensors`` and ``python -m accelerate_tpu_torch merge-weights``' output
   bitwise equal to the final params; save and load seconds and GB/s, each worker's
   launches (2L/L/L flash, 1 AdamW a step). The checkpoints live in ``/dev/shm``: the
   card's host takes at most 45 GiB of disk writes a run.
23. elastic_gang — ``python -m accelerate_tpu_torch launch --multi-process
   --num-processes 2 --max-restarts 1 chip_smoke.py --gang-worker ...``: two gloo ranks
   sharing the card (``debug``, fp32); rank 0 dies once after the step-3 checkpoint, the
   supervisor tears rank 1 down and relaunches both on a fresh port; the gang resumes and
   its final params match one uninterrupted process within ``train_tp_parity``'s fp32
   tolerance. NCCL (one rank per card) is not run. Since slice 22 its launch starts
   before elastic_train and runs beside it (``elastic_gang_start``); the phase then
   waits for it and checks it.
24. fp8_dot_check (run right after train_fused) — ``ops.fp8``'s products through
   ``torch._scaled_mm`` against the plain version (fp32-widened codes) at Llama-3-8B's
   projection shapes (M = 2048), M = 8 and a ragged shape, HYBRID and E4M3, forward, dx
   and dw; ``fp8_dot``'s bf16 forward and gradients through autograd; times of the
   product, the whole fp8_dot forward and cuBLAS's bf16 ``x @ w``.
25. train_fp8 — ``train_main``'s recipe with ``use_fp8`` under
   ``Accelerator(mixed_precision="fp8")``, delayed scaling (history 4), O1 and O2 arms:
   finite falling losses, the first within 1e-4 of train_main's, the amax history, O2's
   moment bytes a quarter of O1's, launches (2L/L/L flash, 1 AdamW a step in O1, 28L
   ``_scaled_mm`` a step); a profiled O1 step split into ``_scaled_mm``, quantize,
   amax, layout copies and the rest.
26. train_lora (run right after main_int8, over its bf16 params) — rank-16 adapters on
   wq/wk/wv/wo at Llama-3-8B's full depth, ``lora_optimizer(adamw(1e-3))``, 1 x 2048:
   the base unchanged and never handed to ``torch.autograd.grad``, adapters moved,
   losses falling, peak memory within 12 GB above what was resident; a greedy paged
   drain over the adapted params against one over ``merge_lora``'s (near ties
   allowed, delta ≤ DELTA_MAX), the adapted row at each divergence within DELTA_MAX of
   ``llama.forward``'s; ``only_lora`` → ``load_lora`` bitwise.
27. qlora_closure — the same adapters over main_int8's int8 base in the closure form
   (the state holds only the adapters), 3 steps: the int8 bytes unchanged, losses
   falling, kernel #10's launches exact; #10's time at M = 2048.
28. packed_check (after fused_xent_partial; slice 20) — one seeded packed batch (documents of
   64-1536 tokens packed first-fit by ``ops.packing.pack_sequences`` into 2 rows of 2048,
   4-5 documents a row) at Llama-3-8B's width, 2 layers, forward only: the packed loss
   against the documents' own losses (token-weighted), each document's packed hidden
   states against its own alone, the flash kernels' segment route and the bf16 einsum
   attention each against an fp32 einsum reference, a planted fault (segment ids
   dropped) caught; #2's segment launches.
29. train_offload — ``cpu_offload`` on one rank: 2 layers bitwise against no offload;
   then Llama-3-8B at full depth (32 layers, one
   packed row of 7 documents; fewer when the host's available memory cannot pin the
   moments, printed as ``full_depth: false``) with its moments streamed from pinned
   host memory: step time, the stream's rates, #9 once a chunk.
30. train_ranks (the shared launch: train_tp_parity, train_tp, then train_fsdp's ranks),
   train_tp_parity and train_tp (15, 16), then train_fsdp — ZeRO-3, ZeRO-2 and ZeRO-1
   on two gloo ranks sharing the card (dp1×fsdp2, 2 layers, the packed batch,
   collectives through CUDA IPC) against a one-rank arm run before the launch (its
   params on the card, read by the ranks through CUDA IPC): losses, params, ZeRO-3's
   halved resident state, launches, collective
   bytes and routes; fsdp_ckpt — the ranks' depth-1 ZeRO-3 state saved SHARDED and
   FULL_STATE_DICT under /dev/shm: FULL reloaded into the ranks, the SHARDED save
   resharded into one rank, the FULL checkpoint into one rank, ``merge-weights``: every
   leaf bitwise (per-leaf checksums summed from each rank's pieces).
   Since slice 22 the tp ranks build their ``Accelerator`` through
   ``tp_plugin=TensorParallelPlugin(tp_size=2)`` (the mesh must be dp1×tp2), and in
   train_tp_parity rank 1's ``set_trigger`` must fire ``check_trigger`` on both ranks,
   the next check on neither.
31. train_accumulate (run right after train_fused; slice 22) — HF Accelerate's loop
   surface at Llama-3-8B's width, 1 layer, B=2, S=2048, ``gradient_accumulation_steps=2``,
   four batches: arm A (``clip_grad_value_``/``clip_grad_norm_``, then each step inside
   ``accumulate()``) against arm B (the constructor's ``max_grad_norm`` and
   ``build_train_step(max_grad_value=)``, run twice for its own spread) bit for bit,
   arm C (no clip, the planted fault) off B; sync flags, the clamped share, a
   ``no_sync()`` window (params unchanged, the buffer the sum of both gradients), the
   launches of #2-#4 and #9 in every arm, all within 10 s.

Every process the script starts keeps the bytecode it compiles under ``build/pycache``
(``share_bytecode``): where the installation writes none, each process compiled torch's
sources anew, which was most of a fresh worker's or rank's start and first step. The
kernels compile while the script imports torch (``start_kernel_build``), and the script,
each elastic worker and each rank of the shared launch import ``torch._dynamo`` (which
the first checkpointed block needs) in a thread while they set up (``preload_dynamo``).

Then each phase's wall seconds, the kernels line (the serving kernels' launches include the super-steps' graph
replays: kernel nodes times replays), the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.

    python3 chip_smoke.py --xent-fwd-times

builds only the fused CE kernels and prints one line of forward times (#5 at the main
shape, #6 at the tp shards), the phases skipped: run from another tree's root (with a
copy of this script), it times that tree's kernels for a same-call comparison.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

#: The kernel sources the training phases that run first launch (``main``).
TRAIN_SOURCES = ("flash_attention", "fused_adamw", "fused_xent")
#: Where every Python process of the script keeps its compiled bytecode (git-ignored).
PYCACHE = Path(__file__).resolve().parent / "build" / "pycache"


def share_bytecode() -> None:
    """Keep the bytecode that Python compiles from source in PYCACHE, in this process and
    every process it starts (``PYTHONPYCACHEPREFIX``), written even where the
    environment says not to (``PYTHONDONTWRITEBYTECODE``). Where the installation ships
    no bytecode beside torch's sources and bytecode is not written, every process
    compiles the sources it imports anew: about 8 s of ``import torch``, and about 9 s
    of ``torch._dynamo``, which the first non-reentrant ``torch.utils.checkpoint`` call
    imports (``torch._disable_dynamo``), in each elastic worker, launched rank and
    spawned rank process (a fresh process's first remat step took 10-13 s)."""
    PYCACHE.mkdir(parents=True, exist_ok=True)
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def start_kernel_build(argv) -> Optional[dict]:
    """Start ``nvcc`` for the kernel sources the run needs (``_build.start``), so that the
    compiles overlap the interpreter's import of torch; None where the port or ``nvcc``
    is missing (``main`` then stops, or builds what it needs)."""
    try:
        from accelerate_tpu_torch.ops import _build
    except ImportError:
        return None
    names = ["fused_xent"] if "--xent-fwd-times" in argv else list(_build.KERNEL_SOURCES)
    try:
        return _build.start(names)
    except RuntimeError:  # no nvcc
        return None


EARLY_BUILD: Optional[dict] = None
# Before torch is imported: its bytecode is kept, and the kernels compile while it loads
# (worker processes build nothing).
if __name__ == "__main__":
    share_bytecode()
    if sys.argv[1:2] not in (["--elastic-worker"], ["--gang-worker"]):
        EARLY_BUILD = start_kernel_build(sys.argv[1:])

import numpy as np  # noqa: E402

import torch  # noqa: E402

# Hardware numbers of one H100 SXM (NVIDIA's data sheet): HBM rate and the dense
# tensor-core peak in bf16 (fp32 math outside the tensor cores: 67 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(SystemExit):
    """A phase's checks failed; ``cases`` names the failed cases (a dict: with what
    each read)."""

    def __init__(self, what: str, cases):
        super().__init__(f"{what}: {cases if isinstance(cases, dict) else list(cases)}")
        self.cases = list(cases)


#: Wall seconds of each phase run through :func:`run_phase` (a name run twice adds up),
#: printed on the line before the kernels line.
PHASE_SECONDS: dict = {}


def run_phase(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds added to :data:`PHASE_SECONDS`. Any failure
    first leaves a record on stdout: one JSON line naming the phase, its failed cases
    (where it names them), the exception's text and the end of its traceback; then it
    propagates."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    except BaseException as e:
        emit({"phase": "failed", "in": name, "cases": getattr(e, "cases", None),
              "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:],
              "phase_seconds": dict(PHASE_SECONDS)})
        raise
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0


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
    captured from one call (after a warm-up call), counted through the driver API
    (``utils.cuda_graph.graph_kernel_nodes``). (``torch.profiler``'s kernel records
    missed kernels of a window's first call in some runs on this card, so it is not
    used for counting.)"""
    from accelerate_tpu_torch.utils.cuda_graph import graph_kernel_nodes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return sum(graph_kernel_nodes(graph).values())


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
        # The other shapes main_bench gives the kernel at 8B: the disagg bench's decode
        # replica (pages of 8, the smallest page size the cluster route takes, 128 a
        # lane), and the paged compare's and multistep sweep's lanes (max_len 256).
        ("main_ps8", {**main, "ps": 8, "MP": 128}, {}, None, None),
        ("main_MP16", {**main, "MP": 16}, {}, None, None),
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
        # Lanes that share a registered prefix's pages (the prefix cache's block tables):
        # five full pages adopted by every lane and the partial sixth page copied on
        # write into each lane's own page (``shared_prefix_pages``); lane 2 ends inside
        # the copied page.
        ("shared_prefix", main, {}, SHARED_LENS, None),
        ("shared_prefix_int8_bf16", {**main, "quantized": True}, {}, SHARED_LENS, None),
        # The speculative verify's shape (T = k+1 = 4 query rows a lane, 16 rows of the
        # mma): every lane's window straddles a page boundary, and the last lane's ends
        # on a page past its allocation (a sentinel entry whose slots the verify marked
        # valid, as a draft tail past the lane's budget leaves them).
        ("T4_verify", {**main, "T": 4}, {}, VERIFY_LENS, VERIFY_ALLOC),
        ("T4_verify_int8_bf16", {**main, "T": 4, "quantized": True}, {}, VERIFY_LENS,
         VERIFY_ALLOC),
    ]


#: Lane lengths of the T = 4 verify cases: each window [len-4, len) crosses a multiple
#: of 16; the last lane's pages end at slot 96 (``VERIFY_ALLOC``), inside its window.
VERIFY_LENS = [18, 130, 258, 402, 514, 770, 1010, 98]
VERIFY_ALLOC = [18, 130, 258, 402, 514, 770, 1010, 96]


#: Lane lengths of the shared-prefix cases, all past the shared prefix; lane 2 ends
#: inside its copied partial page.
SHARED_LENS = [300, 120, 90, 88, 500, 1024, 95, 200]
SHARED_PREFIX = 87  # slots: 5 full pages of 16 and 7 of the sixth


def shared_prefix_pages(pool, tables, prefix: int, ps: int):
    """Make lanes 1.. share lane 0's prefix as the paged prefix cache lays it out:
    their table entries of the prefix's full pages become lane 0's page ids (adopted,
    read-only), and the prefix's partial page is copied into each lane's own page with
    the engine's ``_copy_page`` (every plane, scale planes included) before the lane's
    own slots past the prefix are written back (copy-on-write). Returns the tables."""
    from accelerate_tpu_torch.serving import _copy_page

    n_full, cut = divmod(prefix, ps)
    tables = tables.clone()
    cache = {"layers": [pool]}
    for b in range(1, tables.shape[0]):
        own = int(tables[b, n_full])
        if own >= pool["k"].shape[0]:
            continue
        tail = {key: t[own, cut:].clone() for key, t in pool.items()}
        _copy_page(cache, int(tables[0, n_full]), own)
        for key, t in pool.items():
            t[own, cut:] = tail[key]
        tables[b, :n_full] = tables[0, :n_full]
    return tables


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
        if name.startswith("shared_prefix"):
            tables = shared_prefix_pages(pool, tables, SHARED_PREFIX, shape["ps"])
        if name.startswith("T4_verify"):
            for b, (n, a) in enumerate(zip(lens, alloc)):
                valid[b, a:n] = True  # slots past the allocation that a write marked valid
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
    # The speculative verify's shape, T = 4 (spec_k = 3), timed the same way.
    v_main = {**main, "T": 4}
    v_sets = [make_paged_inputs(tgen, dev=dev, **v_main) for _ in range(4)]

    def v_kernel(i):
        q, pool, tables, positions, valid, _ = v_sets[i % 4]
        paged_attention(q, pool, tables, positions, valid, **args)

    def v_plain(i):
        q, pool, tables, positions, valid, _ = v_sets[i % 4]
        paged_attention_reference(q, pool, tables, positions, valid, **args)

    v_plain_ms = [device_ms(v_plain, 4, 10)]
    v_kernel_ms = [device_ms(v_kernel, 4, 50), device_ms(v_kernel, 4, 50)]
    v_plain_ms.append(device_ms(v_plain, 4, 10))
    v_bounds = [paged_bound_ms(s[0], s[1], s[5], T=4, ps=main["ps"]) for s in v_sets]
    v_bound = sum(b for b, _ in v_bounds) / len(v_bounds)
    t4 = {"phase": "kernel_time_T4", "shape": {k: str(v) for k, v in v_main.items()},
          "kernel_ms": min(v_kernel_ms), "plain_ms": min(v_plain_ms),
          "kernel_ms_runs": v_kernel_ms, "plain_ms_runs": v_plain_ms,
          "bound_ms": v_bound, "bound_by": v_bounds[0][1],
          "kernel_over_bound": min(v_kernel_ms) / v_bound,
          "route": pa.paged_plan(True, 8, 4, 32, 8, 128, 16, 64, sm_count(dev)).route}
    emit(t4)
    return {"max_abs_err": errors["main"], "kernel_ms": res["kernel_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound_ms, "bound_by": res["bound_by"],
            "t4": t4, "max_abs_err_t4": max(errors["T4_verify"], errors["T4_verify_int8_bf16"])}


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


# --------------------------------------------- phase 3b: the super-step on the card
MULTI_N = 8  # decode steps a super-step of the main paths
MULTI_PROFILE_STEPS = 2  # super-steps in a profiled window
#: Idle seconds at the end of a profiled decode window. The profiler drops a device
#: record whose end, mapped from the card's clock to the host's, falls after the window
#: stops; late in a full run the mapped times ran up to 7.8 ms behind the host's (the
#: last kernel ending after the window's final sync), so the window stops this long
#: after it.
PROFILE_EDGE_S = 0.5


#: A profiled decode window's lead-in: small kernels and an idle before the work it
#: measures, whose device records the window leaves out (they start before half the idle).
PROFILE_LEAD_IN, PROFILE_LEAD_IN_S = 64, 0.1
PROFILE_WINDOW = "chip_smoke.window"


def profiler_lead_in() -> None:
    """The first thing inside a profiled decode window: ``PROFILE_LEAD_IN`` small kernels,
    a synchronize and ``PROFILE_LEAD_IN_S`` idle. Late in a full run (after the fault and
    control phases had built dozens of engines and their graphs) the profiler lost the
    device records of the first ≈ 1 ms of kernels after it started, wherever they fell:
    the first decode step's ≈ 50 records (its host copies, embedding and layer 0's
    q/k/v int8 projections: 3 of 1,120 int8 kernels) after an idle half second, and the
    lead-in plus ≈ 45 of the first step's after one small kernel; CUPTI reported none
    dropped and every later record was there. The lead-in takes that loss."""
    x = torch.ones(1, device="cuda")
    for _ in range(PROFILE_LEAD_IN):
        x.add_(1)
    torch.cuda.synchronize()
    time.sleep(PROFILE_LEAD_IN_S)


def graph_stats(eng) -> dict:
    """Each of ``eng``'s super-step graphs, by (n_steps, sampled, paged): kernel nodes
    (all, paged attention, int8), replays, capture seconds and pool bytes."""
    out = {}
    for (n, sampled, paged), run in eng.graphs.items():
        if not hasattr(run, "nodes"):
            continue
        out[f"n{n}_{'sampled' if sampled else 'greedy'}_{'paged' if paged else 'dense'}"] = {
            "kernel_nodes": run.nodes(),
            "paged_attention_nodes": sum(run.nodes(k) for k in PAGED_KERNELS),
            "int8_matmul_nodes": sum(run.nodes(k) for k in INT8_KERNELS),
            "replays": run.replays, "capture_s": run.capture_s, "pool_bytes": run.pool_bytes}
    return out


def graph_nodes_ok(eng, n_layers: int, int8: bool) -> bool:
    """Every super-step graph of ``eng`` holds exactly n_layers·N paged-attention
    launches (and 7·n_layers·N int8 launches with ``int8``, none without), and ran."""
    stats = graph_stats(eng)
    n = eng.multi_step
    return bool(stats) and all(
        g["paged_attention_nodes"] == n_layers * n
        and g["int8_matmul_nodes"] == (len(INT8_LAYER) * n_layers * n if int8 else 0)
        and g["replays"] > 0 for g in stats.values())


def phase_engine_multistep(dev) -> dict:
    """The ``debug`` fp32 engine on the card with ``decode_steps=4``, dense and paged,
    against the CPU's ``decode_steps=1`` engine on the same seeded requests: greedy
    tokens identical (one request's EOS lands inside a super-step); then, on the card,
    two sampled requests beside greedy ones with ``decode_steps=4`` against
    ``decode_steps=1``: every token identical. Each graph must hold exactly one paged
    attention launch per layer and step when paged, and none when dense."""
    from accelerate_tpu_torch.generation import GenerationConfig
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    params_gpu = params_to(params_cpu, dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in (20, 45, 70, 100, 33)]
    sampled = {1: GenerationConfig(max_new_tokens=21, temperature=0.8, top_k=40, top_p=0.9),
               3: GenerationConfig(max_new_tokens=19, temperature=1.1, top_p=0.8)}

    def serve(params, page_size, n, eos=None, sample=False):
        eng = ContinuousBatcher(params, cfg, max_slots=4, max_len=256, prompt_bucket=32,
                                page_size=page_size, decode_steps=n)
        reqs = []
        for i, p in enumerate(prompts):
            if sample and i in sampled:
                reqs.append(eng.submit(p, gen=sampled[i], seed=50 + i))
            else:
                reqs.append(eng.submit(p, max_new_tokens=22 + i, eos_token_id=eos))
        eng.run()
        pages = eng.stats().get("pages_in_use", 0)
        return [r.tokens for r in reqs], eng, pages

    res = {"phase": "engine_multistep", "config": "debug", "decode_steps": 4, "cases": {}}
    failed = []
    for page_size in (0, 16):
        layout = "paged" if page_size else "dense"
        probe, _, _ = serve(params_cpu, page_size, 1)
        eos = int(probe[2][6])  # emitted mid-stream by request 2: it stops there
        want, _, _ = serve(params_cpu, page_size, 1, eos)
        got, eng, pages = serve(params_gpu, page_size, 4, eos)
        s_one, _, _ = serve(params_gpu, page_size, 1, sample=True)
        s_four, eng_s, pages_s = serve(params_gpu, page_size, 4, sample=True)
        case = {"greedy_equal_cpu_n1": got == want, "eos_early": len(want[2]) < 24,
                "sampled_equal_card_n1": s_four == s_one, "pages_in_use": pages + pages_s,
                "graphs": {**graph_stats(eng), **graph_stats(eng_s)}}
        L = cfg.n_layers if page_size else 0
        case["graph_nodes_ok"] = all(
            g["paged_attention_nodes"] == L * 4 and g["replays"] > 0
            for g in case["graphs"].values()) and len(case["graphs"]) == 2
        case["ok"] = (case["greedy_equal_cpu_n1"] and case["eos_early"]
                      and case["sampled_equal_card_n1"] and case["pages_in_use"] == 0
                      and case["graph_nodes_ok"])
        res["cases"][layout] = case
        if not case["ok"]:
            failed.append(layout)
    res["ok"] = not failed
    emit(res)
    if failed:
        raise PhaseFailed("the super-step on the card disagrees", failed)
    return res


# ------------------------------------------- phase 3c: the admission path on the card
#: The counters ``engine_prefix`` holds equal between the card and the CPU.
ADMISSION_STATS = ("admitted", "evicted", "decode_steps", "prefix_entries", "prefix_hits",
                   "prefix_misses", "prefix_evictions", "prefix_capacity_misses",
                   "prefix_key_misses", "bucket_hits", "bucket_misses")
PAGE_STATS = ("pages_in_use", "pages_free", "kv_shared_pages", "kv_alloc_count",
              "kv_free_count", "kv_cow_count", "kv_adopt_count", "kv_defer_count")


def clear_registry(eng) -> None:
    """Evict every prefix-registry entry (each counted as an eviction)."""
    while eng._evict_prefix_lru():
        pass


def graph_keys(eng) -> set:
    """The keys of every graph ``eng`` holds: super-steps (plain and speculative),
    prefill programs and the drafter's rounds."""
    return (set(eng.graphs) | set(eng.prefill_graphs) | set(eng.spec_graphs)
            | {("draft", k) for k in getattr(eng.drafter, "graphs", {})})


def phase_engine_prefix(dev) -> dict:
    """The admission path on the card against the CPU (``debug``, fp32, same seeded
    params and requests, ``max_slots=4``, ``max_len=256``, ``prompt_bucket=32``): a
    dense and a paged engine with ``prefix_cache=4`` (pages of 24, which cut the
    32-token chunks: copy-on-write; a pool of 16 pages: the registry yields its pages
    under pressure and admissions defer) and a paged engine with ``prompt_buckets``
    (32, 64, 128), each at ``decode_steps=4``. Requests: a 64-token system prompt with
    five suffixes, the system prompt alone (a registered prefix), unrelated prompts,
    one past the top rung. On the card each engine runs ``warm_programs()`` first and
    must capture no graph in traffic. Greedy tokens and every admission, prefix, bucket
    and page counter must equal the CPU's after every step; after the drain and after
    the registry is evicted every page is free."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    params_gpu = params_to(params_cpu, dev)
    rng = np.random.default_rng(12)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))])
               for n in (5, 17, 40, 3, 70)]
    prompts += [system] + [rng.integers(0, cfg.vocab_size, int(n)) for n in (20, 150, 45)]
    budgets = [24, 20, 16, 24, 12, 18, 20, 10, 22]
    engines = {
        "dense_prefix": dict(prefix_cache=4),
        "paged_prefix_cow": dict(prefix_cache=4, page_size=24, kv_pages=16),
        "paged_buckets": dict(prompt_buckets=(32, 64, 128), page_size=16),
    }
    base = dict(max_slots=4, max_len=256, prompt_bucket=32, decode_steps=4)
    res = {"phase": "engine_prefix", "config": "debug", "engine": base, "cases": {}}
    failed = []
    for name, kw in engines.items():
        engs = {side: ContinuousBatcher(params, cfg, **base, **kw)
                for side, params in (("cpu", params_cpu), ("gpu", params_gpu))}
        warm = engs["gpu"].warm_programs(max_new_tokens=24)
        keys_warm = graph_keys(engs["gpu"])
        reqs = {side: [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
                for side, eng in engs.items()}
        keys = ADMISSION_STATS + (PAGE_STATS if "page_size" in kw else ())
        stats_equal, steps, peak_shared = True, 0, 0
        while any(e.queue or any(r is not None for r in e.slot_req) for e in engs.values()):
            for eng in engs.values():
                eng.step()
            sc, sg = engs["cpu"].stats(), engs["gpu"].stats()
            stats_equal &= all(sc[k] == sg[k] for k in keys)
            peak_shared = max(peak_shared, sg.get("kv_shared_pages", 0))
            steps += 1
        s = engs["gpu"].stats()
        case = {"tokens_equal_cpu": [r.tokens for r in reqs["cpu"]]
                == [r.tokens for r in reqs["gpu"]],
                "stats_equal_cpu_every_step": stats_equal, "steps": steps,
                "stats": {k: s[k] for k in keys}, "peak_kv_shared_pages": peak_shared,
                "warm_programs": warm, "graph_keys_warmed": sorted(map(str, keys_warm)),
                "no_graph_captured_in_traffic": graph_keys(engs["gpu"]) == keys_warm,
                "prefill_pool_bytes": engs["gpu"].prefill_pool_bytes,
                "all_done": all(r.done for r in reqs["gpu"])}
        ok = (case["tokens_equal_cpu"] and stats_equal and case["all_done"]
              and case["no_graph_captured_in_traffic"])
        if "prefix_cache" in kw:
            ok &= s["prefix_hits"] > 0 and s["bucket_misses"] == 0
        else:
            ok &= s["bucket_hits"] > 0 and s["bucket_misses"] > 0
        if "page_size" in kw:
            case["pages_free_after_drain"] = s["pages_free"]
            clear_registry(engs["gpu"])
            case["pages_free_after_registry_evicted"] = engs["gpu"].stats()["pages_free"]
            ok &= case["pages_free_after_registry_evicted"] == s["pages_total"]
        if name == "paged_prefix_cow":
            ok &= (s["kv_cow_count"] > 0 and s["prefix_evictions"] > 0
                   and s["kv_defer_count"] > 0 and peak_shared > 0 and s["kv_adopt_count"] > 0)
        case["ok"] = bool(ok)
        res["cases"][name] = case
        if not ok:
            failed.append(name)
    res["ok"] = not failed
    emit(res)
    if failed:
        raise PhaseFailed("the admission path on the card disagrees with the CPU", failed)
    return res


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


def serve_main(params, cfg, dev, reset_counts, decode_steps: int = 1) -> dict:
    """Warm up on a throwaway engine (cuBLAS handles, allocator pools), then serve the
    main workload on a fresh engine (``decode_steps`` tokens per dispatch) with the
    peak-memory statistics and the launch counts (``reset_counts()``) reset just
    before; the drain is timed to its final sync. Returns the engine, requests, stats
    and checks."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    rng, warm_prompt, lengths, workload = main_workload(cfg.vocab_size)
    warm = ContinuousBatcher(params, cfg, decode_steps=decode_steps, **MAIN_ENGINE)
    warm.submit(warm_prompt, max_new_tokens=4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()

    eng = ContinuousBatcher(params, cfg, decode_steps=decode_steps, **MAIN_ENGINE)
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
        "tokens": [list(r.tokens) for r in reqs],
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
        "decode_steps_per_dispatch": s["multi_step"],
        "mean_decode_step_ms": 1e3 * s["decode_s"] / max(s["decode_steps"], 1),
        # A dispatch runs multi_step token steps on the device (frozen lanes included).
        "mean_decode_ms_per_token_step": (1e3 * s["decode_s"]
                                          / max(s["decode_steps"] * s["multi_step"], 1)),
        "mean_dispatch_host_ms": 1e3 * s["dispatch_s"] / max(s["decode_steps"], 1),
        "noise_draw_ms_total": 1e3 * s["noise_s"],
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
    return {"launches": launches, "profile": prof, "tokens": run["tokens"], "params": params,
            "first_logits": run["first_logits"]}


def phase_main_multistep(dev, main: dict) -> dict:
    """``main``'s workload at Llama-3-8B's full width and depth, bf16, paged, with
    ``decode_steps=8``: the super-steps replay CUDA graphs. Every token (greedy and
    sampled) must equal ``main``'s ``decode_steps=1`` run; every request done, no page
    leaked, logits finite; each graph holds exactly 32·8 paged-attention launches, and
    the launches (the wrapper's eager ones plus the graphs' nodes times their replays)
    are 32·8 per super-step. Then a profiled window and the N = 1 and N = 8 engines'
    decode times in alternation (``decode_ab``)."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    params = main["params"]

    def reset_counts():
        paged_attention.launches = 0
        paged_attention.launches_ragged = 0

    run = serve_main(params, cfg, dev, reset_counts, decode_steps=MULTI_N)
    eng, s = run["eng"], run["stats"]
    launches = path_launches(eng)[0]
    expect = cfg.n_layers * MULTI_N * s["decode_steps"]
    differ = [i for i, (a, b) in enumerate(zip(run["tokens"], main["tokens"])) if a != b]
    res = {**_serve_result(run, "main_multistep", None), "paged_attention_launches": launches,
           "paged_attention_launches_expected": expect,
           "paged_attention_launches_ragged": paged_attention.launches_ragged,
           "requests_differing_from_main": differ, "graphs": graph_stats(eng),
           "graph_nodes_ok": graph_nodes_ok(eng, cfg.n_layers, int8=False)}
    res["ok"] = (run["finite"] and run["in_range"] and run["all_done"] and not differ
                 and s["pages_in_use"] == 0 and launches == expect and res["graph_nodes_ok"]
                 and paged_attention.launches_ragged == 0)
    emit(res)
    if not res["ok"]:
        raise SystemExit("the super-step main path failed its checks")
    # Two super-steps (≈ 48,000 kernels): in a window of five (≈ 121,000) the profiler
    # once lost 6 of the 1,280 paged-attention kernel records.
    prof = profile_decode(eng, run["rng"], cfg.vocab_size, steps=MULTI_PROFILE_STEPS)
    emit(prof)
    one_kernel_per_call(prof, int8=False)
    del run, eng
    variants = {"n1": (params, {}), f"n{MULTI_N}": (params, {"decode_steps": MULTI_N})}
    ab = decode_ab(variants, cfg, tokens=2 * MULTI_N)
    emit(ab)
    drains = drain_ab(variants, cfg, main["tokens"])
    emit(drains)
    if not drains["tokens_equal_main"]:
        raise SystemExit("a warm engine's drain differs from main's tokens")
    return {"launches": launches, "profile": prof, "ab": ab, "drains": drains}


def drain_ab(variants: dict, cfg, want_tokens) -> dict:
    """The main workload's first ``max_slots`` requests (one wave: every lane busy from
    the first step; the whole workload's second wave kept the N = 1 drains twice as
    long) drained by warm engines, in alternation (A, B, B, A): one engine per variant
    (``variants[name] = (params, engine keywords)``) captures its graphs with
    ``warm_programs()``, then each drain is timed to its final sync: tokens/s, decode
    and prefill seconds, host seconds drawing sampled noise (on the critical path and
    ahead). Every drain's tokens must equal ``want_tokens``' first ones (a dict: each
    variant's own)."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    workload = main_workload(cfg.vocab_size)[3][:MAIN_ENGINE["max_slots"]]
    engines = {name: ContinuousBatcher(params, cfg, **MAIN_ENGINE, **kw)
               for name, (params, kw) in variants.items()}
    for eng in engines.values():
        eng.warm_programs(max_new_tokens=64)

    def drain(name) -> tuple[dict, bool]:
        eng = engines[name]
        want = want_tokens[name] if isinstance(want_tokens, dict) else want_tokens
        want = want[:len(workload)]
        before = eng.stats()
        reqs = [eng.submit(prompt, **kw) for prompt, kw in workload]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.stats()
        n = sum(len(r.tokens) for r in reqs)
        out = {"wall_s": wall, "tokens_per_s": n / wall,
               **{k: s[k] - before[k] for k in ("decode_steps", "decode_s", "prefill_s",
                                                 "dispatch_s", "noise_s", "noise_ahead_s")}}
        return out, [list(r.tokens) for r in reqs] == want

    equal = True
    a, b = list(variants)
    runs = {a: [], b: []}
    for name in (a, b, b, a):
        r, ok = drain(name)
        runs[name].append(r)
        equal &= ok
    med = {name: float(np.median([r["tokens_per_s"] for r in rs])) for name, rs in runs.items()}
    return {"phase": "drain_ab", "order": f"({a}, {b}, {b}, {a}), warm engines",
            "requests": len(workload), "runs": runs, "tokens_per_s_median": med,
            f"{b}_over_{a}_tokens_per_s": med[b] / med[a], "tokens_equal_main": equal}


# ------------------------------------ phase 4b: graph-replayed prefill, warm-up, prefix
PREFILL_BUCKETS = (128, 256, 512)
#: prefill_ab's prompt lengths: one per rung, and one past the top rung (11 chunks).
PREFILL_AB_LENGTHS = {"bucket_128": 100, "bucket_256": 200, "bucket_512": 450,
                      "chunks_704": 700}


def eager_prefill_engine(*args, **kw):
    """A ``ContinuousBatcher`` whose prefill programs run eagerly on the card (the
    graphs' comparison); its super-steps are still replayed from graphs."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    class EagerPrefill(ContinuousBatcher):
        def _prefill_runner(self, name, width):
            return self._prefill_call(name, width)

    return EagerPrefill(*args, **kw)


def drain_engine(eng, workload, on_first=None) -> dict:
    """Submit ``workload`` ([(prompt, submit kwargs)]) and drain it, timed to the final
    sync: tokens, tokens/s, finite logits, the peak of ``kv_shared_pages`` over the
    steps, and (``on_first``) the seconds to the first request's first token."""
    first_at = []
    reqs = []
    for i, (prompt, kw) in enumerate(workload):
        hook = (lambda _tok: first_at.append(time.perf_counter())) if i == 0 else None
        reqs.append(eng.submit(prompt, on_token=hook, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finite, peak_shared, first_logits = True, 0, None
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        if eng.last_logits is not None:
            finite &= bool(torch.isfinite(eng.last_logits).all())
            if first_logits is None:
                first_logits = eng.last_logits.clone()
        peak_shared = max(peak_shared, eng.stats().get("kv_shared_pages", 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sum(len(r.tokens) for r in reqs)
    return {"tokens": [list(r.tokens) for r in reqs], "wall_s": wall, "n_tokens": n,
            "tokens_per_s": n / wall, "finite": finite, "peak_kv_shared_pages": peak_shared,
            "first_token_s": first_at[0] - t0 if first_at else None,
            "all_done": all(r.done for r in reqs), "first_logits": first_logits}


def admission_ms(eng, prompt) -> float:
    """Host ms of one admission (prefill, row insert, first-token read) of a request
    with ``max_new_tokens=1``, which finishes at admission: ``stats()``'s prefill
    seconds over one ``step()``."""
    before = eng.prefill_s
    eng.submit(prompt, max_new_tokens=1)
    eng.step()
    return 1e3 * (eng.prefill_s - before)


def alternated(runs: dict, order, fn) -> dict:
    """``fn(name)`` for each name of ``order`` in turn → {name: [results]}."""
    for name in order:
        runs[name].append(fn(name))
    return runs


def warm_summary(entries) -> dict:
    return {"programs": len(entries),
            "capture_s": sum(e["capture_s"] or 0.0 for e in entries),
            "pool_bytes": sum(e["pool_bytes"] or 0 for e in entries), "entries": entries}


def graph_device_profile(run, replays: int = 5) -> dict:
    """Where a captured program's device time goes: its graph replayed ``replays``
    times back to back between CUDA events (device ms a replay, no host work), then
    under ``torch.profiler``: device ms a replay by kernel group (cuBLAS products, the
    rest) and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    ms = _events_ms(lambda _: run.graph.replay(), replays)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            run.graph.replay()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0) + e.self_device_time_total / 1e3 / replays
    cublas = sum(v for k, v in kernels.items()
                 if any(n in k for n in ("nvjet", "gemm", "cutlass", "sm90_xmma")))
    attn = sum(v for k, v in kernels.items() if "paged_attention" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"device_ms": ms, "kernel_nodes": run.nodes(),
            "profiled_busy_ms": sum(kernels.values()) if kernels else None,
            "cublas_ms": cublas if kernels else None,
            "paged_attention_ms": attn if kernels else None,
            "other_ms": sum(kernels.values()) - cublas - attn if kernels else None,
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def phase_main_prefill(dev, main: dict) -> dict:
    """The main workload at Llama-3-8B's full width and depth (bf16, paged) with
    ``prompt_buckets=(128, 256, 512)`` and ``decode_steps=8``, after ``warm_programs()``:
    no graph may be captured in traffic; every token must equal the same engine's with
    its prefill programs run eagerly; kernel #1's launches must be exactly 32·8 a
    super-step (graph nodes times replays; no prefill graph holds one). Then
    ``prefill_ab``: ms per admission, graph against eager, alternated, per rung and for
    a prompt past the top rung (the chunk pair); and fresh engines draining the
    workload without and with ``warm_programs()`` (alternated): tokens/s, the first
    request's time to first token, warm-up seconds and pool bytes."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    params = main["params"]
    kw = dict(**MAIN_ENGINE, prompt_buckets=PREFILL_BUCKETS, decode_steps=MULTI_N)
    workload = main_workload(cfg.vocab_size)[3]

    eng = ContinuousBatcher(params, cfg, **kw)
    t0 = time.perf_counter()
    warm = warm_summary(eng.warm_programs(max_new_tokens=64))
    torch.cuda.synchronize()
    warm["wall_s"] = time.perf_counter() - t0
    keys_warm = graph_keys(eng)
    paged_attention.launches = 0
    paged_attention.launches_ragged = 0
    torch.cuda.reset_peak_memory_stats()
    run = drain_engine(eng, workload)
    s = eng.stats()
    launches = path_launches(eng)[0]
    expect = cfg.n_layers * MULTI_N * s["decode_steps"]
    prefill_graphs = [r for r in eng.prefill_graphs.values() if hasattr(r, "nodes")]
    prefill_paged_nodes = sum(r.nodes(k) for r in prefill_graphs for k in PAGED_KERNELS)
    eager = eager_prefill_engine(params, cfg, **kw)
    eager_run = drain_engine(eager, workload)
    res = {"phase": "main_prefill", "config": "llama3-8b", "dtype": "bfloat16",
           "engine": {**kw, "prompt_buckets": list(PREFILL_BUCKETS)},
           "requests": len(workload), "warm_programs": warm,
           "no_graph_captured_in_traffic": graph_keys(eng) == keys_warm,
           "tokens_equal_eager_prefill": run["tokens"] == eager_run["tokens"],
           "tokens_per_s": run["tokens_per_s"], "wall_s": run["wall_s"],
           "eager_prefill_tokens_per_s": eager_run["tokens_per_s"],
           "prefill_ms_per_request": 1e3 * s["prefill_s"] / len(workload),
           "eager_prefill_ms_per_request": 1e3 * eager.stats()["prefill_s"] / len(workload),
           "bucket_hits": s["bucket_hits"], "bucket_misses": s["bucket_misses"],
           "decode_steps": s["decode_steps"], "paged_attention_launches": launches,
           "paged_attention_launches_expected": expect,
           "paged_attention_launches_ragged": paged_attention.launches_ragged,
           "prefill_graph_paged_attention_nodes": prefill_paged_nodes,
           "prefill_graph_kernel_nodes": {f"{k[0]}_{k[1]}": r.nodes()
                                          for k, r in eng.prefill_graphs.items()
                                          if hasattr(r, "nodes")},
           "prefill_pool_bytes": eng.prefill_pool_bytes,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "finite_logits": run["finite"], "all_done": run["all_done"],
           "pages_in_use_after": s["pages_in_use"]}
    res["ok"] = (res["no_graph_captured_in_traffic"] and res["tokens_equal_eager_prefill"]
                 and launches == expect and prefill_paged_nodes == 0
                 and paged_attention.launches_ragged == 0 and run["finite"]
                 and run["all_done"] and s["pages_in_use"] == 0)
    emit(res)
    if not res["ok"]:
        raise SystemExit("the graph-replayed prefill main path failed its checks")

    # prefill_ab: the warm graph engine against the eager one, (graph, eager, eager,
    # graph) twice per prompt.
    rng = np.random.default_rng(14)
    ab = {"phase": "prefill_ab", "order": "(graph, eager, eager, graph) x 2",
          "note": "host ms per admission of a max_new_tokens=1 request: prefill, row "
                  "insert and the first token's host read", "cases": {}}
    engines = {"graph": eng, "eager": eager}
    for case, n in PREFILL_AB_LENGTHS.items():
        prompt = rng.integers(0, cfg.vocab_size, n)
        runs = alternated({"graph": [], "eager": []}, ("graph", "eager", "eager", "graph") * 2,
                          lambda name: admission_ms(engines[name], prompt))
        med = {name: float(np.median(r)) for name, r in runs.items()}
        ab["cases"][case] = {"prompt_len": n, "ms_runs": runs, "ms_median": med,
                             "eager_over_graph": med["eager"] / med["graph"]}
    ab["no_graph_captured"] = graph_keys(eng) == keys_warm
    # The same programs' device time alone: what the graph leaves of an admission's ms
    # is host work (input copies, the row scatter, the first token's read).
    ab["graph_device"] = {f"{k[0]}_{k[1]}": graph_device_profile(r)
                          for k, r in eng.prefill_graphs.items()}
    emit(ab)
    del eager
    gc.collect()

    # Fresh engines, each draining the workload once: without warm-up the first
    # admissions and super-steps capture their graphs in traffic.
    def fresh(name):
        e = ContinuousBatcher(params, cfg, **kw)
        out = {}
        if name == "warm":
            t = time.perf_counter()
            out["warm_programs"] = warm_summary(e.warm_programs(max_new_tokens=64))
            torch.cuda.synchronize()
            out["warm_programs"]["wall_s"] = time.perf_counter() - t
            out["warm_programs"].pop("entries")
        keys0 = graph_keys(e)
        r = drain_engine(e, workload)
        out.update({k: r[k] for k in ("tokens_per_s", "wall_s", "first_token_s")})
        out["tokens_equal"] = r["tokens"] == run["tokens"]
        out["graphs_captured_in_traffic"] = len(graph_keys(e) - keys0)
        del e
        gc.collect()
        return out

    runs = alternated({"cold": [], "warm": []}, ("cold", "warm", "warm", "cold"), fresh)
    drains = {"phase": "fresh_drain_ab", "order": "(cold, warm, warm, cold), fresh engines",
              "runs": runs,
              "tokens_per_s_median": {k: float(np.median([r["tokens_per_s"] for r in v]))
                                      for k, v in runs.items()},
              "first_token_s_median": {k: float(np.median([r["first_token_s"] for r in v]))
                                       for k, v in runs.items()},
              "tokens_equal": all(r["tokens_equal"] for v in runs.values() for r in v)}
    emit(drains)
    if not (ab["no_graph_captured"] and drains["tokens_equal"]
            and all(r["graphs_captured_in_traffic"] == 0 for r in runs["warm"])):
        raise SystemExit("prefill_ab or the fresh-engine drains failed their checks")
    return {"launches": launches, "ab": ab, "drains": drains, "warm": warm,
            "prefill_ms_per_request": res["prefill_ms_per_request"]}


PREFIX_ENGINE = dict(max_slots=8, max_len=1024, prompt_bucket=64, page_size=16,
                     prefix_cache=8, decode_steps=MULTI_N)


def prefix_workload(vocab: int):
    """A chat deployment with a fixed system prompt: 16 seeded requests, each a
    384-token system prompt and its own suffix of 16–160 tokens, 64 new tokens each,
    greedy → (system prompt, [(prompt, submit kwargs)])."""
    rng = np.random.default_rng(13)
    system = rng.integers(0, vocab, 384)
    return system, [(np.concatenate([system, rng.integers(0, vocab, int(n))]),
                     dict(max_new_tokens=64)) for n in rng.integers(16, 161, 16)]


def phase_main_prefix(dev, main: dict) -> dict:
    """The shared-system-prompt workload (``prefix_workload``) at Llama-3-8B's full
    width and depth, bf16, paged (``PREFIX_ENGINE``: pages of 16, ``prefix_cache=8``,
    ``decode_steps=8``), after ``warm_programs()``: every request done, no graph
    captured in traffic, kernel #1's launches exactly 32·8 a super-step (its block
    tables now share the prefix's pages); each request's tokens must equal those of the
    same request served by the same engine with the registry cleared before it (all
    misses: the hit gathers the same bytes and runs the same chunk programs). Reported:
    hits, shared pages, COW copies, peak memory, host ms per admission on a hit against
    a miss (alternated) and the drain's tokens/s beside a ``prefix_cache=0`` engine's
    (alternated, the registry cleared before each prefix drain)."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    params = main["params"]
    system, workload = prefix_workload(cfg.vocab_size)
    eng = ContinuousBatcher(params, cfg, **PREFIX_ENGINE)
    warm = warm_summary(eng.warm_programs(max_new_tokens=64))
    keys_warm = graph_keys(eng)
    paged_attention.launches = 0
    paged_attention.launches_ragged = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    hit = drain_engine(eng, workload)
    peak = torch.cuda.max_memory_allocated()
    s = eng.stats()
    launches = path_launches(eng)[0]
    expect = cfg.n_layers * MULTI_N * s["decode_steps"]
    miss_tokens = []
    for prompt, kw in workload:
        clear_registry(eng)
        req = eng.submit(prompt, **kw)
        eng.run()
        miss_tokens.append(list(req.tokens))
    differ = [i for i, (a, b) in enumerate(zip(hit["tokens"], miss_tokens)) if a != b]
    res = {"phase": "main_prefix", "config": "llama3-8b", "dtype": "bfloat16",
           "engine": PREFIX_ENGINE, "requests": len(workload), "system_prompt_len": 384,
           "prompt_lengths": [len(p) for p, _ in workload], "max_new_tokens": 64,
           "warm_programs": warm,
           "no_graph_captured_in_traffic": graph_keys(eng) == keys_warm,
           "tokens_per_s": hit["tokens_per_s"], "wall_s": hit["wall_s"],
           "prefill_ms_per_request": 1e3 * s["prefill_s"] / len(workload),
           **{k: s[k] for k in ADMISSION_STATS + PAGE_STATS},
           "peak_kv_shared_pages": hit["peak_kv_shared_pages"],
           "requests_differing_from_all_miss": differ,
           "paged_attention_launches": launches, "paged_attention_launches_expected": expect,
           "paged_attention_launches_ragged": paged_attention.launches_ragged,
           "max_memory_allocated_bytes": peak,
           "memory_allocated_at_start_bytes": allocated_at_start,
           "finite_logits": hit["finite"], "all_done": hit["all_done"]}
    res["ok"] = (not differ and res["no_graph_captured_in_traffic"] and launches == expect
                 and paged_attention.launches_ragged == 0 and hit["finite"]
                 and hit["all_done"] and s["prefix_hits"] == len(workload) - 1
                 and hit["peak_kv_shared_pages"] > 0)
    emit(res)
    if not res["ok"]:
        raise SystemExit("the prefix-cache main path failed its checks")

    # Admission on a hit against a miss, (hit, miss, miss, hit) twice; the probe's own
    # miss admission registers the system prompt again for the next hit.
    probe = np.concatenate([system, np.random.default_rng(15).integers(0, cfg.vocab_size, 100)])
    hits0 = eng.prefix_hits

    def admit(name):
        if name == "miss":
            clear_registry(eng)
        return admission_ms(eng, probe)

    runs = alternated({"hit": [], "miss": []}, ("hit", "miss", "miss", "hit") * 2, admit)
    med = {k: float(np.median(v)) for k, v in runs.items()}
    ab = {"phase": "prefix_ab", "order": "(hit, miss, miss, hit) x 2",
          "prompt_len": len(probe), "ms_runs": runs, "ms_median": med,
          "miss_over_hit": med["miss"] / med["hit"], "hits": eng.prefix_hits - hits0}
    base = ContinuousBatcher(params, cfg, **{**PREFIX_ENGINE, "prefix_cache": 0})
    base.warm_programs(max_new_tokens=64)

    def drain(name):
        if name == "prefix_cache_8":
            clear_registry(eng)
        r = drain_engine(eng if name == "prefix_cache_8" else base, workload)
        return {k: r[k] for k in ("tokens_per_s", "wall_s", "first_token_s")}

    drains = alternated({"prefix_cache_8": [], "prefix_cache_0": []},
                        ("prefix_cache_8", "prefix_cache_0", "prefix_cache_0",
                         "prefix_cache_8"), drain)
    ab["drains"] = drains
    ab["drain_order"] = "(prefix_cache_8, prefix_cache_0, prefix_cache_0, prefix_cache_8), warm engines"
    ab["drain_tokens_per_s_median"] = {k: float(np.median([r["tokens_per_s"] for r in v]))
                                       for k, v in drains.items()}
    emit(ab)
    if ab["hits"] != 4:
        raise SystemExit("prefix_ab's hit admissions did not hit")
    del base
    return {"launches": launches, "ab": ab, "tokens_per_s": hit["tokens_per_s"]}


# ------------------------------------------------ phase 4c: speculative serving
SPEC_K = 3
#: The counters ``engine_spec`` holds equal between the card and the CPU after every step.
SPEC_STATS = ("spec_k", "spec_proposed", "spec_accepted", "spec_accept_rate", "spec_enabled",
              "decode_steps", "decode_tokens", "admitted", "evicted")
#: Near-tie check of ``main_spec``: at a first divergence from the spec_k=0 engine, the
#: plain engine's logits row and the speculative verify's row for that emission may
#: differ by at most this (logits of order 1–10, bf16-valued: a few bf16 steps), and the
#: plain row's top-two gap (of the filtered logits plus the emission's noise, over the
#: temperature's scale, for sampled lanes) must be below twice that difference — the
#: condition under which the two rows' argmaxes can differ at all — or, for a sampled
#: lane, the two rows' top-k/top-p supports must differ at one engine's token.
DELTA_MAX = 0.25


def spec_workload(vocab: int):
    """``engine_spec``'s seeded requests: 6 prompts of 20–100 tokens, three of them
    sharing a 64-token system prompt (prefix hits), greedy and sampled (temperature +
    top-k, nucleus), budgets that do not end on a round → [(prompt, submit kwargs)]."""
    from accelerate_tpu_torch.generation import GenerationConfig

    rng = np.random.default_rng(21)
    system = rng.integers(0, vocab, 64)
    prompts = [np.concatenate([system, rng.integers(0, vocab, int(n))]) for n in (7, 20, 33)]
    prompts += [rng.integers(0, vocab, int(n)) for n in (20, 100, 45)]
    gens = {1: GenerationConfig(max_new_tokens=21, temperature=0.8, top_k=40),
            4: GenerationConfig(max_new_tokens=19, temperature=1.1, top_p=0.8)}
    return [(p, dict(gen=gens[i], seed=60 + i) if i in gens else
             dict(max_new_tokens=(22, None, 18, 23, None, 14)[i])) for i, p in enumerate(prompts)]


def _spec_serve(eng, workload, script_eos=None, toggle=True):
    """Submit ``workload`` (greedy requests take ``script_eos``) and drain it, turning
    speculation off after 3 steps and on after 2 more (``toggle``) → (requests,
    per-step stats)."""
    reqs = []
    for p, kw in workload:
        if "gen" not in kw and script_eos is not None:
            kw = dict(kw, eos_token_id=script_eos)
        reqs.append(eng.submit(p, **kw))
    steps = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        if toggle and len(steps) in (3, 5):
            eng.set_spec_enabled(len(steps) == 5)
        eng.step()
        s = eng.stats()
        steps.append({k: s[k] for k in SPEC_STATS})
    return reqs, steps


def phase_engine_spec(dev) -> dict:
    """Speculative serving on the card against the CPU (``debug``, fp32, same seeded
    params and requests, ``max_slots=4``, ``max_len=256``, ``prompt_bucket=32``,
    ``spec_k=3``): n-gram host loop and fused super-step (``decode_steps=4``), dense and
    paged (pages of 8); a ModelDrafter over the target's own params (the perfect
    drafter) and one of a 1-layer draft; ``spec_accept="residual"``; ``prefix_cache=4``
    (paged, fused); an int8 paged fused engine (kernel #10 at M = B·(k+1)). Workload:
    staggered greedy and sampled requests, an EOS mid-stream, budgets that end inside
    a round, speculation switched off mid-drain and on again. Checks: tokens and every
    ``spec_*`` counter equal the CPU engine's after every step; on the card, tokens equal
    the ``spec_k=0`` engine's (greedy and replay-sampled; a residual engine's greedy
    lanes); the perfect drafter's greedy accept rate is 1.0 (budgets of whole rounds);
    every page free at the end."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to
    from accelerate_tpu_torch.ops import quantization as qz
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.spec_decode import ModelDrafter

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    d_cfg = dataclasses.replace(cfg, n_layers=1)
    draft_cpu = llama.init_params(d_cfg, generator=torch.Generator().manual_seed(1),
                                  device="cpu")
    int8_cpu = qz.load_and_quantize_model(params_cpu, qz.BnbQuantizationConfig(
        skip_modules=["embed", "lm_head"], min_weight_size=1, load_in_8bit=True))
    sides = {"cpu": (params_cpu, draft_cpu, int8_cpu),
             "gpu": tuple(params_to(p, dev) for p in (params_cpu, draft_cpu, int8_cpu))}
    workload = spec_workload(cfg.vocab_size)
    # The perfect drafter's workload: greedy, budgets of 1 + whole rounds, no switch.
    whole = [(p, dict(max_new_tokens=1 + (SPEC_K + 1) * m))
             for (p, _), m in zip(workload, (2, 5, 3, 4, 1, 6))]
    base = dict(max_slots=4, max_len=256, prompt_bucket=32, spec_k=SPEC_K)
    engines = {  # name -> (engine keywords, drafter, params index)
        "host_dense": ({}, None, 0), "host_paged": ({"page_size": 8}, None, 0),
        "fused_dense": ({"decode_steps": 4}, None, 0),
        "fused_paged": ({"decode_steps": 4, "page_size": 8}, None, 0),
        "draft_perfect": ({}, "perfect", 0), "draft_1layer": ({"page_size": 8}, "1layer", 0),
        "residual": ({"spec_accept": "residual"}, None, 0),
        "prefix_fused_paged": ({"prefix_cache": 4, "page_size": 8, "decode_steps": 4}, None, 0),
        "int8_fused_paged": ({"decode_steps": 4, "page_size": 8}, None, 2),
    }
    probe = ContinuousBatcher(params_cpu, cfg, **base)
    probe_reqs, _ = _spec_serve(probe, workload, toggle=False)
    eos = int(probe_reqs[2].tokens[6])  # request 2 (greedy) emits it mid-stream
    res = {"phase": "engine_spec", "config": "debug", "engine": base, "eos": eos, "cases": {}}
    failed = []
    for name, (kw, drafter, pi) in engines.items():
        wl, eos_id, toggle = ((whole, None, False) if drafter == "perfect"
                              else (workload, eos, True))
        run = {}
        for side, params in sides.items():
            d = None
            if drafter == "perfect":
                d = ModelDrafter(params[0], cfg)
            elif drafter == "1layer":
                d = ModelDrafter(params[1], d_cfg)
            eng = ContinuousBatcher(params[pi], cfg, **base, **kw, drafter=d)
            reqs, steps = _spec_serve(eng, wl, eos_id, toggle)
            if kw.get("prefix_cache"):
                clear_registry(eng)
            run[side] = (eng, [list(r.tokens) for r in reqs], steps)
        eng, tokens, steps = run["gpu"]
        plain = ContinuousBatcher(sides["gpu"][pi], cfg, **{**base, **kw, "spec_k": 0,
                                                            "spec_accept": "replay"})
        plain_tokens = [list(r.tokens) for r in _spec_serve(plain, wl, eos_id, False)[0]]
        check = [i for i, (p, k) in enumerate(wl)
                 if kw.get("spec_accept") != "residual" or "gen" not in k]
        s = eng.stats()
        case = {"tokens_equal_cpu": tokens == run["cpu"][1],
                "spec_stats_equal_cpu_every_step": steps == run["cpu"][2],
                "tokens_equal_spec_k0": all(tokens[i] == plain_tokens[i] for i in check),
                "requests_checked_against_spec_k0": check,
                "fused": eng._spec_fused(), "steps": len(steps),
                "stats": {k: s[k] for k in SPEC_STATS + ("tokens_per_step",)},
                "pages_in_use_after": s.get("pages_in_use", 0),
                "eos_stopped_early": drafter == "perfect" or len(tokens[2]) < 18,
                "all_done": all(len(t) > 0 for t in tokens)}
        ok = (case["tokens_equal_cpu"] and case["spec_stats_equal_cpu_every_step"]
              and case["tokens_equal_spec_k0"] and case["pages_in_use_after"] == 0
              and case["eos_stopped_early"] and s["spec_proposed"] > 0)
        if drafter == "perfect":
            case["greedy_accept_rate"] = s["spec_accept_rate"]
            ok &= s["spec_accept_rate"] == 1.0
        if name.startswith("int8"):
            case["int8_matmul_graph_launches"] = replayed_launches(
                list(eng.spec_graphs.values()), INT8_KERNELS)
            ok &= case["int8_matmul_graph_launches"] > 0
        ok &= case["fused"] == ("decode_steps" in kw and kw.get("spec_accept") != "residual")
        case["ok"] = bool(ok)
        res["cases"][name] = case
        if not ok:
            failed.append(name)
    res["ok"] = not failed
    emit(res)
    if failed:
        raise PhaseFailed("speculative serving on the card disagrees", failed)
    return res


# ------------------------------------ phase 3e: disaggregated serving on the card
#: The counters ``engine_disagg`` holds equal between the card and the CPU after every
#: router step: the router's, and each replica engine's.
DISAGG_ROUTER_STATS = ("submitted", "admitted", "done", "handoffs", "handoff_defers",
                       "readopted", "migrated", "replica_kills", "replica_restarts",
                       "replayed", "cancelled", "failed")
DISAGG_ENGINE_STATS = ("admitted", "evicted", "decode_steps", "decode_tokens",
                       "handoffs_exported", "handoffs_adopted", "handoffs_pending",
                       "spec_proposed", "spec_accepted", "pages_in_use", "kv_alloc_count",
                       "kv_free_count", "kv_cow_count", "kv_adopt_count", "kv_defer_count")


def disagg_workload(vocab: int):
    """``engine_disagg``'s seeded requests: 6 prompts of 9–100 tokens (one ending on a
    page, the rest cutting one: COW), budgets of 14–24, requests 1 and 4 sampled →
    [(prompt, submit kwargs)]."""
    from accelerate_tpu_torch.generation import GenerationConfig

    rng = np.random.default_rng(14)
    lengths = (20, 45, 70, 100, 33, 9)
    gens = {1: GenerationConfig(max_new_tokens=21, temperature=0.8, top_k=40, top_p=0.9),
            4: GenerationConfig(max_new_tokens=17, temperature=1.1, top_p=0.8)}
    return [(rng.integers(0, vocab, n), dict(gen=gens[i], seed=70 + i) if i in gens else
             dict(max_new_tokens=(14, None, 24, 19, None, 16)[i]))
            for i, n in enumerate(lengths)]


class _EngineLaunches:
    """Per-engine launch counts of kernels #1 and #10: each wrapper's count moved by
    the engine's ``step()`` (its eager launches, a graph's eager first call included),
    plus its graphs' kernel nodes times their replays (``replayed_launches``)."""

    def __init__(self):
        self.eager = {}  # id(engine) → [paged attention, int8 matmul]

    def watch(self, eng):
        from accelerate_tpu_torch.ops.paged_attention import paged_attention
        from accelerate_tpu_torch.ops.quantization import int8_matmul

        counts = self.eager.setdefault(id(eng), [0, 0])
        step = eng.step

        def counted_step():
            pa, i8 = paged_attention.launches, int8_matmul.launches
            try:
                return step()
            finally:
                counts[0] += paged_attention.launches - pa
                counts[1] += int8_matmul.launches - i8

        eng.step = counted_step
        return eng

    def __call__(self, eng) -> tuple[int, int]:
        graphs = (list(eng.graphs.values()) + list(eng.prefill_graphs.values())
                  + list(eng.spec_graphs.values())
                  + list(getattr(eng.drafter, "graphs", {}).values()))
        pa, i8 = self.eager.get(id(eng), (0, 0))
        return (pa + replayed_launches(graphs, PAGED_KERNELS),
                i8 + replayed_launches(graphs, INT8_KERNELS))


def expected_paged_launches(eng, n_layers: int, draft_layers: int = 0) -> int:
    """Kernel #1's launches an engine's decode dispatches make: one per layer per
    token step (N per super-step, one verify per speculative round), plus a model
    drafter's k+1 one-token steps per host-loop round; none for a prefill engine (its
    prefill attends through the dense einsum)."""
    if eng.role == "prefill":
        return 0
    per_dispatch = n_layers * eng.multi_step
    if eng.spec_k and not eng._spec_fused() and draft_layers:
        per_dispatch += draft_layers * (eng.spec_k + 1)
    return per_dispatch * eng.decode_steps


def serve_disagg(params, cfg, workload, roles, engine_kw=None, watch=None, kill=None,
                 factory=False, geometry=None, **router_kw) -> dict:
    """``workload`` through a ``DisaggRouter`` over one engine per role (``engine_kw``:
    {role or replica id: engine keywords}, a replica id's winning; each value may be a
    function of the params giving them), ``geometry`` (default ``DISAGG_ENGINE``) for
    every engine; streams captured with ``on_retry`` resets; ``kill=(rid, step)`` kills a replica
    after that many router steps; ``factory`` gives the router a restart factory →
    tokens, streams, per-step counters, every engine built by role, the router."""
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.serving_gateway import DisaggRouter
    from accelerate_tpu_torch.utils.dataclasses import GatewayConfig

    engine_kw = engine_kw or {}
    built = []

    def build(rid, role):
        kw = engine_kw.get(rid, engine_kw.get(role, {}))
        kw = kw(params) if callable(kw) else kw
        eng = ContinuousBatcher(params, cfg, role=role, **{**(geometry or DISAGG_ENGINE), **kw})
        built.append((rid, eng))
        return watch.watch(eng) if watch is not None else eng

    engines = [build(rid, role) for rid, role in enumerate(roles)]
    router = DisaggRouter(engines, GatewayConfig(enabled=True, **router_kw), roles=list(roles),
                          engine_factory=build if factory else None)
    streams = {i: [] for i in range(len(workload))}
    greqs = [router.submit(p, on_token=streams[i].append, on_retry=streams[i].clear, **kw)
             for i, (p, kw) in enumerate(workload)]
    steps = []
    while router.queue_depth or router.running_count:
        if kill is not None and len(steps) == kill[1]:
            router.kill(kill[0])
        router.step()
        snap = {k: router.counters[k] for k in DISAGG_ROUTER_STATS}
        for rep in router.replicas:
            s = rep.engine.stats()
            snap[rep.rid] = {k: s.get(k) for k in DISAGG_ENGINE_STATS}
        steps.append(snap)
        if len(steps) > 2000:
            raise SystemExit("disaggregated router stalled")
    return {"tokens": [[int(t) for t in g.tokens] for g in greqs],
            "streams": [[int(t) for t in streams[i]] for i in range(len(workload))],
            "status": [g.status for g in greqs], "steps": steps, "built": built,
            "router": router}


DISAGG_ENGINE = dict(max_slots=4, max_len=256, prompt_bucket=32, page_size=8)


def phase_engine_disagg(dev) -> dict:
    """Disaggregated serving on the card against the CPU (``debug``, fp32, pages of 8,
    ``max_slots=4``, ``max_len=256``, ``prompt_bucket=32``): each case a
    ``DisaggRouter`` over the same seeded params and requests on both sides — 1P:1D;
    the decode replica at ``decode_steps=4``; with ``spec_k=2`` (n-gram); with a
    ModelDrafter over the target's params; P:D:mixed; a prefill pool sized for context
    pages only; a decode pool small enough to defer adoptions; int8 projections on both
    replicas (kernel #10); int8 KV pools (the scale planes travel with the block);
    ``kill(1)`` on a P:D:D fleet and ``kill(0)`` with a restart factory. Checks: every
    request's tokens (and its stream) equal a mixed engine's on the same device; the
    card's tokens equal the CPU's and every router and replica counter equals the
    CPU's after every router step; every pool drains to ``pages_in_use == 0``; on the
    card kernel #1's launches on each decode-capable replica equal one per layer per
    token step (plus the drafter's rounds) and are 0 on each prefill replica."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to
    from accelerate_tpu_torch.ops import quantization as qz
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.spec_decode import ModelDrafter

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    kv_cfg = dataclasses.replace(cfg, kv_quant=True)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    int8_cpu = qz.load_and_quantize_model(params_cpu, qz.BnbQuantizationConfig(
        skip_modules=["embed", "lm_head"], min_weight_size=1, load_in_8bit=True))
    sides = {"cpu": (params_cpu, int8_cpu),
             "gpu": (params_to(params_cpu, dev), params_to(int8_cpu, dev))}
    workloads = {"default": disagg_workload(cfg.vocab_size)}
    # Greedy, decode budgets that end on a speculative round (k = 2: no round is cut to
    # one token), so a perfect drafter's every proposal is emitted.
    workloads["greedy_rounds"] = [(p, dict(max_new_tokens=b)) for (p, _), b in
                                  zip(workloads["default"], (15, 21, 24, 19, 16, 18))]
    pd, pdd = ("prefill", "decode"), ("prefill", "decode", "decode")
    L = cfg.n_layers
    # name -> (roles, engine keywords by role, params index, cfg, router keywords,
    #          extras: "geometry" of every engine, "mixed" keywords of the baseline,
    #          "workload")
    cases = {
        "1p1d": (pd, {}, 0, cfg, {}, {}),
        "1p1d_decode_steps4": (pd, {"decode": {"decode_steps": 4}}, 0, cfg, {}, {}),
        "1p1d_spec_ngram": (pd, {"decode": {"spec_k": 2}}, 0, cfg, {}, {}),
        "1p1d_spec_model_drafter": (pd, {"decode": lambda p: {
            "spec_k": 2, "drafter": ModelDrafter(p, cfg)}}, 0, cfg, {},
            {"workload": "greedy_rounds"}),
        "p_d_mixed": (("prefill", "decode", "mixed"), {}, 0, cfg, {}, {}),
        # 16 pages: the 100-token prompt's 4 chunks (128 slots) with its budget need 19
        # on a mixed engine; its context alone fits.
        "prefill_pool_context_only": (pd, {"prefill": {"kv_pages": 16}}, 0, cfg, {}, {}),
        # 20 pages: the largest adoption (16 imported + 3 own) fits, two rarely do.
        "decode_pool_defers": (pd, {"decode": {"kv_pages": 20}}, 0, cfg, {}, {}),
        # Pages of 12 cut the 32-token chunks: every handoff's boundary page is copied on
        # write; the prefix layout ends the context on the prompt's own length.
        "pages_of_12_cow": (pd, {}, 0, cfg, {}, {"geometry": {"page_size": 12}}),
        "prefix_prefill_cow": (pd, {"prefill": {"prefix_cache": 4}}, 0, cfg, {},
                               {"mixed": {"prefix_cache": 4}}),
        "int8_projections": (pd, {}, 1, cfg, {}, {}),
        "int8_kv_pools": (pd, {}, 0, kv_cfg, {}, {}),
        "kill_decode_pdd": (pdd, {}, 0, cfg, {"kill": (1, 3), "factory": False}, {}),
        # Killed after 2 steps: its last two exports wait in handoff limbo (the decode
        # replica's 4 lanes are busy) and die with its pool: they prefill again.
        "kill_prefill_factory": (pd, {}, 0, cfg, {"kill": (0, 2), "factory": True,
                                                  "replica_restarts": 2}, {}),
    }
    mixed = {}  # (side, params index, kv, baseline keywords, workload) -> tokens, pages
    res = {"phase": "engine_disagg", "config": "debug", "engine": DISAGG_ENGINE, "cases": {}}
    failed = []
    for name, (roles, ekw, pi, c, rkw, extra) in cases.items():
        geometry = {**DISAGG_ENGINE, **extra.get("geometry", {})}
        workload = workloads[extra.get("workload", "default")]
        mixed_kw = {**geometry, **extra.get("mixed", {})}
        run = {}
        watch = _EngineLaunches()
        for side, params in sides.items():
            key = (side, pi, c.kv_quant, tuple(sorted(mixed_kw.items())),
                   extra.get("workload", "default"))
            if key not in mixed:
                eng = ContinuousBatcher(params[pi], c, **mixed_kw)
                reqs = [eng.submit(p, **kw) for p, kw in workload]
                eng.run()
                clear_registry(eng)
                mixed[key] = ([[int(t) for t in r.tokens] for r in reqs],
                              eng.stats()["pages_in_use"])
            run[side] = serve_disagg(params[pi], c, workload, roles, ekw,
                                     watch if side == "gpu" else None, geometry=geometry,
                                     **rkw)
        gpu, cpu = run["gpu"], run["cpu"]
        want, mixed_pages = mixed[key]
        router = gpu["router"]
        for rep in router.replicas:  # a prefix registry holds pages until evicted
            clear_registry(rep.engine)
        live = [rep.engine for rep in router.replicas if not rep.engine.crashed]
        launches, ok_launch = {}, True
        for rid, eng in gpu["built"]:
            draft = L if isinstance(eng.drafter, ModelDrafter) else 0
            got, got_i8 = watch(eng)
            exp = expected_paged_launches(eng, L, draft)
            launches[f"{rid}:{eng.role}{':dead' if eng.crashed else ''}"] = {
                "paged_attention": got, "expected": exp, "int8_matmul": got_i8}
            ok_launch &= got == exp and (got_i8 > 0) == (pi == 1)
        case = {
            "roles": list(roles), "status_done": all(s == "done" for s in gpu["status"]),
            "tokens_equal_mixed_card": gpu["tokens"] == want,
            "streams_equal_tokens": gpu["streams"] == gpu["tokens"],
            "tokens_equal_cpu": gpu["tokens"] == cpu["tokens"],
            "counters_equal_cpu_every_step": gpu["steps"] == cpu["steps"],
            "router_steps": len(gpu["steps"]),
            "counters": {k: router.counters[k] for k in DISAGG_ROUTER_STATS},
            "pages_in_use_after": [e.stats()["pages_in_use"] for e in live] + [mixed_pages],
            "live_handoffs_after": len(router._live_handoffs),
            "transfer": router.transfer_stats.summary(), "launches": launches,
            "kv_cow_count_decode_side": sum(e.stats()["kv_cow_count"] for _, e in gpu["built"]
                                            if e.role != "prefill"),
            "launches_exact": bool(ok_launch),
        }
        ok = (case["status_done"] and case["tokens_equal_mixed_card"]
              and case["streams_equal_tokens"] and case["tokens_equal_cpu"]
              and case["counters_equal_cpu_every_step"] and ok_launch
              and not any(case["pages_in_use_after"]) and not case["live_handoffs_after"])
        # Every request goes through a handoff, except where a mixed replica serves
        # both phases itself.
        ok &= (router.counters["handoffs"] > 0 if "mixed" in roles
               else router.counters["handoffs"] >= len(workload))
        if name == "decode_pool_defers":
            ok &= router.counters["handoff_defers"] > 0
        if name.startswith("kill"):
            ok &= router.counters["replica_kills"] == 1
            ok &= (router.counters["readopted"] > 0 if name == "kill_decode_pdd"
                   else router.counters["replica_restarts"] >= 1
                   and router.counters["replayed"] > 0)
        if name.endswith("_cow"):
            ok &= case["kv_cow_count_decode_side"] > 0
        if "spec" in name:
            dec = router.replicas[1].engine
            case["spec_accept_rate"] = dec.stats()["spec_accept_rate"]
            ok &= dec.spec_proposed > 0
            if "model" in name:
                ok &= dec.spec_accepted == dec.spec_proposed  # the target's own draft
        case["ok"] = bool(ok)
        res["cases"][name] = case
        if not ok:
            failed.append(name)
    res["ok"] = not failed
    emit(res)
    if failed:
        raise PhaseFailed("disaggregated serving on the card disagrees", failed)
    return res


MAIN_SPEC = dict(**MAIN_ENGINE, decode_steps=MULTI_N, spec_k=SPEC_K)


def spec_graph_stats(eng) -> dict:
    """Each fused speculative graph of ``eng``, by (N, k, max_ngram, sampled, paged):
    kernel nodes (all, paged attention), replays, capture seconds and pool bytes."""
    return {"_".join(map(str, key)): {
        "kernel_nodes": run.nodes(),
        "paged_attention_nodes": sum(run.nodes(k) for k in PAGED_KERNELS),
        "replays": run.replays, "capture_s": run.capture_s, "pool_bytes": run.pool_bytes}
        for key, run in eng.spec_graphs.items() if hasattr(run, "nodes")}


def divergence_rows(params, cfg, workload, plain_tokens, spec_tokens,
                    engine_kw=MAIN_ENGINE) -> dict:
    """For each request whose speculative tokens differ from the plain (spec_k=0)
    engine's, at its first divergence d: the logits row the plain N = 1 engine chose
    token d from, and the row of the host-loop speculative verify that chose it, each
    read while the request is replayed alone (a lane's computation does not depend on
    the other lanes: the replayed tokens must equal the batched engines' tokens), on
    engines of ``engine_kw``'s geometry (paged or dense).
    Returns {request: {d, tokens, delta (max |row difference|), gap (the plain row's
    top-two gap: of the logits, or of the filtered logits plus emission d's Gumbel
    noise for a sampled lane), temperature, limit, filter_boundary (a sampled lane's
    top-k/top-p supports differ between the rows and one engine's token lies outside
    the other's), ok}}: a near tie is gap ≤ 2·delta (over the temperature) or a filter
    boundary, with delta ≤ ``DELTA_MAX``."""
    from accelerate_tpu_torch import serving as sv
    from accelerate_tpu_torch.generation import emission_generator, filtered_logits, gumbel_noise
    from accelerate_tpu_torch.spec_decode import NgramDrafter

    first = {i: next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
             for i, (a, b) in enumerate(zip(plain_tokens, spec_tokens)) if a != b}
    rows = {"plain": {}, "spec": {}}
    engines = {"plain": sv.ContinuousBatcher(params, cfg, **engine_kw),
               "spec": sv.ContinuousBatcher(params, cfg, **engine_kw, spec_k=SPEC_K,
                                            drafter=NgramDrafter(3))}
    seen = {}
    verify_name = ("_spec_verify_step_paged" if engine_kw.get("page_size")
                   else "_spec_verify_step")
    verify = getattr(sv, verify_name)

    def recording_verify(*args, **kw):  # keeps the spec replay's verify rows
        out = verify(*args, **kw)
        seen["logits"] = out[1]
        seen["lens"] = [len(r.tokens) if r is not None else 0
                        for r in engines["spec"].slot_req]
        return out

    def hook(tok, side, i, d, holder):
        req = holder[0]
        if len(req.tokens) != d + 1:
            return
        eng = engines[side]
        slot = eng.slot_req.index(req)
        row = (eng.last_logits[slot] if side == "plain"
               else seen["logits"][slot, d - seen["lens"][slot]])
        rows[side][i] = (row.float().cpu(), int(tok))

    setattr(sv, verify_name, recording_verify)
    try:
        for side, eng in engines.items():
            for i, d in first.items():
                prompt, kw = workload[i]
                if d == 0:  # the first token comes from the same prefill graph
                    continue
                kw = (dict(kw, gen=dataclasses.replace(kw["gen"], max_new_tokens=d + 1))
                      if "gen" in kw else dict(kw, max_new_tokens=d + 1))
                holder = []
                holder.append(eng.submit(prompt, **kw, on_token=functools.partial(
                    hook, side=side, i=i, d=d, holder=holder)))
            eng.run()
    finally:
        setattr(sv, verify_name, verify)
    out = {}
    for i, d in first.items():
        gen = workload[i][1].get("gen")
        rec = {"d": d, "plain_token": plain_tokens[i][d], "spec_token": spec_tokens[i][d],
               "temperature": gen.temperature if gen is not None else None}
        if i not in rows["plain"] or i not in rows["spec"]:
            out[i] = {**rec, "ok": False, "note": "not replayed (a divergence at token 0)"}
            continue
        (p_row, p_tok), (s_row, s_tok) = rows["plain"][i], rows["spec"][i]
        delta = float((p_row - s_row).abs().max())
        scale, boundary = 1.0, False
        if gen is not None:
            pf, sf = (filtered_logits(r[None], gen.temperature, gen.top_p, gen.top_k)[0]
                      for r in (p_row, s_row))
            # A filter-boundary tie: the rows' top-k/top-p supports differ, and one
            # engine's token lies outside the other's support.
            p_in, s_in = torch.isfinite(pf), torch.isfinite(sf)
            boundary = bool((p_in != s_in).any()) and not (bool(p_in[s_tok])
                                                             and bool(s_in[p_tok]))
            p_row = pf + gumbel_noise((1, p_row.shape[0]),
                                      emission_generator(workload[i][1]["seed"], d))[0]
            scale = gen.temperature
        top = torch.topk(p_row, 2).values
        gap = float(top[0] - top[1])
        limit = 2 * delta / scale
        out[i] = {**rec, "replayed_plain_token": p_tok, "replayed_spec_token": s_tok,
                  "delta": delta, "gap": gap, "limit": limit, "filter_boundary": boundary,
                  "ok": (p_tok == rec["plain_token"] and s_tok == rec["spec_token"]
                         and delta <= DELTA_MAX and (gap <= limit or boundary))}
    return out


def phase_main_spec(dev, main: dict) -> dict:
    """Speculative serving at Llama-3-8B's full width and depth (bf16, paged, pages of
    16, ``max_slots=8``, ``max_len=1024``, ``decode_steps=8``, ``spec_k=3``,
    ``NgramDrafter(max_ngram=3)``): ``main``'s workload after ``warm_programs()``. Hard
    checks: no graph captured in traffic; tokens (greedy and sampled) equal a host-loop
    spec engine's (``decode_steps=1``) bitwise; kernel #1 exactly 32·8 launches a fused
    super-step (graph nodes × replays) on the cluster route (``launches_ragged``
    unchanged); against the spec_k=0 engine (``main``'s tokens), every first divergence
    a near tie (``divergence_rows``, ``DELTA_MAX``). Reported: tokens/s against spec_k=0 at N = 8 (warm
    engines alternated, ``drain_ab``), accept rate, tokens per round, one fused
    super-step's device time and profile, the resident drafter's and the accept walk's
    device time a round, ``noise_s``, peak memory."""
    from accelerate_tpu_torch.generation import speculative_prefix_accept
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.spec_decode import NgramDrafter, ngram_propose_resident

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    params = main["params"]
    workload = main_workload(cfg.vocab_size)[3]
    eng = ContinuousBatcher(params, cfg, **MAIN_SPEC, drafter=NgramDrafter(3))
    t0 = time.perf_counter()
    warm = warm_summary(eng.warm_programs(max_new_tokens=64))
    torch.cuda.synchronize()
    warm["wall_s"] = time.perf_counter() - t0
    keys_warm = graph_keys(eng)
    paged_attention.launches = 0
    paged_attention.launches_ragged = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    run = drain_engine(eng, workload)
    peak = torch.cuda.max_memory_allocated()
    s = eng.stats()
    launches = path_launches(eng)[0]
    ragged = paged_attention.launches_ragged
    expect = cfg.n_layers * MULTI_N * s["decode_steps"]
    graphs = spec_graph_stats(eng)
    nodes_ok = bool(graphs) and all(g["paged_attention_nodes"] == cfg.n_layers * MULTI_N
                                    for g in graphs.values())
    host = ContinuousBatcher(params, cfg, **MAIN_ENGINE, spec_k=SPEC_K, drafter=NgramDrafter(3))
    host_run = drain_engine(host, workload)
    # The host loop's first verify (position 0) against main's first decode step, on the
    # same inputs.
    first_delta = float((host_run["first_logits"].float()
                         - main["first_logits"].float()).abs().max())
    del host
    gc.collect()
    divergences = divergence_rows(params, cfg, workload, main["tokens"], run["tokens"])
    ties_ok = all(v["ok"] for v in divergences.values())
    lane_rounds = s["spec_proposed"] / SPEC_K
    res = {"phase": "main_spec", "config": "llama3-8b", "dtype": "bfloat16",
           "engine": {**MAIN_SPEC, "drafter": "NgramDrafter(max_ngram=3)"},
           "requests": len(workload), "warm_programs": warm,
           "no_graph_captured_in_traffic": graph_keys(eng) == keys_warm,
           "tokens_equal_host_loop": run["tokens"] == host_run["tokens"],
           "tokens_per_s": run["tokens_per_s"], "wall_s": run["wall_s"],
           "host_loop_tokens_per_s": host_run["tokens_per_s"],
           "spec_accept_rate": s["spec_accept_rate"], "spec_proposed": s["spec_proposed"],
           "spec_accepted": s["spec_accepted"], "decode_steps": s["decode_steps"],
           "decode_tokens": s["decode_tokens"],
           "tokens_per_super_step": s["tokens_per_step"],
           "tokens_per_round": s["decode_tokens"] / (s["decode_steps"] * MULTI_N),
           "tokens_per_lane_round": s["decode_tokens"] / lane_rounds if lane_rounds else None,
           "noise_s": s["noise_s"], "noise_ahead_s": s["noise_ahead_s"],
           "dispatch_s": s["dispatch_s"], "decode_s": s["decode_s"],
           "paged_attention_launches": launches, "paged_attention_launches_expected": expect,
           "paged_attention_launches_ragged": ragged, "graphs": graphs,
           "graph_nodes_ok": nodes_ok,
           "requests_equal_spec_k0": [a == b for a, b in zip(run["tokens"], main["tokens"])],
           "share_equal_spec_k0": float(np.mean([a == b for a, b in
                                                 zip(run["tokens"], main["tokens"])])),
           "first_step_logit_max_abs_diff": first_delta, "delta_max": DELTA_MAX,
           "divergences": divergences, "near_ties_ok": ties_ok,
           "max_memory_allocated_bytes": peak,
           "memory_allocated_at_start_bytes": allocated_at_start,
           "finite_logits": run["finite"], "all_done": run["all_done"],
           "pages_in_use_after": s["pages_in_use"]}
    res["ok"] = (res["no_graph_captured_in_traffic"] and res["tokens_equal_host_loop"]
                 and launches == expect and ragged == 0 and nodes_ok and ties_ok
                 and run["finite"] and run["all_done"] and s["pages_in_use"] == 0)
    emit(res)
    if not res["ok"]:
        raise SystemExit("the speculative main path failed its checks")

    # One fused super-step with all 8 lanes busy (greedy), replayed from its graph.
    rng = np.random.default_rng(23)
    busy = [eng.submit(rng.integers(0, cfg.vocab_size, 200), max_new_tokens=160)
            for _ in range(eng.max_slots)]
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    prof = graph_device_profile(eng.spec_graphs[eng._spec_key(False)])
    for r in busy:
        eng.cancel(r.uid)
    # The resident drafter and the accept walk alone, at the super-step's shapes.
    B, S = eng.max_slots, eng.max_len
    g = torch.Generator(dev).manual_seed(24)
    hist = torch.randint(0, 50, (B, S), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(300, S, (B,), generator=g, device=dev, dtype=torch.int32)
    props = torch.randint(0, 4, (B, SPEC_K), generator=g, device=dev, dtype=torch.int32)
    ref = torch.randint(0, 4, (B, SPEC_K + 1), generator=g, device=dev, dtype=torch.int32)
    live = torch.ones((B,), dtype=torch.bool, device=dev)
    lim = torch.full((B,), 9, dtype=torch.int32, device=dev)
    eos = torch.full((B,), -1, dtype=torch.int32, device=dev)
    prof["drafter_ms_per_round"] = device_ms(
        lambda _: ngram_propose_resident(hist, lens, SPEC_K, 3), 8, 20)
    prof["accept_walk_ms_per_round"] = device_ms(
        lambda _: speculative_prefix_accept(props, ref, live, lim, eos), 8, 20)
    prof["phase"] = "main_spec_profile"
    prof["note"] = ("one 8-round greedy super-step, 8 lanes busy, replayed from its graph; "
                    "drafter and accept walk timed alone at B=8, S=1024, k=3")
    emit(prof)
    variants = {f"spec0_n{MULTI_N}": (params, {"decode_steps": MULTI_N}),
                f"spec{SPEC_K}_n{MULTI_N}": (params, {"decode_steps": MULTI_N,
                                                      "spec_k": SPEC_K})}
    drains = drain_ab(variants, cfg, dict(zip(variants, (main["tokens"], run["tokens"]))))
    emit(drains)
    if not drains["tokens_equal_main"]:
        raise SystemExit("a warm drain's tokens differ from its engine's first drain")
    del eng
    gc.collect()
    return {"launches": launches, "profile": prof, "drains": drains,
            "accept_rate": s["spec_accept_rate"]}


def phase_main_spec_draft(dev, main: dict) -> dict:
    """The 8B engine's host loop with a ModelDrafter over the target's own params (the
    weights shared; its dense cache ≈ 1 GB): 4 greedy requests of ``main``'s workload,
    32 new tokens each, after ``warm_programs()`` (the draft round's graph). Hard check:
    accept rate ≥ 0.9; kernel #1 launches 32 a verify (eager) and 32·(k+1) a draft
    round (graph nodes × replays). Reported: ms per token
    against the N = 1 spec_k=0 engine (alternated), the draft round's device time
    (graph replay) and profile, peak memory."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.spec_decode import ModelDrafter

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    params = main["params"]
    workload = [(p, dict(max_new_tokens=32)) for p, kw in main_workload(cfg.vocab_size)[3]
                if "gen" not in kw][:4]
    eng = ContinuousBatcher(params, cfg, **MAIN_ENGINE, spec_k=SPEC_K,
                            drafter=ModelDrafter(params, cfg))
    warm = warm_summary(eng.warm_programs(max_new_tokens=32))
    keys_warm = graph_keys(eng)
    paged_attention.launches = 0
    paged_attention.launches_ragged = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drain_engine(eng, workload)
    peak = torch.cuda.max_memory_allocated()
    s = eng.stats()
    launches = path_launches(eng)[0]
    # A step: one eager verify, and one draft-round replay of k+1 one-token steps.
    expect = cfg.n_layers * s["decode_steps"] * (1 + SPEC_K + 1)
    plain = ContinuousBatcher(params, cfg, **MAIN_ENGINE)
    engines = {"spec": eng, "plain": plain}

    def ms_per_token(name):
        e = engines[name]
        before = e.stats()
        r = drain_engine(e, workload)
        after = e.stats()
        return {"ms_per_token": 1e3 * r["wall_s"] / r["n_tokens"],
                "decode_ms_per_token": 1e3 * (after["decode_s"] - before["decode_s"])
                / max(after["decode_tokens"] - before["decode_tokens"], 1),
                "tokens": r["tokens"]}

    plain_first = ms_per_token("plain")  # captures the plain engine's prefill graphs
    runs = alternated({"spec": [], "plain": []}, ("spec", "plain", "plain", "spec"),
                      ms_per_token)
    med = {k: float(np.median([r["ms_per_token"] for r in v])) for k, v in runs.items()}
    draft_prof = graph_device_profile(eng.drafter.graphs[SPEC_K])
    res = {"phase": "main_spec_draft", "config": "llama3-8b", "dtype": "bfloat16",
           "engine": {**MAIN_ENGINE, "spec_k": SPEC_K, "drafter": "ModelDrafter(target params)"},
           "requests": len(workload), "max_new_tokens": 32, "warm_programs": warm,
           "no_graph_captured_in_traffic": graph_keys(eng) == keys_warm,
           "spec_accept_rate": s["spec_accept_rate"], "decode_steps": s["decode_steps"],
           "tokens_per_step": s["tokens_per_step"],
           "draft_cache_bytes": sum(t.numel() * t.element_size()
                                    for layer in eng.drafter.cache["layers"]
                                    for t in layer.values()),
           "paged_attention_launches": launches, "paged_attention_launches_expected": expect,
           "paged_attention_launches_ragged": paged_attention.launches_ragged,
           "ms_per_token_runs": {k: [r["ms_per_token"] for r in v] for k, v in runs.items()},
           "decode_ms_per_token_runs": {k: [r["decode_ms_per_token"] for r in v]
                                        for k, v in runs.items()},
           "ms_per_token_median": med, "order": "(spec, plain, plain, spec), warm engines",
           "share_equal_plain": float(np.mean([a == b for a, b in
                                               zip(run["tokens"], plain_first["tokens"])])),
           "draft_round_graph": draft_prof, "max_memory_allocated_bytes": peak,
           "finite_logits": run["finite"], "all_done": run["all_done"],
           "pages_in_use_after": s["pages_in_use"]}
    res["ok"] = (s["spec_accept_rate"] >= 0.9 and launches == expect
                 and paged_attention.launches_ragged == 0 and run["finite"]
                 and run["all_done"] and s["pages_in_use"] == 0
                 and res["no_graph_captured_in_traffic"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("the model-drafter main path failed its checks")
    del eng, plain, engines
    gc.collect()
    return {"launches": launches, "accept_rate": s["spec_accept_rate"],
            "draft_round_ms": draft_prof["device_ms"], "ms_per_token_median": med}


# ------------------------------------------- phase 4e: disaggregated serving at 8B
class _Records:
    """A duck-typed telemetry sink (``enabled``, ``emit``) keeping every record."""

    enabled = True

    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


def disagg_router_8b(params, cfg, roles, telemetry=None, engines=None):
    """A ``DisaggRouter`` at ``main``'s geometry: prefill replicas at N = 1 (they never
    decode), decode replicas at ``decode_steps=8``; ``engines`` reuses built ones."""
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.serving_gateway import DisaggRouter
    from accelerate_tpu_torch.utils.dataclasses import GatewayConfig

    engines = engines or [
        ContinuousBatcher(params, cfg, role=r, **MAIN_ENGINE,
                          **({"decode_steps": MULTI_N} if r == "decode" else {}))
        for r in roles]
    return DisaggRouter(engines, GatewayConfig(enabled=True), roles=list(roles),
                        telemetry=telemetry)


def drain_served(server, workload, kill=None) -> dict:
    """Submit ``workload`` to a router or an engine at one instant and drain it, timed to
    the final sync: tokens, streams (``on_retry`` resets them), each request's time to
    first token, tokens/s; ``kill=(rid, step)`` kills a router's replica after that
    many steps, and reports the prefill replica's ``admitted`` at that moment."""
    streams = {i: [] for i in range(len(workload))}
    first = {}

    def hooks(i):
        def on_token(tok):
            first.setdefault(i, time.perf_counter())
            streams[i].append(int(tok))

        return on_token

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router = hasattr(server, "replicas")
    reqs = [server.submit(p, on_token=hooks(i),
                          **({"on_retry": streams[i].clear} if router else {}), **kw)
            for i, (p, kw) in enumerate(workload)]
    steps, admitted_at_kill = 0, None
    while (server.queue_depth or server.running_count) if router else (
            server.queue or any(r is not None for r in server.slot_req)):
        if kill is not None and steps == kill[1]:
            admitted_at_kill = server.replicas[0].engine.admitted
            server.kill(kill[0])
        server.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = [first[i] - t0 for i in range(len(workload))]
    n = sum(len(r.tokens) for r in reqs)
    return {"tokens": [[int(t) for t in r.tokens] for r in reqs],
            "streams": [streams[i] for i in range(len(workload))], "wall_s": wall,
            "tokens_per_s": n / wall, "ttft_s": ttft,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p95_s": float(np.percentile(ttft, 95)),
            "done": all(r.status == "done" if router else r.done for r in reqs),
            "admitted_at_kill": admitted_at_kill}


def handoff_device_times(pre, dec, pages: int) -> dict:
    """Device ms of the handoff's device work at ``pages`` pages, each beside its bytes
    over 3.35 TB/s: the export gather (``serving._export_pages``, read + write), the
    import scatter (``_import_pages``) and one boundary page's copy on write
    (``_copy_page``), each captured in a CUDA graph and replayed between CUDA events.
    Run on drained pools: the pages written are free."""
    from accelerate_tpu_torch.serving import _copy_page, _export_pages, _import_pages

    ids = torch.arange(pages, dtype=torch.long, device=pre.device)
    block = _export_pages(pre.cache, ids)
    nbytes = sum(t.numel() * t.element_size() for layer in block for t in layer.values())
    page_bytes = dec.kv_page_bytes
    out = {"pages": pages, "block_bytes": nbytes}
    for name, fn, moved in (
            ("export_gather", lambda _: _export_pages(pre.cache, ids), 2 * nbytes),
            ("import_scatter", lambda _: _import_pages(dec.cache, block, ids), 2 * nbytes),
            ("cow_copy", lambda _: _copy_page(dec.cache, pages, pages + 1), 2 * page_bytes)):
        ms = device_ms(fn, 1, 20)
        bound = 1e3 * moved / HBM_BYTES_PER_S
        out[name] = {"device_ms": ms, "bytes": moved, "bound_ms": bound,
                     "bound_over_ms": bound / ms}
    return out


def phase_main_disagg(dev, main: dict) -> dict:
    """``main``'s 10 requests at Llama-3-8B's full width and depth (bf16, the same
    params) through a ``DisaggRouter`` over a prefill replica and a decode replica
    (``decode_steps=8``), both ``max_slots=8``, ``max_len=1024``, pages of 16, after
    ``warm_programs()``. Hard checks: every request's tokens (greedy and sampled) equal
    ``main``'s (the mixed engine's: ``main_multistep`` holds N = 8 equal to N = 1),
    bitwise; one handoff per request; pools drained; no graph captured in traffic;
    kernel #1 launched exactly 32·8 times a decode super-step (graph nodes × replays)
    and never by the prefill replica. Printed: each handoff's real pages and bytes
    against the table-width block's; device ms of the export gather, the import
    scatter and the copy on write beside bytes / 3.35 TB/s; the transfer's (a no-op on
    one card); host ms of an adoption; time to first token (p50, p95) and tokens/s of
    warm drains, disagg against a mixed engine of the same geometry at N = 8
    (alternated); the decode replica's idle share; peak memory of the pools and the
    weights. Then a P:D:D fleet killing decode replica 1 mid-drain: every stream equals
    ``main``'s tokens, ``readopted > 0``, and the prefill replica admits nothing more."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    params = main["params"]
    workload = main_workload(cfg.vocab_size)[3]
    want = main["tokens"]
    tel = _Records()
    watch = _EngineLaunches()
    router = disagg_router_8b(params, cfg, ("prefill", "decode"), telemetry=tel)
    pre, dec = (watch.watch(rep.engine) for rep in router.replicas)
    warm = {e.role: warm_summary(e.warm_programs(max_new_tokens=64)) for e in (pre, dec)}
    keys_warm = {e.role: graph_keys(e) for e in (pre, dec)}
    paged_attention.launches_ragged = 0
    before = {e.role: (watch(e)[0], e.decode_steps) for e in (pre, dec)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drain_served(router, workload)
    peak = torch.cuda.max_memory_allocated()
    launches = {e.role: watch(e)[0] - before[e.role][0] for e in (pre, dec)}
    expect = cfg.n_layers * MULTI_N * (dec.decode_steps - before["decode"][1])
    sp, sd = pre.stats(), dec.stats()
    records = [r for r in tel.records if r["schema"].endswith("serving.handoff/v1")]
    table_bytes = dec.block_mgr.max_pages * dec.kv_page_bytes
    res = {"phase": "main_disagg", "config": "llama3-8b", "dtype": "bfloat16",
           "engine": {**MAIN_ENGINE, "roles": ["prefill", "decode"],
                      "decode_steps": {"prefill": 1, "decode": MULTI_N}},
           "requests": len(workload), "warm_programs": warm,
           "no_graph_captured_in_traffic": all(graph_keys(e) == keys_warm[e.role]
                                               for e in (pre, dec)),
           "tokens_equal_main": run["tokens"] == want,
           "streams_equal_tokens": run["streams"] == run["tokens"],
           "handoffs": router.counters["handoffs"],
           "handoffs_exported": sp["handoffs_exported"],
           "handoffs_adopted": sd["handoffs_adopted"],
           "paged_attention_launches": launches,
           "paged_attention_launches_expected": {"prefill": 0, "decode": expect},
           "paged_attention_launches_ragged": paged_attention.launches_ragged,
           "decode_super_steps": sd["decode_steps"], "wall_s": run["wall_s"],
           "tokens_per_s": run["tokens_per_s"], "ttft_p50_s": run["ttft_p50_s"],
           "ttft_p95_s": run["ttft_p95_s"],
           "pages_in_use_after": [sp["pages_in_use"], sd["pages_in_use"]],
           "live_handoffs_after": len(router._live_handoffs),
           "max_memory_allocated_bytes": peak,
           "pool_bytes": {"prefill": pre.cache_bytes(), "decode": dec.cache_bytes()},
           "params_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params))}
    res["ok"] = (res["no_graph_captured_in_traffic"] and res["tokens_equal_main"]
                 and res["streams_equal_tokens"] and run["done"]
                 and res["handoffs"] == len(workload) == sp["handoffs_exported"]
                 == sd["handoffs_adopted"]
                 and launches == {"prefill": 0, "decode": expect} and expect > 0
                 and paged_attention.launches_ragged == 0
                 and res["pages_in_use_after"] == [0, 0] and not res["live_handoffs_after"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("the disaggregated main path failed its checks")

    # The handoff's cost: bytes, device times, an adoption's host time.
    biggest = max(r["pages"] for r in records)
    handoff = {"phase": "disagg_handoff", "per_handoff": [
        {"uid": r["uid"], "pages": r["pages"], "bytes": r["nbytes"],
         "table_width_bytes": table_bytes, "transfer_s": r["dur_s"]} for r in records],
        "kv_page_bytes": dec.kv_page_bytes, "table_pages": dec.block_mgr.max_pages,
        "transfer": "same device: kv_page_transfer moves nothing (0.0 s)",
        "adopt_host_ms_mean": 1e3 * sd["adopt_s"] / sd["handoffs_adopted"],
        "kv_cow_count_decode": sd["kv_cow_count"], "kv_adopt_count_decode": sd["kv_adopt_count"],
        "device": handoff_device_times(pre, dec, biggest)}
    emit(handoff)

    # Warm drains, disagg against a mixed engine of the same geometry at N = 8.
    mixed = ContinuousBatcher(params, cfg, **MAIN_ENGINE, decode_steps=MULTI_N)
    mixed.warm_programs(max_new_tokens=64)
    servers = {"mixed": mixed, "disagg": router}
    first_mixed = drain_served(mixed, workload)

    def timed(name):
        r = drain_served(servers[name], workload)
        replays = {k: getattr(g, "replays", 0) for k, g in dec.graphs.items()}
        r["decode_replays"] = replays
        return r

    runs = alternated({"mixed": [], "disagg": []}, ("mixed", "disagg", "disagg", "mixed"),
                      timed)
    # The decode replica's device time: its super-step graphs replayed back to back.
    graph_ms = {k: _events_ms(lambda _, g=g: g.graph.replay(), 5)
                for k, g in dec.graphs.items() if hasattr(g, "graph")}
    busy = []
    for i, r in enumerate(runs["disagg"]):
        prev = runs["disagg"][i - 1]["decode_replays"] if i else None
        n = {k: v - (prev[k] if prev else (runs["mixed"][0]["decode_replays"][k]))
             for k, v in r["decode_replays"].items()}
        busy.append(sum(n[k] * graph_ms.get(k, 0.0) for k in n))
    ab = {"phase": "disagg_ab", "order": "(mixed, disagg, disagg, mixed), warm engines",
          "requests": len(workload),
          "tokens_equal_main": all(r["tokens"] == want for rs in runs.values() for r in rs)
          and first_mixed["tokens"] == want,
          "tokens_per_s": {k: [r["tokens_per_s"] for r in v] for k, v in runs.items()},
          "ttft_p50_s": {k: [r["ttft_p50_s"] for r in v] for k, v in runs.items()},
          "ttft_p95_s": {k: [r["ttft_p95_s"] for r in v] for k, v in runs.items()},
          "decode_graph_device_ms": {str(k): v for k, v in graph_ms.items()},
          "decode_replica_busy_ms": busy,
          "decode_replica_idle_share": [1 - b / (1e3 * r["wall_s"])
                                        for b, r in zip(busy, runs["disagg"])]}
    ab["tokens_per_s_median"] = {k: float(np.median(v)) for k, v in ab["tokens_per_s"].items()}
    emit(ab)
    if not ab["tokens_equal_main"]:
        raise SystemExit("a warm drain's tokens differ from main's")
    del mixed, servers
    gc.collect()

    # P:D:D, decode replica 1 killed mid-drain: its requests adopt again on replica 2
    # from the prefill replica's still-held pages.
    d2 = ContinuousBatcher(params, cfg, role="decode", **MAIN_ENGINE, decode_steps=MULTI_N)
    d2.warm_programs(max_new_tokens=64)
    watch.watch(d2)
    kill_router = disagg_router_8b(params, cfg, ("prefill", "decode", "decode"),
                                   engines=[pre, dec, d2])
    kbefore = {id(e): watch(e)[0] for e in (pre, dec, d2)}
    kill = drain_served(kill_router, workload, kill=(1, 2))
    kres = {"phase": "main_disagg_kill", "roles": ["prefill", "decode", "decode"],
            "killed": 1, "after_router_steps": 2,
            "streams_equal_main": kill["streams"] == want, "done": kill["done"],
            "readopted": kill_router.counters["readopted"],
            "migrated": kill_router.counters["migrated"],
            "prefill_admitted_unchanged": pre.admitted == kill["admitted_at_kill"],
            "pages_in_use_after": [pre.stats()["pages_in_use"], d2.stats()["pages_in_use"]],
            "paged_attention_launches": sum(watch(e)[0] - kbefore[id(e)]
                                            for e in (pre, dec, d2)),
            "wall_s": kill["wall_s"]}
    kres["ok"] = (kres["streams_equal_main"] and kres["done"] and kres["readopted"] > 0
                  and kres["prefill_admitted_unchanged"] and kres["pages_in_use_after"] == [0, 0])
    emit(kres)
    if not kres["ok"]:
        raise SystemExit("the disaggregated kill run failed its checks")

    del router, kill_router, pre, dec, d2
    gc.collect()
    return {"launches": launches["decode"], "launches_kill": kres["paged_attention_launches"],
            "ab": ab, "handoff": handoff}



# ------------------------------------------ phase 4c: the fault boundary and tracing
FAULT_ENGINE = dict(max_slots=4, max_len=256, prompt_bucket=32)
FAULT_STATS = ("step_failures", "quarantined", "recovered_admissions", "bisect_rounds",
               "watchdog_timeouts", "admitted", "evicted", "decode_steps", "decode_tokens")
#: ``engine_faults``' watchdog and hang: a ``debug`` dispatch takes milliseconds on the
#: card and on the CPU; every engine runs ``warm_programs()`` first, so no capture runs
#: inside a watched dispatch.
DEBUG_TIMEOUT_S, DEBUG_HANG_S = 0.5, 1.0


def _fault_plan(specs, seed=0):
    from accelerate_tpu_torch.resilience import FaultPlan, FaultSpec

    return FaultPlan([FaultSpec(**kw) for kw in specs], seed=seed)


def _fault_records(records) -> list:
    """The fault and recovery records' identifying columns, in order."""
    return [(r["schema"].rsplit(".", 1)[-1], r.get("site"), r.get("kind"), r.get("action"),
             r.get("uid"), r.get("step"), r.get("survivors"), r.get("tokens_kept"),
             # a fault's reason is its exception's text (a timeout's holds its seconds)
             r.get("reason") if r["schema"].endswith("recovery/v1") else None)
            for r in records if r["schema"].endswith(("fault/v1", "recovery/v1"))]


def serve_faulted(params, cfg, workload, specs, seed=0, warm=True, **engine_kw) -> dict:
    """``workload`` on one engine under a fresh plan of ``specs``, with an enabled
    ``Telemetry`` (``warm_programs()`` first on the card) → tokens, failure reasons,
    counters, the fired list, the fault/recovery records, every record's validation,
    pages in use after (registry evicted), the engine."""
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.telemetry import Telemetry, validate_record
    from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

    tel = Telemetry(TelemetryConfig(enabled=True, compile_events=False, memory_stats=False))
    plan = _fault_plan(specs, seed) if specs else None
    eng = ContinuousBatcher(params, cfg, faults=plan, telemetry=tel, **engine_kw)
    if warm and eng.device.type == "cuda":
        eng.warm_programs(max_new_tokens=32)
    keys = graph_keys(eng)
    before = path_launches(eng)  # after the graphs' eager first calls in warm_programs
    reqs = [eng.submit(p, **kw) for p, kw in workload]
    done = eng.run()
    clear_registry(eng)
    s = eng.stats()
    return {"tokens": [[int(t) for t in r.tokens] for r in reqs],
            "failed": [r.failed for r in reqs], "returned": len(done),
            "counters": {k: s[k] for k in FAULT_STATS},
            "fired": plan.fired if plan else [], "records": _fault_records(tel.records),
            "invalid_records": sum(bool(validate_record(r)) for r in tel.records),
            "pages_in_use": s.get("pages_in_use", 0), "eng": eng,
            "launches": [a - b for a, b in zip(path_launches(eng), before)],
            # on the CPU a runner is made at first use; on the card warm_programs made all
            "captured_in_traffic": sorted(map(str, graph_keys(eng) - keys))}


def phase_engine_faults(dev) -> dict:
    """The fault boundary on the card against the CPU (``debug``, fp32, ``max_slots=4``,
    ``max_len=256``, ``prompt_bucket=32``; ``engine_disagg``'s six requests, two of them
    sampled), each case under the same seeded ``FaultPlan`` on both sides: an attributed
    decode poison (dense); an unattributed poison bisected to its request (paged,
    ``decode_steps=4``; and the fused speculative super-step, ``spec_k=2``); a ``hang``
    past the step watchdog, rebuilt in place (paged; and int8 projections at
    ``decode_steps=4``: kernel #10); ``kv_admit`` and ``prefill`` faults on a paged
    prefix-cache engine; a decode-role replica's hang under a ``DisaggRouter`` (its
    survivors re-prefilled through its row cache); and ``crash`` clauses failing a P:D:D
    fleet's replicas over (re-adoption, re-prefill on a restarted replica). Hard
    checks: the same quarantined requests and reasons, the same tokens (greedy and
    sampled), the same fired ``(site, kind, uid, invocation)`` list, counters and fault
    and recovery records on the card as on the CPU; every request returned; every
    record valid; no page leaked; on the card, no graph captured in traffic after
    ``warm_programs()``, the cache planes at the same addresses after every rebuild and
    kernel #1 launched exactly once per layer per token step of every dispatch that ran
    (timed-out ones included)."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to
    from accelerate_tpu_torch.ops import quantization as qz

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    int8_cpu = qz.load_and_quantize_model(params_cpu, qz.BnbQuantizationConfig(
        skip_modules=["embed", "lm_head"], min_weight_size=1, load_in_8bit=True))
    sides = {"cpu": (params_cpu, int8_cpu),
             "gpu": (params_to(params_cpu, dev), params_to(int8_cpu, dev))}
    workload = disagg_workload(cfg.vocab_size)
    L = cfg.n_layers
    poison = dict(site="serving.decode", kind="error", prob=1.0)
    hang = dict(site="serving.decode", kind="hang", prob=1.0, max_fires=1, attributed=False,
                hang_s=DEBUG_HANG_S)
    paged = dict(FAULT_ENGINE, page_size=8)
    # name -> (specs, params index, engine keywords, the victim's uid and reason or None)
    cases = {
        "dense_poison_attributed": ([dict(poison, match_uid=1, max_fires=1)], 0,
                                    FAULT_ENGINE, (1, "step_fault:error")),
        "paged_n4_poison_bisected": ([dict(poison, match_uid=2, attributed=False)], 0,
                                     dict(paged, decode_steps=4), (2, "step_fault:error")),
        "paged_hang_rebuild": ([dict(hang, start=2)], 0,
                               dict(paged, step_timeout_s=DEBUG_TIMEOUT_S), None),
        "int8_n4_hang_rebuild": ([dict(hang, start=1)], 1,
                                 dict(paged, decode_steps=4, step_timeout_s=DEBUG_TIMEOUT_S),
                                 None),
        "prefix_kv_admit_and_prefill": (
            [dict(site="serving.kv_admit", kind="error", prob=1.0, start=1, max_fires=1),
             dict(site="serving.prefill", kind="error", prob=1.0, start=4, max_fires=1)], 0,
            dict(paged, prefix_cache=4), None),
        "spec_fused_poison_bisected": ([dict(poison, match_uid=3, attributed=False)], 0,
                                       dict(paged, decode_steps=4, spec_k=2),
                                       (3, "step_fault:error")),
    }
    res = {"phase": "engine_faults", "config": "debug", "engine": FAULT_ENGINE, "cases": {}}
    failed = []
    for name, (specs, pi, kw, victim) in cases.items():
        run = {}
        for side, params in sides.items():
            run[side] = serve_faulted(params[pi], cfg, workload, specs, **kw)
        gpu, cpu = run["gpu"], run["cpu"]
        eng = gpu["eng"]
        c = gpu["counters"]
        got_pa, got_i8 = gpu["launches"]
        # Every dispatch that ran: the clean ones and the timed-out ones (a fault of
        # another kind raises before the launch).
        expect_pa = (L * eng.multi_step * (c["decode_steps"] + c["watchdog_timeouts"])
                     if eng.paged else 0)
        case = {
            "fired": gpu["fired"], "failed": gpu["failed"], "counters": c,
            "same_as_cpu": {k: gpu[k] == cpu[k] for k in ("tokens", "failed", "counters",
                                                           "fired", "records")},
            "returned_all": gpu["returned"] == cpu["returned"] == len(workload),
            "invalid_records": gpu["invalid_records"] + cpu["invalid_records"],
            "pages_in_use_after": [gpu["pages_in_use"], cpu["pages_in_use"]],
            "paged_attention_launches": got_pa, "paged_attention_expected": expect_pa,
            "int8_matmul_launches": got_i8,
            "captured_in_traffic": gpu["captured_in_traffic"],
        }
        ok = (all(case["same_as_cpu"].values()) and case["returned_all"]
              and not case["captured_in_traffic"]
              and not case["invalid_records"] and case["pages_in_use_after"] == [0, 0]
              and got_pa == expect_pa and (got_i8 > 0) == (pi == 1) and bool(gpu["fired"]))
        if victim is not None:
            uid, reason = victim
            ok &= [f for f in gpu["failed"] if f] == [reason] and gpu["failed"][uid] == reason
        elif "hang" in name:
            ok &= c["watchdog_timeouts"] == 1 and c["recovered_admissions"] > 0
            ok &= not any(gpu["failed"])
        else:
            ok &= sum(f is not None for f in gpu["failed"]) == 2
        case["ok"] = bool(ok)
        res["cases"][name] = case
        if not ok:
            failed.append(name)

    # In-place rebuild: the cache planes keep their storage across a rebuild, and no
    # graph is captured after warm_programs() (a survivor's grown context rides the
    # warmed chunk pair). Compile events counted by an enabled monitor.
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.telemetry import CompileMonitor

    eng = ContinuousBatcher(sides["gpu"][0], cfg, **paged, decode_steps=4,
                            prompt_buckets=(32, 64), step_timeout_s=DEBUG_TIMEOUT_S,
                            faults=_fault_plan([dict(hang, start=2)]))
    eng.warm_programs(max_new_tokens=32)
    keys, ptrs = graph_keys(eng), cache_ptrs(eng)
    mon = CompileMonitor().start()
    try:
        reqs = [eng.submit(p, **kw) for p, kw in workload]
        eng.run()
    finally:
        mon.stop()
    rebuild = {"no_graph_captured": graph_keys(eng) == keys and mon.count == 0,
               "compile_events": mon.snapshot(), "cache_ptrs_unchanged": cache_ptrs(eng) == ptrs,
               "recovered_admissions": eng.recovered_admissions,
               "all_done": all(r.done and not r.failed for r in reqs)}
    rebuild["ok"] = bool(rebuild["no_graph_captured"] and rebuild["cache_ptrs_unchanged"]
                         and rebuild["recovered_admissions"] > 0 and rebuild["all_done"])
    res["cases"]["in_place_rebuild_buckets"] = rebuild
    if not rebuild["ok"]:
        failed.append("in_place_rebuild_buckets")

    # Fleets: a decode-role replica's hang (recovery armed: it re-prefills), and crash
    # clauses failing a P:D:D fleet over. A replica's plan is one object per side that
    # its restarts keep (as tests/test_disagg.py builds them), so a fired clause stays
    # spent.
    plans = {}

    def plan_of(rid, specs, seed=0):
        return lambda p: {"faults": plans.setdefault((id(p), rid), _fault_plan(specs, seed))}

    fleets = {
        "decode_role_hang": (("prefill", "decode"), {"decode": lambda p: {
            **plan_of(1, [dict(hang, start=2)])(p), "step_timeout_s": DEBUG_TIMEOUT_S}}, {}),
        "crash_pdd": (("prefill", "decode", "decode"), {
            0: plan_of(0, [dict(site="serving.prefill", kind="crash", prob=0.2,
                                max_fires=1)], 11),
            1: plan_of(1, [dict(site="serving.decode", kind="crash", prob=0.15,
                                max_fires=1)], 12)},
            {"factory": True, "replica_restarts": 3}),
    }
    from accelerate_tpu_torch.serving import ContinuousBatcher as _CB

    for name, (roles, ekw, rkw) in fleets.items():
        plans.clear()
        run = {}
        watch = _EngineLaunches()
        for side, params in sides.items():
            run[side] = serve_disagg(params[0], cfg, workload, roles, ekw,
                                     watch if side == "gpu" else None, **rkw)
        gpu, cpu = run["gpu"], run["cpu"]
        router = gpu["router"]
        mixed = _CB(sides["gpu"][0], cfg, **DISAGG_ENGINE)
        mreqs = [mixed.submit(p, **kw) for p, kw in workload]
        mixed.run()
        fired = {side: [list(p.fired) for (pid, _), p in sorted(
            plans.items(), key=lambda kv: kv[0][1]) if pid == id(sides[side][0])]
            for side in run}
        live = [rep.engine for rep in router.replicas if not rep.engine.crashed]
        dec = [e for _, e in gpu["built"] if e.role == "decode"]
        case = {"roles": list(roles), "status_done": all(s == "done" for s in gpu["status"]),
                "streams_equal_mixed_card": gpu["streams"] == [[int(t) for t in r.tokens]
                                                               for r in mreqs],
                "tokens_equal_cpu": gpu["tokens"] == cpu["tokens"],
                "counters_equal_cpu_every_step": gpu["steps"] == cpu["steps"],
                "fired": fired["gpu"], "fired_equal_cpu": fired["gpu"] == fired["cpu"],
                "counters": {k: router.counters[k] for k in DISAGG_ROUTER_STATS},
                "decode_recovered_admissions": [e.recovered_admissions for e in dec],
                "pages_in_use_after": [e.stats()["pages_in_use"] for e in live],
                "launches": {f"{rid}:{e.role}": watch(e)[0] for rid, e in gpu["built"]}}
        ok = (case["status_done"] and case["streams_equal_mixed_card"]
              and case["tokens_equal_cpu"] and case["counters_equal_cpu_every_step"]
              and case["fired_equal_cpu"] and any(case["fired"])
              and not any(case["pages_in_use_after"]))
        if name == "decode_role_hang":
            ok &= sum(case["decode_recovered_admissions"]) > 0
        else:
            ok &= router.counters["replica_kills"] >= 1
        case["ok"] = bool(ok)
        res["cases"][name] = case
        if not ok:
            failed.append(name)
    fence = fence_check(dev)
    res["cases"]["telemetry_fence"] = fence
    if not fence["ok"]:
        failed.append("telemetry_fence")
    res["ok"] = not failed
    emit(res)
    if failed:
        raise PhaseFailed("the fault boundary on the card disagrees", failed)
    return res


def fence_check(dev) -> dict:
    """A telemetry step record's fence on the card: 20 fp32 products of 4096² (about
    50 ms of device work) enqueued inside ``_step_begin``/``_step_end``; the fence must
    wait for them (the event recorded after the last product done when it returns, and
    most of the wall time in ``fence_s``), and the record carries the allocator's
    counters."""
    from accelerate_tpu_torch.telemetry import Telemetry, validate_record
    from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

    tel = Telemetry(TelemetryConfig(enabled=True))
    x = torch.randn(4096, 4096, device=dev, generator=torch.Generator(dev).manual_seed(3))

    def work():
        y = x
        for _ in range(20):
            y = (y @ x) * (1.0 / 64)
        return {"loss": y.sum(), "big": y}

    work()  # first use: cuBLAS's handle, kernel modules loaded (a load may synchronize)
    torch.cuda.synchronize()
    tel._step_begin()
    out = work()
    after = torch.cuda.Event()
    after.record()
    rec = tel._step_end(fence_on=out)
    done = after.query()
    tel.close()
    res = {"wall_s": rec["wall_s"], "dispatch_s": rec["dispatch_s"], "fence_s": rec["fence_s"],
           "work_done_at_return": done, "memory": rec.get("memory"),
           "valid": validate_record(rec) == []}
    res["ok"] = bool(done and rec["fence_s"] > rec["dispatch_s"] and rec["fence_s"] > 0.005
                     and (rec.get("memory") or {}).get("bytes_in_use", 0) > 0 and res["valid"])
    return res


def cache_ptrs(eng) -> list:
    """The device addresses of an engine's cache planes, valid rows and prefill row
    cache (a rebuild must keep every one)."""
    ptrs = [t.data_ptr() for planes in eng.cache["layers"] for t in planes.values()]
    ptrs.append(eng.cache["valid"].data_ptr())
    if eng._row is not None:
        ptrs += [t.data_ptr() for planes in eng._row["layers"] for t in planes.values()]
    return ptrs


#: ``main_faults``: the watchdog's budget, about 9× the warm 8B super-step's wall time
#: (115 ms profiled, PERF.md §5), the injected hang's host sleep well above it and the
#: dispatch it fires at, and the poisoned request. The poison (in the first 8 lanes) is
#: bisected and quarantined within the first dispatches and the suspicion cleared before
#: the hang: two unattributed faults whose bisections overlapped would narrow one's
#: suspects with the other's failures (as in the JAX engine).
MAIN_TIMEOUT_S, MAIN_HANG_S, MAIN_HANG_AT, MAIN_POISON_UID = 1.0, 3.0, 10, 2
#: ``main_faults``' span checks: the gateway's TTFT against the spans' (from the queue
#: span's start to the prefill span's end, which closes just after the first token is
#: streamed) and its TPOT against the decode spans' window, in seconds.
SPAN_TTFT_TOL_S, SPAN_TPOT_TOL_S = 0.01, 0.002


def _replay_rows(params, cfg, jobs) -> list:
    """Each job ``(prompt, kw, d, kept)`` replayed to emission ``d`` as one request of
    ONE engine at ``main``'s geometry (N = 1; its lanes hold up to
    ``MAIN_ENGINE["max_slots"]`` jobs at once, the rest queue) → per job (the logits row
    emission ``d`` was drawn from, its token). A lane's rows depend on its own request
    only (every lane of a step runs the same programs at the same shapes), so a job's
    row is the one it gets replayed alone. ``kept``: the request enters as a recovery
    re-admission that kept those ``tokens`` (its context prompt + those tokens,
    prefilled), as after a rebuild."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    eng = ContinuousBatcher(params, cfg, **MAIN_ENGINE)
    state = {"prefill": None}
    rows = [None] * len(jobs)
    prefill_into = eng._prefill_into_slot

    def recording_prefill(*a, **k):
        out = prefill_into(*a, **k)
        if out is not None:  # None: a paged admission deferred, nothing ran
            state["prefill"] = out[1][0].float().cpu()
        return out

    eng._prefill_into_slot = recording_prefill
    reqs = []
    for j, (prompt, kw, d, kept) in enumerate(jobs):
        def hook(tok, j=j, d=d):
            req = reqs[j]
            if len(req.tokens) == d + 1:
                row = state["prefill"]
                if row is None:
                    row = eng.last_logits[eng.slot_req.index(req)].float().cpu()
                rows[j] = (row, int(tok))
            state["prefill"] = None

        gen = kw.get("gen")
        kw = (dict(kw, gen=dataclasses.replace(gen, max_new_tokens=d + 1)) if gen is not None
              else dict(kw, max_new_tokens=d + 1))
        req = eng.submit(prompt, on_token=hook, **kw)
        if kept:
            req.tokens = list(kept)
            req._recover_ctx = np.concatenate([req.prompt, np.asarray(kept, np.int32)])
        reqs.append(req)
    eng.run()
    return rows


def recovery_divergence(params, cfg, workload, want, got, readmits) -> dict:
    """For each request whose tokens after recovery differ from the undisturbed run's,
    at its first divergence ``d``: it must have been re-admitted with ``k <= d`` tokens
    kept (tokens before the rebuild came from the undisturbed computation), and ``d``
    must be a near tie — the undisturbed row and the recovered row (the request
    replayed alone, re-admitted with its first ``k`` tokens) differing by at most
    ``DELTA_MAX`` and the undisturbed row's top-two gap (of the filtered logits plus
    emission ``d``'s noise over the temperature, for a sampled lane) within twice that,
    or a top-k/top-p support boundary. A re-prefill computes the context's K/V with the
    prefill programs, whose bf16 rounding is not the decode steps'."""
    from accelerate_tpu_torch.generation import emission_generator, filtered_logits, gumbel_noise

    out, replay = {}, {}
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b or not b:
            continue
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        ks = [k for k in readmits.get(i, []) if k <= d]
        rec = {"d": d, "want_token": a[d] if d < len(a) else None,
               "got_token": b[d] if d < len(b) else None, "readmitted_with": ks}
        if not ks or d >= min(len(a), len(b)):
            out[i] = {**rec, "ok": False}
            continue
        out[i] = rec
        replay[i] = (d, b[:ks[-1]])
    # Every replay at once: request i undisturbed, and re-admitted with its kept tokens.
    order = sorted(replay)
    rows = _replay_rows(params, cfg, [job for i in order for job in (
        (*workload[i], replay[i][0], None), (*workload[i], *replay[i]))]) if order else []
    for n, i in enumerate(order):
        rec, kw, d = out[i], workload[i][1], replay[i][0]
        (p_row, p_tok), (r_row, r_tok) = rows[2 * n], rows[2 * n + 1]
        delta = float((p_row - r_row).abs().max())
        gen, scale, boundary = kw.get("gen"), 1.0, False
        if gen is not None:
            pf, rf = (filtered_logits(r[None], gen.temperature, gen.top_p, gen.top_k)[0]
                      for r in (p_row, r_row))
            p_in, r_in = torch.isfinite(pf), torch.isfinite(rf)
            boundary = bool((p_in != r_in).any()) and not (bool(p_in[r_tok])
                                                             and bool(r_in[p_tok]))
            p_row = pf + gumbel_noise((1, p_row.shape[0]), emission_generator(kw["seed"], d))[0]
            scale = gen.temperature
        top = torch.topk(p_row, 2).values
        gap = float(top[0] - top[1])
        out[i] = {**rec, "replayed_want_token": p_tok, "replayed_got_token": r_tok,
                  "delta": delta, "gap": gap, "limit": 2 * delta / scale,
                  "filter_boundary": boundary,
                  "ok": (p_tok == rec["want_token"] and r_tok == rec["got_token"]
                         and delta <= DELTA_MAX and (gap <= 2 * delta / scale or boundary))}
    return out


def gateway_drain(gw, workload) -> dict:
    """``workload`` submitted to a gateway at one instant and drained, timed to the
    final sync → the gateway requests, tokens, tokens/s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greqs = [gw.submit(p, **kw) for p, kw in workload]
    gw.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sum(len(g.tokens) for g in greqs)
    return {"greqs": greqs, "tokens": [[int(t) for t in g.tokens] for g in greqs],
            "wall_s": wall, "tokens_per_s": n / wall}


def span_agreement(spans, greqs) -> dict:
    """Per request, the spans against the gateway's own latencies: TTFT from the queue
    span's start to the (first) prefill span's end, TPOT over the decode spans' window,
    the decode spans' tokens + 1 against the transcript."""
    by_uid = {}
    for s in spans:
        by_uid.setdefault(s["uid"], []).append(s)
    worst = {"ttft_abs_s": 0.0, "tpot_abs_s": 0.0}
    tokens_ok = True
    for g in greqs:
        mine = by_uid[g.uid]
        queue = next(s for s in mine if s["span"] == "queue")
        prefill = next(s for s in mine if s["span"] == "prefill")
        decode = [s for s in mine if s["span"] == "decode"]
        first_t = next(s["t1"] for s in mine if s["span"] == "first_token")
        worst["ttft_abs_s"] = max(worst["ttft_abs_s"],
                                  abs((prefill["t1"] - queue["t0"]) - g.ttft_s),
                                  abs((first_t - queue["t0"]) - g.ttft_s))
        span_tpot = (max(s["t1"] for s in decode) - first_t) / (len(g.tokens) - 1)
        worst["tpot_abs_s"] = max(worst["tpot_abs_s"], abs(span_tpot - g.tpot_s))
        tokens_ok &= sum(s["tokens"] for s in decode) + 1 == len(g.tokens)
    return {**worst, "decode_span_tokens_equal_transcripts": bool(tokens_ok),
            "ok": bool(tokens_ok and worst["ttft_abs_s"] <= SPAN_TTFT_TOL_S
                       and worst["tpot_abs_s"] <= SPAN_TPOT_TOL_S)}


def phase_main_faults(dev, main: dict) -> dict:
    """The fault boundary and request tracing at Llama-3-8B's full width and depth
    (bf16, the same params): ``main``'s 10 requests through a ``ServingGateway`` over a
    paged engine at ``decode_steps=8`` after ``warm_programs()``, with an enabled
    ``Telemetry`` (the JSONL pipeline's records, compile and memory counters) and a
    ``Tracer``, under a plan of two ``serving.decode`` clauses: a ``hang`` of
    ``MAIN_HANG_S`` past the ``MAIN_TIMEOUT_S`` watchdog at the third dispatch (a
    rebuild in place of every lane), and an unattributed poison of request 9
    (bisected to it). Hard checks: request 9 ends ``FAILED`` with ``step_fault:error``
    and every other request ``done``; every other request's tokens equal ``main``'s,
    or differ only after its recovery re-admission at a near tie
    (``recovery_divergence``); no graph captured after ``warm_programs()`` (none
    counted by the compile monitor either); the cache planes' addresses unchanged; no
    page leaked; kernel #1 exactly 32·8 per super-step that ran (the timed-out one
    included); every record valid. Printed: the rebuild's host ms and the device ms of
    the in-place reset, bisection rounds and seconds from the poison's first fault to
    its quarantine. Then warm drains through gateways with telemetry and tracer off and
    on, alternated (tokens/s; tokens equal ``main``'s), with the on runs' spans held to
    the gateway's TTFT and TPOT per request (``span_agreement``) and ``trace_report``'s
    p50/p95 TTFT equal to the gateway's."""
    from accelerate_tpu_torch.commands.trace_report import trace_report
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.serving import ContinuousBatcher
    from accelerate_tpu_torch.serving_gateway import ServingGateway
    from accelerate_tpu_torch.telemetry import (TRACE_SPAN_SCHEMA, Telemetry, Tracer,
                                                percentile, validate_record)
    from accelerate_tpu_torch.utils.dataclasses import GatewayConfig, TelemetryConfig

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    # main's seeded params (made again when main's were freed: the same generator seed)
    params = main.get("params") or llama.init_params(
        cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    workload = main_workload(cfg.vocab_size)[3]
    want = main["tokens"]
    tel = Telemetry(TelemetryConfig(enabled=True))
    stamped = []
    tel.sinks.append(lambda r: stamped.append((time.perf_counter(), r)))
    tracer = Tracer(tel)
    plan = _fault_plan([
        dict(site="serving.decode", kind="hang", prob=1.0, start=MAIN_HANG_AT, max_fires=1,
             hang_s=MAIN_HANG_S, attributed=False),
        dict(site="serving.decode", kind="error", prob=1.0, match_uid=MAIN_POISON_UID,
             attributed=False)], seed=15)
    eng = ContinuousBatcher(params, cfg, **MAIN_ENGINE, decode_steps=MULTI_N, faults=plan,
                            step_timeout_s=MAIN_TIMEOUT_S, telemetry=tel, tracer=tracer)
    warm = warm_summary(eng.warm_programs(max_new_tokens=64))
    keys, ptrs = graph_keys(eng), cache_ptrs(eng)
    captures = tel.compile_monitor.count
    gw = ServingGateway(eng, GatewayConfig(enabled=True), telemetry=tel, tracer=tracer)
    paged_attention.launches_ragged = 0
    before = path_launches(eng)[0]
    torch.cuda.reset_peak_memory_stats()
    run = gateway_drain(gw, workload)
    launches = path_launches(eng)[0] - before
    compiles = tel.compile_monitor.count - captures  # before the replays below capture
    s = eng.stats()
    expect = cfg.n_layers * MULTI_N * (s["decode_steps"] + s["watchdog_timeouts"])
    greqs = run["greqs"]
    status = [(g.status, g.reason) for g in greqs]
    readmits = {}
    for _, r in stamped:
        if r.get("action") == "readmit":
            readmits.setdefault(r["uid"], []).append(r["tokens_kept"])
    survivors = [i for i in range(len(workload)) if i != MAIN_POISON_UID]
    div = recovery_divergence(params, cfg, workload,
                              [want[i] if i in survivors else [] for i in range(len(want))],
                              [run["tokens"][i] if i in survivors else []
                               for i in range(len(want))], readmits)
    t_fault = next(t for t, r in stamped if r["schema"].endswith("fault/v1")
                   and r.get("kind") == "error")
    t_quarantine = next(t for t, r in stamped if r.get("action") == "quarantine")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._reset_cache()
    torch.cuda.synchronize()
    reset_ms = 1e3 * (time.perf_counter() - t0)  # launches and device work, synced
    res = {"phase": "main_faults", "config": "llama3-8b", "dtype": "bfloat16",
           "engine": {**MAIN_ENGINE, "decode_steps": MULTI_N, "step_timeout_s": MAIN_TIMEOUT_S},
           "plan": [dataclasses.asdict(sp) for sp in plan.specs], "fired": plan.fired,
           "warm_programs": {k: v for k, v in warm.items() if k != "entries"},
           "status": status, "wall_s": run["wall_s"],
           "tokens_equal_main": [run["tokens"][i] == want[i] for i in survivors],
           "recovery_divergence": div,
           "readmitted_with_tokens": readmits,
           "counters": {k: s[k] for k in FAULT_STATS},
           "rebuild_host_ms": 1e3 * s["rebuild_s"], "reset_cache_synced_ms": reset_ms,
           "pool_bytes": eng.cache_bytes(),
           "bisect_rounds": s["bisect_rounds"],
           "poison_fault_to_quarantine_s": t_quarantine - t_fault,
           "no_graph_captured_in_traffic": graph_keys(eng) == keys,
           "compiles_in_traffic": compiles,
           "cache_ptrs_unchanged": cache_ptrs(eng) == ptrs,
           "pages_in_use_after": s["pages_in_use"],
           "paged_attention_launches": launches, "paged_attention_expected": expect,
           "paged_attention_launches_ragged": paged_attention.launches_ragged,
           "records": len(tel.records),
           "invalid_records": sum(bool(validate_record(r)) for r in tel.records),
           "spans": sum(r["schema"] == TRACE_SPAN_SCHEMA for r in tel.records),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    res["ok"] = bool(
        status[MAIN_POISON_UID] == ("failed", "step_fault:error")
        and all(status[i] == ("done", None) for i in survivors)
        and all(d["ok"] for d in div.values())
        and res["no_graph_captured_in_traffic"] and res["compiles_in_traffic"] == 0
        and res["cache_ptrs_unchanged"] and res["pages_in_use_after"] == 0
        and launches == expect and paged_attention.launches_ragged == 0
        and not res["invalid_records"] and s["watchdog_timeouts"] == 1
        and s["quarantined"] == 1 and len(plan.fired) >= 2)
    emit(res)
    if not res["ok"]:
        raise SystemExit("the 8B fault boundary failed its checks")
    del eng, gw
    gc.collect()

    # Warm drains with telemetry and the tracer off and on, alternated.
    variants = {}
    for name in ("off", "on"):
        t = Telemetry(TelemetryConfig(enabled=name == "on"))
        tr = Tracer(t) if name == "on" else None
        e = ContinuousBatcher(params, cfg, **MAIN_ENGINE, decode_steps=MULTI_N,
                              telemetry=t if name == "on" else None, tracer=tr)
        e.warm_programs(max_new_tokens=64)
        variants[name] = (ServingGateway(e, GatewayConfig(enabled=True),
                                         telemetry=t if name == "on" else None, tracer=tr), t)
    for name in variants:  # one untimed drain each
        gateway_drain(variants[name][0], workload)

    def timed(name):
        gw_, t = variants[name]
        t.records.clear()
        r = gateway_drain(gw_, workload)
        spans = [rec for rec in t.records if rec["schema"] == TRACE_SPAN_SCHEMA]
        r["spans"] = span_agreement(spans, r["greqs"]) if name == "on" else None
        if name == "on":
            report = trace_report(spans)
            ttfts = [g.ttft_s for g in r["greqs"]]
            r["trace_report_ttft"] = {"p50": report["ttft"]["p50"], "p95": report["ttft"]["p95"]}
            r["trace_report_equals_gateway"] = (
                report["ttft"]["p95"] == round(percentile(ttfts, 95), 6)
                and report["ttft"]["p50"] == round(percentile(ttfts, 50), 6))
            r["records"] = len(t.records)
            r["invalid_records"] = sum(bool(validate_record(x)) for x in t.records)
        r.pop("greqs")
        return r

    runs = alternated({"off": [], "on": []}, ("off", "on", "on", "off"), timed)
    ab = {"phase": "telemetry_ab", "order": "(off, on, on, off), warm engines",
          "requests": len(workload),
          "tokens_equal_main": all(r["tokens"] == want for rs in runs.values() for r in rs),
          "tokens_per_s": {k: [r["tokens_per_s"] for r in v] for k, v in runs.items()},
          "spans": [r["spans"] for r in runs["on"]],
          "trace_report_ttft": [r["trace_report_ttft"] for r in runs["on"]],
          "trace_report_equals_gateway": all(r["trace_report_equals_gateway"]
                                             for r in runs["on"]),
          "records_per_drain": [r["records"] for r in runs["on"]],
          "invalid_records": sum(r["invalid_records"] for r in runs["on"])}
    ab["tokens_per_s_median"] = {k: float(np.median(v)) for k, v in ab["tokens_per_s"].items()}
    ab["on_over_off"] = ab["tokens_per_s_median"]["on"] / ab["tokens_per_s_median"]["off"]
    ab["ok"] = bool(ab["tokens_equal_main"] and all(x["ok"] for x in ab["spans"])
                    and ab["trace_report_equals_gateway"] and not ab["invalid_records"])
    emit(ab)
    if not ab["ok"]:
        raise SystemExit("the telemetry on/off drains failed their checks")
    del variants
    gc.collect()
    crash = disagg_crash(params, cfg, workload, want)
    return {"launches": launches, "launches_crash": crash["paged_attention_launches"],
            "result": res, "ab": ab, "crash": crash}


def disagg_crash(params, cfg, workload, want) -> dict:
    """The ``FaultPlan`` spelling of a decode replica's death on ``main_disagg``'s fleet:
    a P:D:D ``DisaggRouter`` at ``main``'s geometry after ``warm_programs()``, decode
    replica 1 under a ``crash`` clause at its third dispatch, which raises
    ``EngineCrashed`` out of its ``step()``; the router fails its requests over to decode
    replica 2, which adopts them again from the prefill replica's pages. Hard checks:
    every stream equals ``main``'s tokens, one kill, ``readopted > 0``, pools drained."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    watch = _EngineLaunches()
    engines = [ContinuousBatcher(params, cfg, role=role, **MAIN_ENGINE, **kw)
               for role, kw in (("prefill", {}),
                                ("decode", {"decode_steps": MULTI_N, "faults": _fault_plan(
                                    [dict(site="serving.decode", kind="crash", prob=1.0,
                                          start=2, max_fires=1)])}),
                                ("decode", {"decode_steps": MULTI_N}))]
    for eng in engines:
        eng.warm_programs(max_new_tokens=64)
        watch.watch(eng)
    pre, d1, d2 = engines
    before = {id(e): watch(e)[0] for e in engines}
    router = disagg_router_8b(params, cfg, ("prefill", "decode", "decode"), engines=engines)
    crash = drain_served(router, workload)
    res = {"phase": "main_disagg_crash", "roles": ["prefill", "decode", "decode"],
           "plan": "serving.decode:crash,start=2,max=1 on replica 1", "fired": d1.faults.fired,
           "crashed": d1.crashed, "streams_equal_main": crash["streams"] == want,
           "done": crash["done"], "replica_kills": router.counters["replica_kills"],
           "readopted": router.counters["readopted"],
           "pages_in_use_after": [pre.stats()["pages_in_use"], d2.stats()["pages_in_use"]],
           "paged_attention_launches": sum(watch(e)[0] - before[id(e)] for e in engines),
           "wall_s": crash["wall_s"]}
    res["ok"] = (res["streams_equal_main"] and res["done"] and res["crashed"]
                 and res["replica_kills"] == 1 and res["readopted"] > 0
                 and res["pages_in_use_after"] == [0, 0])
    emit(res)
    if not res["ok"]:
        raise SystemExit("the disaggregated crash run failed its checks")
    del router, engines, pre, d1, d2
    gc.collect()
    return res


# ------------------------------------------------- the serving control plane (slice 16)
#: ``main_control``'s gates, sized so the phase stays under two and a half minutes at
#: 8B. The schedule on the virtual clock does not depend on the model (fixed output
#: lengths, no EOS), so these were chosen on the CPU at the same geometry: every site
#: fires and some requests survive re-admission (chaos); with 8 lanes a replica, the
#: fleet beats one engine of 24 lanes only when arrivals come twice as fast into a queue
#: of half the lanes (``load``, ``overload``); and the autoscaler's windows are a third
#: of the JAX bench's defaults (tuned there for 2-lane replicas, whose trace is 4×
#: longer), so a trough is long enough to scale down.
CONTROL_CHAOS = dict(requests=24, chaos_rate=0.08, chaos_sites=("decode", "prefill", "kv_admit"),
                     seed=0)
CONTROL_FLEET = dict(n_replicas=3, requests=16, kill_rate=0.1, kills_per_replica=2, load=2.0,
                     overload=0.5, seed=0)
CONTROL_AUTOSCALE = dict(requests=16, min_replicas=1, max_replicas=3, cooldown_s=4.0,
                         down_cooldown_s=4.0, idle_window_s=4.0, forecast_window_s=8.0 / 3,
                         seed=0)
CONTROL_TRACE = dict(generator="poisson", requests=16, seed=4)
CONTROL_GEOMETRY = dict(max_slots=8, max_len=1024, prompt_bucket=64)


#: main_control's and main_bench's depth: their gates (policies, faults, kills,
#: scaling on the virtual clock, stream equality between arms) do not depend on depth,
#: and their engines' warm-ups and host-bound N = 1 steps scale with it (32 before
#: slice 20, cut to keep the script in its time). Registered as a preset of its own,
#: the first BENCH_LAYERS layers of ``main``'s params.
BENCH_LAYERS = 8
BENCH_PRESET = f"llama3-8b-{BENCH_LAYERS}l"


def bench_model(dev, main: dict):
    """(cfg, params) of main_control and main_bench: Llama-3-8B's widths at depth
    BENCH_LAYERS (the preset BENCH_PRESET), the first layers of ``main``'s params."""
    from accelerate_tpu_torch.models import llama

    llama.CONFIGS.setdefault(BENCH_PRESET, dataclasses.replace(
        llama.CONFIGS["llama3-8b"], n_layers=BENCH_LAYERS))
    cfg = dataclasses.replace(llama.CONFIGS[BENCH_PRESET], dtype=torch.bfloat16)
    params = main.get("params") or llama.init_params(
        dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16),
        generator=torch.Generator(dev).manual_seed(0), device=dev)
    return cfg, {**params, "layers": params["layers"][:BENCH_LAYERS]}


class _ControlEngines:
    """Every engine a bench builds, seen by its ``engine_hook`` after the engine's
    ``warm_programs()`` and before its first request: its graph keys then (none may be
    added in traffic), kernel #1's launches from then on (``_EngineLaunches``), and when
    it was built (host clock)."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.watch = _EngineLaunches()
        self.seen = []

    def __call__(self, eng):
        self.watch.watch(eng)
        self.seen.append({"eng": eng, "keys": graph_keys(eng), "t": time.perf_counter(),
                          "launches0": self.watch(eng)[0]})

    def summary(self, first: int = 0) -> dict:
        seen = self.seen[first:]
        return {
            "engines": len(seen),
            "graphs_captured_in_traffic": sum(graph_keys(s["eng"]) != s["keys"] for s in seen),
            "paged_attention_launches": sum(self.watch(s["eng"])[0] - s["launches0"]
                                            for s in seen),
            "paged_attention_expected": sum(expected_paged_launches(s["eng"], self.n_layers)
                                            if s["eng"].paged else 0 for s in seen),
            "pages_in_use_after": sum(s["eng"].stats().get("pages_in_use", 0) or 0
                                      for s in seen),
        }


def _trace_prompts(trace, vocab: int, seed: int) -> list:
    """The prompts ``replay_trace`` synthesizes for ``trace`` (its seeded stream), as
    ``(prompt, greedy submit keywords)``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, row.prompt_len).astype(np.int32),
             dict(max_new_tokens=row.output_len)) for row in trace]


def _scrape_equals_stats(plane) -> dict:
    """One HTTP scrape of ``plane`` through ``MetricsExporter`` on 127.0.0.1 against
    ``plane.stats()`` read just after: every counter and gauge sample equal to the
    digit (the scrape counts itself before rendering, so both see it)."""
    import urllib.request

    from accelerate_tpu_torch.telemetry import MetricsExporter

    with MetricsExporter(plane, host="127.0.0.1", port=0) as exporter:
        body = urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics",
                                      timeout=30).read().decode()
    stats = plane.stats()
    parsed = {}
    for line in body.splitlines():
        if line.strip() and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            parsed[series] = float(value)
    wrong = {series: [parsed.get(series), value]
             for table in ("counters", "gauges") for series, value in stats[table].items()
             if value is not None and parsed.get(series) != float(value)}
    return {"series": len(parsed), "bytes": len(body), "mismatched": wrong,
            "ok": not wrong and len(parsed) > 0}


def phase_main_control(dev, main: dict) -> dict:
    """The serving control plane at Llama-3-8B's full width, depth BENCH_LAYERS (bf16,
    the first layers of ``main``'s seeded params, shared by every replica), through the port's own serve-bench entry
    points on the virtual clock, every engine warmed with ``warm_programs()`` before it
    takes traffic (the spawned and restarted replicas included):

    - ``run_trace_replay`` (a poisson trace, FIFO, pages of 16) with a telemetry JSONL
      and a live ``MetricsPlane`` over it: one HTTP scrape on 127.0.0.1 equals
      ``stats()`` to the digit, and ``metrics_dump``'s offline re-aggregation of the
      JSONL equals the live plane's counters and gauges;
    - ``run_chaos_bench`` (decode, prefill and kv_admit faults, ``main``'s geometry,
      telemetry, metrics plane, alert rules, flight recorder with a capsule dir and a
      tracer on): nothing lost, every site fired, alerts silent when clean and firing
      under chaos, every capsule read back through ``capsule_report``, no page leaked;
      every stream that differs from the clean arm's differs only at a near tie after
      its recovery re-admission (``recovery_divergence``);
    - ``run_fleet_chaos_bench`` (3 replicas, crash clauses, restarts through
      ``engine_factory``): replayed streams equal the clean fleet's bitwise,
      availability above one engine of the same lanes, the alerts fired;
    - ``run_autoscale_bench`` (a swing trace, 1–3 replicas): at least one scale-up
      through ``spawn_replica`` and one scale-down, streams equal the fixed fleet's
      bitwise, every ``fleet.scale/v1`` record valid.

    Over every engine: no graph captured in traffic; kernel #1's launches exactly one
    per layer per decode step on the paged engines."""
    import tempfile

    from accelerate_tpu_torch.commands import serve_bench as sb
    from accelerate_tpu_torch.commands.capsule_report import capsule_report
    from accelerate_tpu_torch.commands.metrics_dump import aggregate_records
    from accelerate_tpu_torch.commands.trace_report import load_records
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving_gateway.workload import generate_workload
    from accelerate_tpu_torch.telemetry import (MetricsPlane, Telemetry, list_capsules,
                                                load_capsule, validate_record)
    from accelerate_tpu_torch.telemetry.metrics import M_TOKENS_PER_SECOND
    from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

    cfg, params = bench_model(dev, main)
    common = dict(preset=BENCH_PRESET, device=dev, dtype=torch.bfloat16, params=params)
    smi = nvidia_smi()
    hooks = _ControlEngines(cfg.n_layers)
    wall = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_control_"))
    try:
        # 1) trace replay with the live plane and its two readers.
        tel = Telemetry(TelemetryConfig(enabled=True, jsonl_dir=str(work / "run"),
                                        compile_events=False, memory_stats=False))
        live = MetricsPlane(tel, window_s=1e9)
        trace = generate_workload(CONTROL_TRACE["generator"], CONTROL_TRACE["requests"],
                                  seed=CONTROL_TRACE["seed"],
                                  mean_iat_s=sb._calibrated_iat(CONTROL_GEOMETRY["max_slots"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (row,) = sb.run_trace_replay(trace, policies=("fifo",), **common, **CONTROL_GEOMETRY,
                                     page_size=16, seed=CONTROL_TRACE["seed"],
                                     generator=CONTROL_TRACE["generator"], telemetry=tel,
                                     engine_hook=hooks)
        torch.cuda.synchronize()
        wall["trace_replay"] = time.perf_counter() - t0
        tel.close()
        trace_engines = hooks.summary()
        del hooks.seen[:]
        # metrics_dump first (a scrape counts itself on the live plane). Tokens/s is a
        # rate over the plane's clock, which the offline replay does not have (it runs
        # on record ordinals): every other gauge and every counter must be equal.
        offline = aggregate_records(load_records(str(work / "run"))).stats()
        live_stats = live.stats()
        rate = (M_TOKENS_PER_SECOND,)
        dump_equal = {
            "counters": offline["counters"] == live_stats["counters"],
            "gauges": ({k: v for k, v in offline["gauges"].items() if k not in rate}
                       == {k: v for k, v in live_stats["gauges"].items() if k not in rate})}
        scrape = _scrape_equals_stats(live)
        replay = {"phase": "control_trace_replay", "row": row, "engines": trace_engines,
                  "records": len(tel.records),
                  "invalid_records": sum(bool(validate_record(r)) for r in tel.records),
                  "scrape": scrape, "metrics_dump_equals_live": dump_equal,
                  "wall_s": wall["trace_replay"], "nvidia_smi": smi}
        replay["ok"] = bool(
            scrape["ok"] and all(dump_equal.values()) and not replay["invalid_records"]
            and row["done"] + row["shed"] + row["rejected"] + row["expired"]
            == len(trace) and trace_engines["graphs_captured_in_traffic"] == 0
            and trace_engines["paged_attention_launches"]
            == trace_engines["paged_attention_expected"] > 0
            and trace_engines["pages_in_use_after"] == 0)
        emit(replay)
        if not replay["ok"]:
            raise SystemExit("the 8B trace replay and its metrics readers failed their checks")

        # 2) the chaos proof at main's geometry.
        first = len(hooks.seen)
        t0 = time.perf_counter()
        chaos = sb.run_chaos_bench(**common, **CONTROL_CHAOS, **MAIN_ENGINE,
                                   capsule_dir=str(work / "capsules"), engine_hook=hooks)
        torch.cuda.synchronize()
        wall["chaos"] = time.perf_counter() - t0
        clean_eng, chaos_eng = hooks.seen[first]["eng"], hooks.seen[first + 1]["eng"]
        clean_s = hooks.seen[first + 1]["t"] - hooks.seen[first]["t"]
        clean_tokens = clean_eng.decode_tokens + clean_eng.admitted
        chaos_engines = hooks.summary(first)
        reports = [capsule_report(load_capsule(p))
                   for p in list_capsules(str(work / "capsules" / "chaos"))]
        trace = generate_workload("poisson", CONTROL_CHAOS["requests"],
                                  seed=CONTROL_CHAOS["seed"],
                                  mean_iat_s=sb._calibrated_iat(MAIN_ENGINE["max_slots"]))
        workload = _trace_prompts(trace, cfg.vocab_size, CONTROL_CHAOS["seed"])
        mism = {m["row"]: m for m in chaos["mismatched_requests"]}
        want = [mism[i]["clean"] if i in mism else [] for i in range(len(trace))]
        got = [mism[i]["chaos"] if i in mism else [] for i in range(len(trace))]
        readmits = {i: m["readmitted_with"] for i, m in mism.items()}
        div = recovery_divergence(params, cfg, workload, want, got, readmits)
        res = {"phase": "control_chaos", "config": BENCH_PRESET, "dtype": "bfloat16",
               "engine": MAIN_ENGINE, **CONTROL_CHAOS,
               "fired_by_site": chaos["fault_plan"]["fired_by_site"],
               "streams_compared": chaos["streams_compared"],
               "streams_mismatched": chaos["streams_mismatched"],
               "recovery_divergence": div,
               "silently_lost": [chaos[a]["silently_lost"] for a in ("clean", "chaos")],
               "done": [chaos[a]["done"] for a in ("clean", "chaos")],
               "failed_chaos": chaos["chaos"]["failed"],
               "engine_chaos": chaos["chaos"]["engine"],
               "alerts_clean_silent": chaos["alerts_clean_silent"],
               "alerts_chaos_fired": chaos["alerts_chaos_fired"],
               "capsules": chaos["capsules"], "capsules_clean": chaos["capsules_clean"],
               "capsule_reports": len(reports), "engines": chaos_engines,
               "ttft_p95_virtual_s": [(chaos[a]["ttft"] or {}).get("p95")
                                      for a in ("clean", "chaos")],
               "clean_arm": {"wall_s": clean_s, "tokens": clean_tokens,
                             "tokens_per_s": clean_tokens / clean_s},
               "wall_s": wall["chaos"], "workload_trace_hash": chaos["workload_trace_hash"],
               "nvidia_smi": smi}
        res["ok"] = bool(
            res["silently_lost"] == [0, 0]
            and set(res["fired_by_site"]) == {"serving.decode", "serving.prefill",
                                              "serving.kv_admit"}
            and res["streams_compared"] > 0 and all(d["ok"] for d in div.values())
            and len(div) == res["streams_mismatched"]
            and chaos["alerts_clean_silent"] and chaos["alerts_chaos_expected"]
            and chaos["capsules_chaos_expected"] and chaos["capsules_clean_zero"]
            and len(reports) == chaos["capsules"]["count"]
            and chaos_engines["graphs_captured_in_traffic"] == 0
            and chaos_engines["paged_attention_launches"]
            == chaos_engines["paged_attention_expected"] > 0
            and chaos_engines["pages_in_use_after"] == 0)
        emit(res)
        if not res["ok"]:
            raise SystemExit("the 8B chaos proof failed its checks")
        del clean_eng, chaos_eng, hooks.seen[first:]  # free the bench's caches
        chaos_launches = chaos_engines["paged_attention_launches"]

        # 3) the fleet chaos proof: crash kills, restarts, failover.
        first = len(hooks.seen)
        t0 = time.perf_counter()
        fleet = sb.run_fleet_chaos_bench(**common, **CONTROL_FLEET, **CONTROL_GEOMETRY,
                                         capsule_dir=str(work / "fleet_capsules"),
                                         engine_hook=hooks)
        torch.cuda.synchronize()
        wall["fleet"] = time.perf_counter() - t0
        fleet_engines = hooks.summary(first)
        del hooks.seen[first:]
        fres = {"phase": "control_fleet", **CONTROL_FLEET, "engine": CONTROL_GEOMETRY,
                "streams_compared": fleet["streams_compared"],
                "streams_identical": fleet["streams_identical"],
                "availability": [fleet[a]["availability"]
                                 for a in ("fleet_clean", "fleet_chaos", "single_chaos")],
                "fleet_availability_above_single": fleet["fleet_availability_above_single"],
                "replica_kills": fleet["fleet_chaos"]["replica_kills"],
                "replica_restarts": fleet["fleet_chaos"]["replica_restarts"],
                "silently_lost": fleet["fleet_chaos"]["silently_lost"],
                "alerts_clean_silent": fleet["alerts_clean_silent"],
                "alerts_chaos_fired": fleet["alerts_chaos_fired"],
                "capsules": fleet["capsules"]["count"], "engines": fleet_engines,
                "wall_s": wall["fleet"], "nvidia_smi": smi}
        fres["ok"] = bool(
            fleet["streams_identical"] and fleet["streams_compared"] > 0
            and fleet["fleet_availability_above_single"] and fres["replica_kills"] >= 1
            and fres["silently_lost"] == 0 and fleet["alerts_clean_silent"]
            and fleet["alerts_chaos_expected"] and fleet["capsules_chaos_expected"]
            and fleet["capsules_clean_zero"]
            and fleet_engines["graphs_captured_in_traffic"] == 0)
        emit(fres)
        if not fres["ok"]:
            raise SystemExit("the 8B fleet chaos proof failed its checks")

        # 4) the autoscaling proof.
        first = len(hooks.seen)
        t0 = time.perf_counter()
        auto = sb.run_autoscale_bench(**common, **CONTROL_AUTOSCALE, **CONTROL_GEOMETRY,
                                      engine_hook=hooks)
        torch.cuda.synchronize()
        wall["autoscale"] = time.perf_counter() - t0
        auto_engines = hooks.summary(first)
        del hooks.seen[first:]
        records = [r for arm in ("autoscaled", "steady", "flood", "chaos")
                   for r in auto[arm]["scale_records"]]
        ares = {"phase": "control_autoscale", **CONTROL_AUTOSCALE, "engine": CONTROL_GEOMETRY,
                "scale_actions": auto["autoscaled"]["scale_actions"],
                "replica_spawned": auto["autoscaled"]["replica_spawned"],
                "replica_hours": auto["replica_hours"],
                "attainment_within_band": auto["attainment_within_band"],
                "streams_compared": auto["streams_compared"],
                "streams_identical": auto["streams_identical"],
                "chaos_streams_identical": auto["chaos_streams_identical"],
                "zero_lost_all_arms": auto["zero_lost_all_arms"],
                "steady_no_scale": auto["steady_no_scale"],
                "flood_bounded": auto["flood_bounded"],
                "scale_records": len(records),
                "invalid_scale_records": sum(bool(validate_record(r)) for r in records),
                "engines": auto_engines, "wall_s": wall["autoscale"], "nvidia_smi": smi}
        ares["ok"] = bool(
            ares["scale_actions"]["scale_up"] >= 1 and ares["scale_actions"]["scale_down"] >= 1
            and ares["replica_spawned"] >= 1 and auto["streams_identical"]
            and auto["streams_compared"] > 0 and auto["chaos_streams_identical"]
            and auto["zero_lost_all_arms"] and not ares["invalid_scale_records"]
            and auto_engines["graphs_captured_in_traffic"] == 0)
        emit(ares)
        if not ares["ok"]:
            raise SystemExit("the 8B autoscaling proof failed its checks")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del hooks
    gc.collect()
    return {"launches": chaos_launches + trace_engines["paged_attention_launches"],
            "launches_by_bench": {"trace_replay": trace_engines["paged_attention_launches"],
                                  "chaos": chaos_launches},
            "wall_s": wall}


# --------------------------------------------- phase 4c': serve-bench's remaining modes
#: serve-bench's host-clock modes at Llama-3-8B, cut in request counts to fit the run.
BENCH_ROWS = dict(requests=8, max_slots=8, max_len=1024, prompt_bucket=128, max_new=16,
                  page_size=16, seed=0)
BENCH_CURVES = dict(generators=("poisson", "tenant_flood"), policies=("fifo", "priority", "edf"),
                    loads=(4.0,), requests=24, max_slots=8, max_len=1024, prompt_bucket=64,
                    seed=0)
BENCH_DISAGG = dict(prefill_replicas=1, decode_replicas=1, requests=8, max_slots=8,
                    max_len=1024, prompt_bucket=128, max_new=16, page_size=8, seed=0)
BENCH_PAGED = dict(budget_rows=2, max_slots=8, requests=8, prefix_cache=2, seed=0)
BENCH_MULTISTEP = dict(decode_steps=(1, MULTI_N), requests=8, max_new=32, max_slots=8,
                       page_size=16, seed=0)
BENCH_SPEC = dict(requests=6, spec_k=SPEC_K, fused_steps=MULTI_N, sweep_requests=6, seed=0)


class _ReturnProbe:
    """Whether the device had finished what a method queued when the method returned:
    a CUDA event recorded just after the return and queried at once (``query()`` does
    not wait, so nothing is synchronized that the path does not synchronize). Counts,
    per method, the calls that did work (an admission that admitted, an adoption that
    landed, every decode step) and those that returned with work still queued."""

    METHODS = ("_admit", "_plain_step", "adopt_handoff")

    def __init__(self):
        self.calls = dict.fromkeys(self.METHODS, 0)
        self.pending = dict.fromkeys(self.METHODS, 0)

    def __call__(self, eng):
        for name in self.METHODS:
            orig = getattr(eng, name)

            def probed(*args, _orig=orig, _name=name, **kw):
                admitted = eng.admitted
                out = _orig(*args, **kw)
                ev = torch.cuda.Event()
                ev.record()
                if _name == "_plain_step" or eng.admitted != admitted:
                    self.calls[_name] += 1
                    self.pending[_name] += not ev.query()
                return out

            setattr(eng, name, probed)

    def summary(self) -> dict:
        return {m: {"calls": self.calls[m], "pending_at_return": self.pending[m]}
                for m in self.METHODS}


def _p95(block) -> float:
    return (block or {}).get("p95")


def phase_main_bench(dev, main: dict) -> dict:
    """serve-bench's host-clock modes and its attainment curves at Llama-3-8B's full
    width, depth BENCH_LAYERS (bf16, the first layers of ``main``'s seeded params,
    shared by every engine), through the
    port's ``run_*`` entry points, every engine warmed with ``warm_programs()`` before
    traffic:

    - ``run_serve_bench``: the four policy rows (paged, pages of 16) and the oracle row
      (FIFO, ``spec_k=3``: the T = 4 verify through kernel #1);
    - ``run_trace_curves`` (virtual clock): priority and EDF high-class attainment at
      least FIFO's on both generators;
    - ``run_disagg_bench`` (1:1, pages of 8): nothing lost in the disagg and chaos arms,
      streams equal the mixed arm's; whether each metered method returned with device
      work still queued (:class:`_ReturnProbe`);
    - ``run_paged_compare``: concurrency at least 2x, paged bytes a request below dense;
    - ``run_multistep_bench`` (N = 1 and 8, paged): every stream bitwise the N = 1 row's;
    - ``run_spec_bench``: fused = host loop bitwise, fused against ``spec_k=0`` within
      the near-tie rule (``divergence_rows`` on the sweep's dense geometry).

    Over every engine: no graph captured in traffic; kernel #1's launches exactly
    ``expected_paged_launches`` on the paged engines, none on the pair's route; every
    row accounts for all its requests."""
    from accelerate_tpu_torch.commands import serve_bench as sb
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import paged_attention

    cfg, params = bench_model(dev, main)
    common = dict(preset=BENCH_PRESET, device=dev, dtype=torch.bfloat16, params=params)
    smi = nvidia_smi()
    hooks = _ControlEngines(cfg.n_layers)
    ragged0 = paged_attention.launches_ragged
    launches, wall, failed = {}, {}, []

    def bench(name, fn, hook=None, **kw):
        first = len(hooks.seen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = fn(**common, **kw, engine_hook=hook or hooks)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        engines = hooks.summary(first)
        engines["paged_attention_ragged_replayed"] = sum(
            replayed_launches(list(s["eng"].graphs.values())
                              + list(s["eng"].spec_graphs.values()), PAGED_KERNELS[1:])
            for s in hooks.seen[first:])
        del hooks.seen[first:]
        gc.collect()
        launches[name] = engines["paged_attention_launches"]
        return art, engines

    def check(res, ok, engines, pages=True):
        res["ok"] = bool(ok and engines["graphs_captured_in_traffic"] == 0
                         and engines["paged_attention_launches"]
                         == engines["paged_attention_expected"]
                         and engines["paged_attention_ragged_replayed"] == 0
                         and (not pages or engines["pages_in_use_after"] == 0))
        emit(res)
        if not res["ok"]:
            failed.append(res["phase"])

    def accounted(row, n):
        return row["done"] + row["rejected"] + row["shed"] + row["expired"] == n

    # 1) the per-policy overload rows, then the oracle row.
    rows, engines = bench("rows", sb.run_serve_bench, **BENCH_ROWS)
    oracle, o_engines = bench("oracle_row", sb.run_serve_bench, policies=("fifo",),
                              spec_k=SPEC_K, spec_draft="oracle", **BENCH_ROWS)
    (oracle,) = oracle
    row_keys = ("policy", "tokens_per_sec", "tokens_per_step", "done", "rejected", "shed",
                "expired", "kv_bytes_per_request", "max_concurrent_at_fixed_mem", "wall_s")
    res = {"phase": "bench_rows", **BENCH_ROWS,
           "rows": [{**{k: r[k] for k in row_keys}, "ttft_p95_s": _p95(r["ttft"]),
                     "ttft_high_p95_s": _p95(r["ttft_high"]), "tpot_p95_s": _p95(r["tpot"])}
                    for r in rows],
           "oracle": {**{k: oracle[k] for k in row_keys + ("spec_accept_rate",)},
                      "ttft_p95_s": _p95(oracle["ttft"]), "tpot_p95_s": _p95(oracle["tpot"])},
           "engines": engines, "oracle_engines": o_engines,
           "wall_s": [wall["rows"], wall["oracle_row"]], "nvidia_smi": smi}
    check(res, all(accounted(r, BENCH_ROWS["requests"]) for r in rows + [oracle])
          and o_engines["paged_attention_launches"] == o_engines["paged_attention_expected"] > 0,
          {k: engines[k] + o_engines[k] for k in engines})

    # 2) attainment against offered load (virtual clock; dense engines).
    curves, engines = bench("trace_curves", sb.run_trace_curves, **BENCH_CURVES)
    by = {(c["generator"], c["policy"]): c["points"][0] for c in curves["curves"]}
    separated = all(by[(g, p)]["attainment_high"] >= by[(g, "fifo")]["attainment_high"]
                    for g in BENCH_CURVES["generators"] for p in ("priority", "edf"))
    res = {"phase": "bench_trace_curves", **{k: v for k, v in BENCH_CURVES.items()},
           "points": {f"{g}/{p}": {k: pt[k] for k in ("attainment", "attainment_high", "done",
                                                       "rejected", "shed", "expired")}
                      for (g, p), pt in by.items()},
           "separated": separated, "engines": engines, "wall_s": wall["trace_curves"],
           "nvidia_smi": smi}
    check(res, separated and all(accounted(pt, BENCH_CURVES["requests"]) for pt in by.values()),
          engines)

    # 3) disaggregation: mixed against P:D, and the chaos arm; the meter's question.
    probe = _ReturnProbe()
    disagg, engines = bench("disagg", sb.run_disagg_bench,
                            hook=lambda eng: (hooks(eng), probe(eng)), **BENCH_DISAGG)
    arms = ("mixed", "disagg", "disagg_chaos")
    res = {"phase": "bench_disagg", **BENCH_DISAGG,
           "silently_lost": [disagg[a]["silently_lost"] for a in arms],
           "done": [disagg[a]["done"] for a in arms],
           "streams_identical_vs_mixed": disagg["streams_identical_vs_mixed"],
           "chaos_streams_identical": disagg["chaos_streams_identical"],
           "decode_stall_share": [disagg[a]["decode_stall_share"] for a in arms],
           "ttft_p95_s": [_p95(disagg[a]["ttft"]) for a in arms],
           "tpot_p95_s": [_p95(disagg[a]["tpot"]) for a in arms],
           "decode_tokens_per_busy_s": [disagg[a]["decode_tokens_per_busy_s"] for a in arms],
           "arm_wall_s": [disagg[a]["wall_s"] for a in arms],
           "handoffs": disagg["disagg"]["handoffs"],
           "handoff_transfer": disagg["disagg"]["handoff_transfer"],
           "replica_kills": disagg["disagg_chaos"]["replica_kills"],
           "stall_improved": disagg["stall_improved"],
           "ttft_p95_improved": disagg["ttft_p95_improved"],
           "return_probe": probe.summary(), "engines": engines, "wall_s": wall["disagg"],
           "nvidia_smi": smi}
    check(res, disagg["disagg"]["silently_lost"] == 0
          and disagg["disagg_chaos"]["silently_lost"] == 0
          and disagg["streams_identical_vs_mixed"] and disagg["chaos_streams_identical"]
          and disagg["streams_compared_vs_mixed"] > 0 and disagg["disagg"]["handoffs"] > 0,
          engines, pages=False)

    # 4) dense against paged at one KV byte budget.
    paged, engines = bench("paged_compare", sb.run_paged_compare, **BENCH_PAGED)
    dense_row, paged_row = paged["rows"]
    res = {"phase": "bench_paged", **BENCH_PAGED,
           "concurrency_ratio": paged["concurrency_ratio"],
           "prefix_memory_ratio": paged["prefix_memory_ratio"],
           "kv_budget_bytes": paged["kv_budget_bytes"],
           "rows": [{k: r[k] for k in ("layout", "max_concurrent_at_fixed_mem", "tokens_per_sec",
                                       "decode_tokens_per_sec", "tokens_per_step",
                                       "kv_bytes_per_request", "prefix_hit_memory_bytes",
                                       "prefix_hits")} for r in paged["rows"]],
           "engines": engines, "wall_s": wall["paged_compare"], "nvidia_smi": smi}
    check(res, paged["concurrency_ratio"] >= 2.0
          and paged_row["kv_bytes_per_request"] < dense_row["kv_bytes_per_request"],
          engines, pages=False)

    # 5) the super-step sweep.
    multi, engines = bench("multistep", sb.run_multistep_bench, **BENCH_MULTISTEP)
    res = {"phase": "bench_multistep", **BENCH_MULTISTEP,
           "rows": [{k: r[k] for k in ("decode_steps", "tokens_per_sec", "decode_tokens_per_sec",
                                       "decode_dispatches", "host_share", "identical_vs_n1")}
                    for r in multi["rows"]],
           "all_identical": multi["all_identical"],
           "decode_speedup_best": multi["decode_speedup_best"],
           "engines": engines, "wall_s": wall["multistep"], "nvidia_smi": smi}
    check(res, multi["all_identical"], engines)

    # 6) the speculative bench; fused against spec_k=0 under the near-tie rule.
    spec, engines = bench("spec", sb.run_spec_bench, **BENCH_SPEC)
    sweep_cfg = dataclasses.replace(cfg, max_seq=256)
    burst = sb._spec_sweep_workload(cfg.vocab_size, BENCH_SPEC["sweep_requests"], 16, 32,
                                    "repeat", BENCH_SPEC["seed"])
    workload = [(p, dict(gen=g, seed=r) if r is not None else
                 dict(max_new_tokens=g.max_new_tokens)) for p, g, r in burst]
    mism = {m["row"]: m for m in spec["mismatched_vs_plain"]}
    div = divergence_rows(
        params, sweep_cfg, workload,
        [mism[i]["plain"] if i in mism else [] for i in range(len(burst))],
        [mism[i]["fused"] if i in mism else [] for i in range(len(burst))],
        engine_kw=dict(max_slots=8, max_len=256, prompt_bucket=16))
    res = {"phase": "bench_spec", **BENCH_SPEC,
           "rows": [{k: r[k] for k in ("metric", "spec_draft", "spec_accept_rate",
                                       "tokens_per_step", "tokens_per_sec", "done")}
                    for r in spec["rows"]],
           "fused_sweep": [{k: r[k] for k in ("decode_steps", "spec_accept_rate",
                                              "tokens_per_step", "tokens_per_sec",
                                              "decode_tokens_per_sec", "host_share")}
                           for r in spec["fused_sweep"]["rows"]],
           "fused_identical_vs_host_loop": spec["fused_identical_vs_host_loop"],
           "fused_identical_vs_plain": spec["fused_identical_vs_plain"],
           "divergence": div, "comparison": spec["comparison"], "engines": engines,
           "wall_s": wall["spec"], "nvidia_smi": smi}
    check(res, spec["fused_identical_vs_host_loop"]
          and len(div) == len(mism) and all(d["ok"] for d in div.values())
          and all(accounted(r, BENCH_SPEC["requests"]) for r in spec["rows"]), engines)

    ragged = paged_attention.launches_ragged - ragged0
    emit({"phase": "bench_summary", "launches": launches, "launches_ragged": ragged,
          "wall_s": wall, "nvidia_smi": smi})
    if failed or ragged:
        raise PhaseFailed("the 8B serve-bench modes failed their checks",
                          failed + (["launches_ragged"] if ragged else []))
    del hooks
    gc.collect()
    return {"launches": sum(launches.values()), "launches_by_bench": launches, "wall_s": wall}


# ------------------------------------------------------- phase 4d: one-request API
GEN_MAIN = dict(lengths=(87, 130, 64, 200), new_tokens=64)
#: Card against CPU in the debug config (fp32, TF32 off; flash kernels on the card,
#: the einsum attention on the CPU): log-probabilities of order 1-10.
SCORE_TOL = {"score_max_abs": 1e-3, "perplexity_rel": 1e-4}


def _left_padded(rng, vocab: int, lengths) -> tuple[np.ndarray, np.ndarray]:
    width = max(lengths)
    prompt = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), bool)
    for i, n in enumerate(lengths):
        prompt[i, width - n:] = rng.integers(1, vocab, n)
        mask[i, width - n:] = True
    return prompt, mask


def phase_generate(dev) -> dict:
    """``llama.generate``, ``score`` and ``perplexity`` on the card. ``debug`` fp32:
    greedy tokens of 4 left-padded prompts (an EOS inside the stream, padded after)
    identical to the CPU's, ``score`` and ``perplexity`` (with and without a mask)
    within ``SCORE_TOL`` of the CPU's. Llama-3-8B, bf16, full depth: 4 left-padded
    prompts, 64 new tokens: the first call runs its first decode step eagerly and
    captures the step, the second replays the kept graph for all 63; time per token of
    the second call, and of its decode steps alone (the call less its prefill, timed
    alone)."""
    from accelerate_tpu_torch import generation
    from accelerate_tpu_torch.generation import GenerationConfig, generate_loop
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to

    res = {"phase": "generate"}
    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32)
    params_cpu = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    params_gpu = params_to(params_cpu, dev)
    rng = np.random.default_rng(11)
    prompt, mask = _left_padded(rng, cfg.vocab_size, (40, 25, 33, 12))
    probe = llama.generate(params_cpu, prompt, cfg, GenerationConfig(max_new_tokens=24),
                           prompt_mask=mask)[1].tolist()
    # Row 1's EOS: its first emission from 6 on that it has not emitted before.
    j = next(j for j in range(6, 24) if probe[j] not in probe[:j])
    gen = GenerationConfig(max_new_tokens=24, eos_token_id=probe[j], pad_token_id=0)
    want = llama.generate(params_cpu, prompt, cfg, gen, prompt_mask=mask)
    got = llama.generate(params_gpu, prompt, cfg, gen, prompt_mask=mask).cpu()
    step = generate_loop.last_step
    tokens = rng.integers(1, cfg.vocab_size, (4, 48)).astype(np.int64)
    smask = np.ones((4, 48), bool)
    smask[0, :10] = smask[2, :30] = False
    score_err, ppl_err = {}, {}
    for name, m in (("no_mask", None), ("mask", smask)):
        ms = None if m is None else torch.from_numpy(m)
        s_cpu = llama.score(params_cpu, torch.from_numpy(tokens), cfg, ms)
        s_gpu = llama.score(params_gpu, torch.from_numpy(tokens).to(dev), cfg,
                            None if ms is None else ms.to(dev)).cpu()
        p_cpu = float(llama.perplexity(params_cpu, torch.from_numpy(tokens), cfg, ms))
        p_gpu = float(llama.perplexity(params_gpu, torch.from_numpy(tokens).to(dev), cfg,
                                       None if ms is None else ms.to(dev)))
        score_err[name] = float((s_cpu - s_gpu).abs().max())
        ppl_err[name] = abs(p_gpu - p_cpu) / p_cpu
    res["debug"] = {
        "tokens_equal_cpu": bool(torch.equal(got, want)),
        "eos_padded": bool((want[1, j + 1:] == 0).all()) and int(want[1, j]) == probe[j],
        "decode_replays": step.replays, "kernel_nodes": step.nodes(),
        "score_max_abs_err": score_err, "perplexity_rel_err": ppl_err, "tol": SCORE_TOL}
    ok_debug = (res["debug"]["tokens_equal_cpu"] and res["debug"]["eos_padded"]
                and step.replays == gen.max_new_tokens - 2
                and max(score_err.values()) <= SCORE_TOL["score_max_abs"]
                and max(ppl_err.values()) <= SCORE_TOL["perplexity_rel"])
    del params_gpu

    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16)
    params = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    prompt, mask = _left_padded(rng, cfg.vocab_size, GEN_MAIN["lengths"])
    n = GEN_MAIN["new_tokens"]
    gen = GenerationConfig(max_new_tokens=n)
    t0 = time.perf_counter()
    llama.generate(params, prompt, cfg, gen, prompt_mask=mask)  # builds and captures
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    step = generate_loop.last_step
    replays = step.replays
    t0 = time.perf_counter()
    out = llama.generate(params, prompt, cfg, gen, prompt_mask=mask)  # replays only
    host = out.cpu()  # the one host read
    call_s = time.perf_counter() - t0
    replays = step.replays - replays
    prefill_fn = llama.generate_fns(cfg, -(-(prompt.shape[1] + n) // 64) * 64)[0]
    p_t, m_t = torch.from_numpy(prompt).to(dev), torch.from_numpy(mask).to(dev)
    prefill_fn(params, p_t, m_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_fn(params, p_t, m_t)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    res["llama3_8b"] = {
        "batch": len(GEN_MAIN["lengths"]), "prompt_lengths": list(GEN_MAIN["lengths"]),
        "new_tokens": n, "first_call_ms": 1e3 * first_call_s,
        "call_ms": 1e3 * call_s, "ms_per_token": 1e3 * call_s / n,
        "prefill_ms": 1e3 * prefill_s,
        "decode_ms_per_token": 1e3 * (call_s - prefill_s) / (n - 1),
        "tokens_per_s": len(GEN_MAIN["lengths"]) * n / call_s,
        "decode_replays": replays, "graph_reused": generate_loop.last_step is step,
        "kernel_nodes": step.nodes(), "capture_s": step.capture_s,
        "pool_bytes": step.pool_bytes, "shape": list(host.shape),
        "tokens_in_range": bool(((host >= 0) & (host < cfg.vocab_size)).all())}
    ok_8b = (res["llama3_8b"]["tokens_in_range"] and list(host.shape) == [len(mask), n]
             and res["llama3_8b"]["graph_reused"] and replays == n - 1)
    res["ok"] = ok_debug and ok_8b
    emit(res)
    # The kept decode graphs and prefill caches hold device memory the later phases need.
    generation.release_generate_caches()
    if not res["ok"]:
        raise PhaseFailed("generate on the card failed its checks",
                          [k for k, v in (("debug", ok_debug), ("llama3_8b", ok_8b)) if not v])
    return res


def one_kernel_per_call(prof: dict, int8: bool) -> None:
    """The profiled decode window ran one device kernel per launch of each port kernel
    (paged attention; with ``int8``, the int8 matmul too), and launched it."""
    names = ["paged_attention"] + (["int8_mm"] if int8 else [])
    launch_key = {"paged_attention": "paged_attention_launches_per_step",
                  "int8_mm": "int8_matmul_launches_per_step"}
    bad = {n: [prof[f"{n}_kernels_per_step"], prof[launch_key[n]]] for n in names
           if prof[f"{n}_kernels_per_step"] is None or prof[launch_key[n]] <= 0
           or prof[f"{n}_kernels_per_step"] != prof[launch_key[n]]}
    if bad:
        raise PhaseFailed("device kernels per step differ from the wrapper's launches "
                          "([device kernels, launches] per step; device records' first "
                          f"and last µs {prof['device_records_first_last_us']}; "
                          f"{prof['profiler_clock_check']})", bad)


#: Kernel names (as the driver gives them) of each port kernel's launches in a CUDA
#: graph: the kernel a launch of that route runs first.
PAGED_KERNELS = ("paged_attention_cluster_kernel", "paged_attention_partial")
INT8_KERNELS = ("int8_mm_cluster_kernel", "int8_mm_bf16_kernel", "int8_mm_f32_kernel")


def replayed_launches(runners, names) -> int:
    """Launches made by replaying the CUDA graphs of ``runners`` (``CapturedStep``s;
    plain functions are skipped): each graph's kernel nodes of ``names`` times its
    replays. The wrappers count the eager launches; a captured call counts nothing."""
    return sum(r.nodes(n) * r.replays for r in runners if hasattr(r, "nodes") for n in names)


def path_launches(eng) -> tuple[int, int]:
    """(paged attention, int8 matmul) launches so far: the wrappers' counts plus the
    replays of ``eng``'s graphs (super-steps, prefill programs, speculative super-steps
    and the drafter's rounds)."""
    from accelerate_tpu_torch.ops.paged_attention import paged_attention
    from accelerate_tpu_torch.ops.quantization import int8_matmul

    graphs = (list(eng.graphs.values()) + list(eng.prefill_graphs.values())
              + list(eng.spec_graphs.values())
              + list(getattr(eng.drafter, "graphs", {}).values()))
    return (paged_attention.launches + replayed_launches(graphs, PAGED_KERNELS),
            int8_matmul.launches + replayed_launches(graphs, INT8_KERNELS))


def profile_decode(eng, rng, vocab: int, steps: int = 5) -> dict:
    """Where a decode step's time goes: ``steps`` decode dispatches with all lanes busy
    (each ``eng.multi_step`` tokens a lane), under ``torch.profiler`` (after the counted
    run, so its cost touches no other number). Device busy time is the sum of the
    kernels' own device time. A super-step's graph is then replayed 5 times back to
    back between CUDA events (the same inputs: it writes the same K/V again) for its
    device time with no host work between replays."""
    from torch.profiler import ProfilerActivity, profile

    n = eng.multi_step
    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, vocab, 200), max_new_tokens=(steps + 3) * n + 2)
    eng.step()  # admissions + the first decode step
    eng.step()
    torch.cuda.synchronize()
    before = path_launches(eng)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_lead_in()
        with torch.profiler.record_function(PROFILE_WINDOW):
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        time.sleep(PROFILE_EDGE_S)
    after = path_launches(eng)
    launches = (after[0] - before[0], after[1] - before[1])
    replay_ms = None
    if n > 1:
        graph = eng.graphs[(n, False, eng.paged)]
        replay_ms = _events_ms(lambda _: graph.graph.replay(), 5)
    eng.run()
    # The window's device records: those after half the lead-in's idle (the host's
    # clock and the card's mapped one agree to a few ms). Its host range closes after a
    # synchronize, so its end follows every record's unless the card's clock is mapped
    # late onto the host's (what the idle at the window's end absorbs).
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.events()
    window = next((e.time_range for e in events
                   if e.name == PROFILE_WINDOW and e.device_type == cpu), None)
    cut = window.start - 1e6 * PROFILE_LEAD_IN_S / 2
    records = [e for e in events if e.device_type == cuda and e.name != PROFILE_WINDOW]
    device = [e for e in records if e.time_range.start >= cut]
    # Device time as the union of the kernels' intervals: a kernel launched as a
    # programmatic dependent (the int8 matmul) starts before the one ahead of it ends,
    # so the sum of kernel durations counts that overlap twice.
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in device]
    first_us = min((a for _, a, _ in spans), default=None)
    last_us = max((b for _, _, b in spans), default=None)
    clock_check = {"window_end_after_last_device_us":
                       None if last_us is None else window.end - last_us,
                   "lead_in_records": len(records) - len(device),
                   "lead_in_launched": PROFILE_LEAD_IN + 1}

    def union_ms(stem=""):
        ivs = sorted((a, b) for n, a, b in spans if stem in n)
        total, end = 0.0, -math.inf
        for a, b in ivs:
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3 / steps

    kernels, counts = {}, {}
    for name, a, b in spans:
        kernels[name] = kernels.get(name, 0) + b - a
        counts[name] = counts.get(name, 0) + 1
    n_launch = len(spans)
    busy_ms = sum(kernels.values()) / 1e3 / steps

    def group_ms(*names):
        return sum(v for k, v in kernels.items() if any(n in k for n in names)) / 1e3 / steps

    def group_count(name):
        return sum(c for k, c in counts.items() if name in k) / steps

    attn_ms = group_ms("paged_attention")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {
        "phase": "decode_profile", "steps": steps, "lanes": eng.max_slots,
        "tokens_per_lane_per_step": n,
        "wall_ms_per_step_profiled": wall_ms,
        "wall_ms_per_token_step_profiled": wall_ms / n,
        "graph_replay_device_ms_per_step": replay_ms,
        "device_idle_share_from_replay": (1 - replay_ms / wall_ms) if replay_ms else None,
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
        "device_records_first_last_us": [first_us, last_us],
        "profiler_clock_check": clock_check,
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


# -------------------------------------------- phases 17-18: training I/O (slice 11)
RESUME_STEPS = 3  # steps between the save and the end of each round
# Depth of train_resume's model (cut from TRAIN_LAYERS' 8 in slice 18): the card's host
# takes at most 45 GiB of disk writes a run, and two 8-layer checkpoints wrote 67 GB.
RESUME_LAYERS = 1  # 2 in slice 18; 1 since slice 19 to keep the script's time in bound
RESUME_CORPUS_TOKENS = 1 << 24  # 64 MB of int32 tokens
BUILD_ROOT = Path(__file__).resolve().parent / "build"  # git-ignored


def _meminfo(key: str) -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(key)


def _host_room(where: Path) -> dict:
    return {"disk_free_bytes": shutil.disk_usage(where).free,
            "mem_available_bytes": _meminfo("MemAvailable")}


def leaf_checksums(state) -> list:
    """Per tensor leaf of the train state (params, moments): ``_checksum``'s two sums."""
    from accelerate_tpu_torch.utils.tree import tree_leaves

    return [_checksum(t) for t in tree_leaves([state.params, state.opt_state, state.grad_accum])
            if torch.is_tensor(t)]


def _checksum(t: torch.Tensor) -> tuple:
    """Two 64-bit sums of a tensor's words on its device (plain, and weighted by an odd
    multiplier of the position, so that moved words change it too), in chunks of 2^26."""
    words = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    plain = weighted = torch.zeros((), dtype=torch.int64, device=t.device)
    for start in range(0, words.numel(), 1 << 26):
        x = words[start:start + (1 << 26)].to(torch.int64)
        pos = torch.arange(start, start + x.numel(), device=t.device, dtype=torch.int64)
        plain = plain + x.sum()
        weighted = weighted + (x * (2 * pos + 1)).sum()
    return int(plain), int(weighted)


class _Counter:
    """A custom object registered for checkpointing: a count of steps seen."""

    def __init__(self):
        self.count = 0

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, sd):
        self.count = sd["count"]


class _WarmupSchedule:
    """A stateful scheduler (``step``/``state_dict``/``load_state_dict``), prepared and
    so saved with the checkpoint: a linear warm-up factor over 10 steps."""

    def __init__(self):
        self.last_epoch = 0

    def step(self):
        self.last_epoch += 1

    def get_last_lr(self):
        return [min(1.0, self.last_epoch / 10)]

    def state_dict(self):
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, sd):
        self.last_epoch = sd["last_epoch"]


def _train_counts(fa, fo) -> dict:
    return {"flash_fwd": fa._fwd.launches, "flash_bwd_dq": fa._bwd_dq.launches,
            "flash_bwd_dkv": fa._bwd_dkv.launches, "fused_adamw": fo.adamw_leaves.launches}


def _reset_train_counts(fa, fo) -> None:
    fa._fwd.launches = fa._bwd_dq.launches = fa._bwd_dkv.launches = 0
    fo.adamw_leaves.launches = 0


# ------------------------------ slice 22: accumulate(), clip_grad_*_ and no_sync() at 8B
ACCUM_LAYERS = 1
ACCUM_STEPS = 2  # gradient_accumulation_steps
ACCUM_BATCHES = 4
ACCUM_NORM = 1.0  # the global-norm clip of arms A and B
ACCUM_CLAMP_TARGET = 0.02  # share of the first window's averaged gradient the clamp aims at
ACCUM_CLAMP_MIN = 0.01  # the share it must reach
ACCUM_MAX_S = 10.0


def _leaf_diff(a: list, b: list) -> dict:
    """max |a - b| over two lists of tensors, and the share of elements that differ."""
    worst, differ, total = 0.0, 0, 0
    for x, y in zip(a, b):
        d = (x.float() - y.float()).abs()
        worst = max(worst, float(d.max()))
        differ += int((d > 0).sum())
        total += d.numel()
    return {"max_abs": worst, "share_differing": differ / total}


def phase_train_accumulate(dev) -> dict:
    """HF Accelerate's loop surface on the training path at Llama-3-8B's width, depth cut
    to ACCUM_LAYERS: bf16 over fp32 masters, remat, flash attention, chunked CE,
    ``fused_adamw(1e-4)``, B=2, S=2048, ``gradient_accumulation_steps=2``, four seeded
    batches through three arms:

    - A: a fresh ``Accelerator``, ``clip_grad_value_(v)`` and ``clip_grad_norm_(n)``,
      then ``build_train_step``; each step inside ``with acc.accumulate():``;
    - B: ``Accelerator(max_grad_norm=n)`` and ``build_train_step(max_grad_value=v)``,
      called plainly (run twice: B against B measures the path's own repeat spread);
    - C: as B without a clip (the planted fault).

    ``v`` clamps about ACCUM_CLAMP_TARGET of the first window's averaged gradient
    (``value_and_grad`` of batches 0 and 1; at least ACCUM_CLAMP_MIN checked). Checks:
    the sync flags ``[False, True, False, True]`` in A and B; A's params, losses and grad
    norms equal B's bit for bit (or within B's own spread, if the path does not repeat
    its bits); C's params at least 10× that spread away; a ``no_sync()`` window of two
    batches leaves the params as they were and the accumulation buffer equal to the sum
    of both gradients; #2–#4 and #9 launched 2L/L/L and once an apply in every arm;
    the whole phase within ACCUM_MAX_S seconds."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    _fresh_state_singletons()
    L = ACCUM_LAYERS
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=L, dtype=torch.bfloat16,
                              attn_impl="flash", remat=True, remat_policy="full")
    rng = np.random.default_rng(22)
    batches = [{"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1)), device=dev)}
        for _ in range(ACCUM_BATCHES)]
    init = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                             generator=torch.Generator(dev).manual_seed(0), device=dev)
    init_leaves = tree_leaves(init)

    def loss(p, b):
        return llama.loss_fn(p, b, cfg)

    # The first window's gradients through value_and_grad (batch 0 twice: its spread).
    acc = Accelerator(mixed_precision="bf16", device=dev)
    vg = acc.value_and_grad(loss)
    _reset_train_counts(fa, fo)
    g0 = tree_leaves(vg(init, batches[0])[1])
    g0_again = tree_leaves(vg(init, batches[0])[1])
    grad_spread = _leaf_diff(g0, g0_again)["max_abs"]
    del g0_again
    g_sum = [x + y for x, y in zip(g0, tree_leaves(vg(init, batches[1])[1]))]
    del g0
    vg_launches = _train_counts(fa, fo)
    with torch.no_grad():
        sample = torch.cat([(g / ACCUM_STEPS).abs().reshape(-1)[::61] for g in g_sum])
        clamp = float(sample.sort().values[int((1 - ACCUM_CLAMP_TARGET) * (sample.numel() - 1))])
        clamped = sum(int(((g / ACCUM_STEPS).abs() > clamp).sum()) for g in g_sum)
    clamped_share = clamped / sum(g.numel() for g in g_sum)
    del sample

    per_batch = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "fused_adamw": 0}
    expect = {k: v * ACCUM_BATCHES for k, v in per_batch.items()}
    expect["fused_adamw"] = ACCUM_BATCHES // ACCUM_STEPS

    def arm(route: str, clip: bool) -> dict:
        _fresh_state_singletons()
        kw = {"max_grad_norm": ACCUM_NORM} if route == "constructor" and clip else {}
        acc = Accelerator(mixed_precision="bf16", device=dev,
                          gradient_accumulation_steps=ACCUM_STEPS, **kw)
        state = acc.create_train_state(_clone_to(init, dev), fo.fused_adamw(1e-4))
        if route == "context":
            acc.clip_grad_value_(clamp)
            acc.clip_grad_norm_(ACCUM_NORM)
            step = acc.build_train_step(loss)
        else:
            step = acc.build_train_step(loss, max_grad_value=clamp if clip else None)
        _reset_train_counts(fa, fo)
        run = {"flags": [], "losses": [], "grad_norms": []}
        for batch in batches:
            with acc.accumulate() if route == "context" else contextlib.nullcontext():
                state, metrics = step(state, batch)
            run["flags"].append(acc.sync_gradients)
            run["losses"].append(float(metrics["loss"]))
            if "grad_norm" in metrics:
                run["grad_norms"].append(float(metrics["grad_norm"]))
        run["launches"] = _train_counts(fa, fo)
        run["params"] = tree_leaves(state.params)
        return run

    t_arms = time.perf_counter()
    b = arm("constructor", clip=True)
    b_params = b.pop("params")
    b2 = arm("constructor", clip=True)
    spread = _leaf_diff(b2.pop("params"), b_params)["max_abs"]
    a = arm("context", clip=True)
    a_diff = _leaf_diff(a.pop("params"), b_params)
    c = arm("constructor", clip=False)
    c_diff = _leaf_diff(c.pop("params"), b_params)
    del b_params
    arms_s = time.perf_counter() - t_arms

    # no_sync(): two batches accumulate and nothing is applied.
    _fresh_state_singletons()
    acc = Accelerator(mixed_precision="bf16", device=dev, gradient_accumulation_steps=ACCUM_STEPS)
    state = acc.create_train_state(_clone_to(init, dev), fo.fused_adamw(1e-4))
    step = acc.build_train_step(loss)
    _reset_train_counts(fa, fo)
    inside = []
    with acc.no_sync():
        for batch in batches[:2]:
            state, _ = step(state, batch)
            inside.append(acc.sync_gradients)
    no_sync = {"flags_inside": inside, "flag_after": acc.sync_gradients,
               "step": state.step, "micro": state.micro,
               "params_unchanged": all(torch.equal(x, y) for x, y in
                                       zip(tree_leaves(state.params), init_leaves)),
               "accum_vs_sum": _leaf_diff(tree_leaves(state.grad_accum), g_sum),
               "launches": _train_counts(fa, fo)}
    del state, step, g_sum, init, init_leaves
    _fresh_state_singletons()
    gc.collect()
    torch.cuda.empty_cache()

    want_flags = [(i + 1) % ACCUM_STEPS == 0 for i in range(ACCUM_BATCHES)]
    bitwise = spread == 0.0
    checks = {
        "flags": a["flags"] == b["flags"] == want_flags,
        "clamp_share": clamped_share >= ACCUM_CLAMP_MIN,
        "a_equals_b": (a_diff["max_abs"] == 0.0 if bitwise else a_diff["max_abs"] <= spread)
        and (not bitwise or (a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"])),
        "planted_fault_caught": c_diff["max_abs"] > 10 * spread,
        "no_sync": inside == [False, False] and no_sync["flag_after"]
        and no_sync["step"] == 0 and no_sync["micro"] == 2 and no_sync["params_unchanged"]
        and no_sync["accum_vs_sum"]["max_abs"] <= 2 * grad_spread,
        "launches": all(r["launches"] == expect for r in (a, b, b2, c))
        and no_sync["launches"] == {k: v * 2 for k, v in per_batch.items()}
        and vg_launches == {k: v * 3 for k, v in per_batch.items()},
        "finite": all(np.isfinite(r["losses"]).all() for r in (a, b, c)),
    }
    phase_s = time.perf_counter() - t_phase
    checks["within_time"] = phase_s <= ACCUM_MAX_S
    res = {"phase": "train_accumulate", "config": "llama3-8b", "layers": L,
           "cut": f"depth {L} of 32 layers; widths as published", "batch": [TRAIN_B, TRAIN_S],
           "gradient_accumulation_steps": ACCUM_STEPS, "batches": ACCUM_BATCHES,
           "clip_grad_norm": ACCUM_NORM, "clip_grad_value": clamp,
           "clamped_share_first_window": clamped_share, "grad_repeat_spread": grad_spread,
           "b_repeat_spread": spread, "bit_reproducible": bitwise,
           "a_vs_b": a_diff, "c_vs_b": c_diff, "arms": {"A_context": a, "B_constructor": b,
                                                       "B_again": b2, "C_no_clip": c},
           "no_sync": no_sync, "value_and_grad_launches": vg_launches,
           "launches_expected": expect, "launches": a["launches"], "arms_s": arms_s,
           "phase_s": phase_s, "max_s": ACCUM_MAX_S, "checks": checks,
           "ok": all(checks.values())}
    emit(res)
    if not res["ok"]:
        raise PhaseFailed("accumulate/clip/no_sync failed its checks",
                          [k for k, v in checks.items() if not v])
    return res


def phase_train_resume(dev) -> dict:
    """Save and resume at ``train_main``'s configuration but RESUME_LAYERS layers
    (Llama-3-8B widths, B=2, S=2048, bf16 over fp32 masters, remat, flash attention, chunked CE,
    ``fused_adamw(1e-4)``, clip 1.0), fed by a stateful ``DataLoaderShard`` over a
    ``TokenDataset`` of 2^24 seeded tokens, with a custom object and a scheduler
    registered. Round 1: 3 steps, ``save_state()``, 3 steps (losses, batches, per-leaf
    checksums), ``load_state()`` in place, the loader re-iterated from its restored
    position, the 3 steps again: losses bitwise, every leaf's checksums and the loader's
    batches equal, the first layer's leaves ``torch.equal`` to host copies. Round 2: the
    checkpoint deleted, ``save_state(async_save=True)``, the 3 steps run while the files
    are written, ``wait_for_checkpoint()``, load, the same checks. Then step ms with
    loader batches against the fixed on-device batch, alternated, and the native
    gather's host ms per batch. Peak device memory of the save and load may exceed the
    training peak by at most the staging buffers; launches per step as train_main's."""
    from accelerate_tpu_torch import checkpointing as ck
    from accelerate_tpu_torch import lm_dataset
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import DataLoader
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.utils.dataclasses import (DataLoaderConfiguration,
                                                        ProjectConfiguration)
    from accelerate_tpu_torch.utils.tree import tree_leaves

    _fresh_state_singletons()
    BUILD_ROOT.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_resume_", dir=BUILD_ROOT))
    res = {"phase": "train_resume", "config": "llama3-8b", "layers": RESUME_LAYERS,
           "batch": [TRAIN_B, TRAIN_S], "host_at_start": _host_room(root)}
    emit({"phase": "train_resume_host", **res["host_at_start"]})
    try:
        if not lm_dataset.native_available():
            raise PhaseFailed("the native gather (g++ build of lmdata.cpp) is unavailable",
                              ["native_available"])
        L = RESUME_LAYERS
        cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=L, dtype=torch.bfloat16,
                                  attn_impl="flash", remat=True, remat_policy="full")
        corpus = root / "corpus.bin"
        lm_dataset.write_token_file(np.random.default_rng(0).integers(
            0, cfg.vocab_size, RESUME_CORPUS_TOKENS, dtype=np.int32), str(corpus))
        dataset = lm_dataset.TokenDataset(str(corpus), seq_len=TRAIN_S, seed=0)
        acc = Accelerator(
            mixed_precision="bf16", device=dev,
            project_config=ProjectConfiguration(project_dir=str(root / "project"),
                                                automatic_checkpoint_naming=True),
            dataloader_config=DataLoaderConfiguration(use_stateful_dataloader=True,
                                                      non_blocking=True))
        loader = acc.prepare(DataLoader(dataset, batch_size=TRAIN_B, drop_last=True))
        counter, schedule = _Counter(), acc.prepare(_WarmupSchedule())
        acc.register_for_checkpointing(counter)
        torch.cuda.reset_peak_memory_stats()
        params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                                   generator=torch.Generator(dev).manual_seed(0), device=dev)
        state = acc.create_train_state(params, fo.fused_adamw(1e-4))
        del params
        step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
        first_layer = len(tree_leaves(state.params["layers"][0]))
        state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
            [state.params, state.opt_state]) if torch.is_tensor(t))
        res["state_bytes"] = state_bytes
        _reset_train_counts(fa, fo)
        n_steps = 0

        def train(state, it, n):
            nonlocal n_steps
            losses, batches = [], []
            for _ in range(n):
                batch = next(it)
                batches.append(batch["tokens"].cpu().numpy().copy())
                state, metrics = step(state, batch)
                schedule.step()
                counter.count += 1
                losses.append(float(metrics["loss"]))
                n_steps += 1
            return state, losses, batches

        def host_copies(state):
            return [t.detach().cpu() for t in tree_leaves(state.params["layers"][0])]

        rounds = {}
        it = iter(loader)
        state, warm, _ = train(state, it, RESUME_STEPS)
        torch.cuda.synchronize()
        res["train_peak_bytes"] = train_peak = torch.cuda.max_memory_allocated()
        res["losses_before_save"] = warm
        for name, async_save in (("sync", False), ("async", True)):
            if name == "async":  # one 8B checkpoint on disk at a time
                shutil.rmtree(root / "project" / "checkpoints")
            rnd = {"host_before_save": _host_room(root)}
            torch.cuda.reset_peak_memory_stats()
            allocated = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            path = acc.save_state(train_state=state, async_save=async_save)
            rnd["save_call_s"] = time.perf_counter() - t0
            rnd["save_peak_bytes"] = torch.cuda.max_memory_allocated()
            rnd["save_allocated_growth_bytes"] = rnd["save_peak_bytes"] - allocated
            saved_at = (state.step, counter.count, schedule.last_epoch)
            state, losses, batches = train(state, it, RESUME_STEPS)
            if async_save:
                t0 = time.perf_counter()
                acc.wait_for_checkpoint()
                rnd["wait_s"] = time.perf_counter() - t0
            rnd["save"] = dict(acc.checkpoint_stats["save"])
            rnd["bytes_on_disk"] = sum(p.stat().st_size for p in Path(path).rglob("*")
                                       if p.is_file())
            sums, copies = leaf_checksums(state), host_copies(state)
            end_at = (state.step, counter.count, schedule.last_epoch)
            torch.cuda.reset_peak_memory_stats()
            allocated = torch.cuda.memory_allocated()
            state = acc.load_state(train_state=state)
            rnd["load_peak_bytes"] = torch.cuda.max_memory_allocated()
            rnd["load_allocated_growth_bytes"] = rnd["load_peak_bytes"] - allocated
            rnd["load"] = dict(acc.checkpoint_stats["load"])
            rnd["restored_at"] = [state.step, counter.count, schedule.last_epoch]
            it = iter(loader)  # resumes at the loader's saved position
            state, again, again_batches = train(state, it, RESUME_STEPS)
            rnd["losses"], rnd["losses_resumed"] = losses, again
            rnd["losses_bitwise"] = again == losses
            rnd["batches_equal"] = all(np.array_equal(a, b) for a, b in zip(
                again_batches, batches, strict=True))
            new_sums = leaf_checksums(state)
            rnd["leaves"] = len(sums)
            rnd["leaf_checksums_equal"] = new_sums == sums
            rnd["first_layer_torch_equal"] = all(torch.equal(a, b) for a, b in zip(
                host_copies(state), copies, strict=True))
            rnd["counts_equal"] = (state.step, counter.count, schedule.last_epoch) == end_at
            rnd["restored_ok"] = rnd["restored_at"] == list(saved_at)
            staging = rnd["save"]["staging_bytes"]
            rnd["memory_ok"] = max(rnd["save_peak_bytes"], rnd["load_peak_bytes"]) <= (
                train_peak + staging)
            rnds = rnd["save"]
            rnd["save_gb_per_s"] = state_bytes / 1e9 / (rnds.get("total_s") or
                                                        rnds["commit_after_s"])
            rnd["load_gb_per_s"] = state_bytes / 1e9 / rnd["load"]["total_s"]
            rounds[name] = rnd
            emit({"phase": "train_resume_round", "round": name, "first_layer_leaves":
                  first_layer, **rnd})
        res["rounds"] = rounds
        launches = _train_counts(fa, fo)
        expect = {"flash_fwd": 2 * L * n_steps, "flash_bwd_dq": L * n_steps,
                  "flash_bwd_dkv": L * n_steps, "fused_adamw": n_steps}
        res["steps"], res["launches"], res["launches_expected"] = n_steps, launches, expect

        # Loader batches against train_main's fixed on-device batch, alternated.
        fixed = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1)), device=dev)}
        timing = {"loader": [], "fixed": [], "next_batch_host_ms": []}
        for i in range(8):
            which = ("loader", "fixed")[i % 2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "loader":
                batch = next(it)
                timing["next_batch_host_ms"].append(1e3 * (time.perf_counter() - t0))
            else:
                batch = fixed
            state, metrics = step(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            timing[which].append(1e3 * (time.perf_counter() - t0))
        res["step_ms"] = {k: timing[k] for k in ("loader", "fixed")}
        res["step_ms_median"] = {k: float(np.median(timing[k][1:])) for k in ("loader", "fixed")}
        res["next_batch_host_ms"] = timing["next_batch_host_ms"]

        def gather_ms(native: bool) -> float:
            """Host ms per batch over the epoch's first 200 batches."""
            saved = lm_dataset._load_native
            if not native:
                lm_dataset._load_native = lambda: None
            try:
                batches = dataset.iter_batches(TRAIN_B)
                t0 = time.perf_counter()
                for _ in range(200):
                    next(batches)
                return 1e3 * (time.perf_counter() - t0) / 200
            finally:
                lm_dataset._load_native = saved

        res["native_available"] = lm_dataset.native_available()
        # In turns, after a pass that maps the corpus pages both paths read.
        gather_ms(False)
        runs = {"native": [], "numpy": []}
        for native in (True, False, False, True):
            runs["native" if native else "numpy"].append(gather_ms(native))
        res["gather_host_ms_per_batch"] = runs
        res["host_at_end"] = _host_room(root)
        ok = {f"{name}_{k}": bool(rnd[k]) for name, rnd in rounds.items()
              for k in ("losses_bitwise", "batches_equal", "leaf_checksums_equal",
                        "first_layer_torch_equal", "counts_equal", "restored_ok", "memory_ok")}
        ok["launches"] = launches == expect
        ok["finite"] = bool(np.isfinite(warm + rounds["sync"]["losses"]).all())
        res["checks"] = ok
        res["ok"] = all(ok.values())
        emit({k: v for k, v in res.items() if k != "rounds"})  # the rounds were printed
        if not res["ok"]:
            raise PhaseFailed("save and resume at 8B width failed its checks",
                              [k for k, v in ok.items() if not v])
        acc.free_memory()
        return res
    finally:
        ck.wait_for_async_save()
        shutil.rmtree(root, ignore_errors=True)
        _fresh_state_singletons()


def phase_checkpoint_debug(dev) -> dict:
    """The ``debug`` config in fp32 on the card: save → train → load → retrain through the
    stateful loader, bitwise; a committed checkpoint with one byte flipped and an
    uncommitted one are both quarantined on load and the previous valid checkpoint is
    selected (``checkpoints_quarantined == 2``); an explicit corrupt ``input_dir``
    raises ``CheckpointCorruptError``; ``total_limit=2`` keeps the survivors the JAX rule
    keeps; a card checkpoint loads into a CPU ``Accelerator``'s state, and the next
    step's loss there equals the card's within the ``debug`` parity tolerance (1e-4
    relative)."""
    from accelerate_tpu_torch import checkpointing as ck
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import DataLoader
    from accelerate_tpu_torch.lm_dataset import TokenDataset, write_token_file
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.utils.dataclasses import (DataLoaderConfiguration,
                                                        ProjectConfiguration)

    BUILD_ROOT.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="checkpoint_debug_", dir=BUILD_ROOT))
    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32, attn_impl="flash")
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    write_token_file(np.random.default_rng(1).integers(0, cfg.vocab_size, 64 * 128 + 1),
                     str(root / "corpus.bin"))
    res = {"phase": "checkpoint_debug", "config": "debug"}

    def setup(where, project=None, **project_kw):
        _fresh_state_singletons()
        acc = Accelerator(device=where, project_config=ProjectConfiguration(
            project_dir=str(project or root / "project"), automatic_checkpoint_naming=True,
            **project_kw),
            dataloader_config=DataLoaderConfiguration(use_stateful_dataloader=True))
        loader = acc.prepare(DataLoader(TokenDataset(str(root / "corpus.bin"), seq_len=128,
                                                     seed=0), batch_size=2, drop_last=True))
        state = acc.create_train_state(_clone_to(params, where), fused_adamw(1e-3))
        step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
        return acc, loader, state, step

    def train(step, state, it, n):
        losses = []
        for _ in range(n):
            state, metrics = step(state, next(it))
            losses.append(float(metrics["loss"]))
        return state, losses

    try:
        acc, loader, state, step = setup(dev)
        it = iter(loader)
        state, _ = train(step, state, it, 2)
        acc.save_state(train_state=state)  # checkpoint_0, step 2
        state, losses = train(step, state, it, 3)
        sums = leaf_checksums(state)
        state = acc.load_state(train_state=state)
        it = iter(loader)
        state, again = train(step, state, it, 3)
        res["round_bitwise"] = again == losses and leaf_checksums(state) == sums

        # checkpoint_1 valid (step 5), checkpoint_2 corrupt (step 6), checkpoint_3
        # uncommitted (step 7): the load quarantines 3 and 2 and restores step 5.
        for _ in range(3):
            acc.save_state(train_state=state)
            state, _ = train(step, state, it, 1)
        base = root / "project" / "checkpoints"
        victim = sorted((base / "checkpoint_2" / "sharded_state").glob("*.bin"))[0]
        data = bytearray(victim.read_bytes())
        data[len(data) // 2] ^= 0xFF
        victim.write_bytes(bytes(data))
        (base / "checkpoint_3" / ck.COMMIT_MARKER).unlink()
        state = acc.load_state(train_state=state)
        res["quarantined"] = acc.checkpoints_quarantined
        res["fallback_step"] = state.step
        res["quarantine_dir"] = sorted(p.name for p in (base / ck.QUARANTINE_DIR).iterdir())
        try:
            acc.load_state(str(base / ck.QUARANTINE_DIR / "checkpoint_2"), train_state=state)
            res["explicit_corrupt_raised"] = False
        except ck.CheckpointCorruptError as e:
            res["explicit_corrupt_raised"] = "sha256 mismatch" in str(e)
        # Next step on the card from the restored step-5 state, for the CPU comparison.
        card_path = acc.save_state(str(root / "card"), train_state=state)
        card_batch = next(iter(loader))
        _, metrics = step(state, card_batch)
        card_loss = float(metrics["loss"])

        # Rotation: 5 saves with total_limit=2, the 4th crashed before its marker. The
        # JAX rule keeps limit - 1 committed snapshots before each save and never the
        # newest committed one: checkpoint_2 and checkpoint_4 survive (3 uncommitted).
        acc_r, _, state_r, _ = setup(dev, project=root / "rotation", total_limit=2)
        for i in range(5):
            acc_r.save_state(train_state=state_r)
            if i == 3:
                (root / "rotation" / "checkpoints" / "checkpoint_3" / ck.COMMIT_MARKER).unlink()
        res["rotation_survivors"] = sorted(
            p.name for p in (root / "rotation" / "checkpoints").glob("checkpoint_*"))
        res["rotation_expected"] = ["checkpoint_2", "checkpoint_3", "checkpoint_4"]

        # The card's checkpoint into a CPU accelerator's state, and its next step.
        acc_c, loader_c, state_c, step_c = setup("cpu", project=root / "cpu")
        state_c = acc_c.load_state(card_path, train_state=state_c)
        _, metrics = step_c(state_c, {"tokens": card_batch["tokens"].cpu()})
        cpu_loss = float(metrics["loss"])
        res.update(card_next_loss=card_loss, cpu_next_loss=cpu_loss,
                   cpu_loss_rel_err=abs(card_loss - cpu_loss) / abs(cpu_loss), cpu_tol_rel=1e-4)
        ok = {"round_bitwise": res["round_bitwise"], "quarantined": res["quarantined"] == 2,
              "fallback": res["fallback_step"] == 5,
              "quarantine_dir": res["quarantine_dir"] == ["checkpoint_2", "checkpoint_3"],
              "explicit_corrupt_raised": res["explicit_corrupt_raised"],
              "rotation": res["rotation_survivors"] == res["rotation_expected"],
              "cpu_load": res["cpu_loss_rel_err"] <= 1e-4}
        res["checks"], res["ok"] = ok, all(ok.values())
        emit(res)
        if not res["ok"]:
            raise PhaseFailed("checkpoint_debug failed its checks",
                              [k for k, v in ok.items() if not v])
        return res
    finally:
        ck.wait_for_async_save()
        shutil.rmtree(root, ignore_errors=True)
        _fresh_state_singletons()


# --------------------------------------- phases 22-23: elastic training (slice 18)
ELASTIC_LAYERS = 1  # fp32 masters and moments of 1 layer: a 15.2 GB state, 3 saved at once
# The elastic phase's checkpoints (four states, an export and a merge: 73 GB written) go
# to host memory: the card's host takes at most 45 GiB of disk writes a run.
SHM_ROOT = Path("/dev/shm")
ELASTIC_B, ELASTIC_S, ELASTIC_STEPS = 1, 2048, 6
ELASTIC_SAVES = (2, 4, 5)  # attempt 1 saves after these steps: good, corrupt, crashed
# Saves are the site's invocations 0, 1, 2: the second is corrupted after its marker,
# the third crashes before it. Attempt 2 finds its flag file and drops the plan.
ELASTIC_FAULTS = "ckpt.save:corrupt,start=1,max=1;ckpt.save:crash,start=2,max=1"
ELASTIC_KERNELS = ("flash_attention", "fused_adamw")
#: Config fields replaced in the workers (empty: Llama-3-8B's widths); a CPU rehearsal
#: shrinks them here and passes ``device``.
ELASTIC_OVERRIDES: dict = {}


def _named_checksums(named: dict, dev) -> dict:
    """``{name: checksum}`` of a flat dict of tensors, each moved to ``dev`` first."""
    return {k: list(_checksum(v.to(dev))) for k, v in named.items()}


def elastic_worker(spec: dict) -> int:
    """One process of ``elastic_train`` (``chip_smoke.py --elastic-worker SPEC``): Llama-3-8B
    widths at ELASTIC_LAYERS layers, bf16 over fp32 masters, remat, flash attention,
    chunked CE, ``fused_adamw(1e-4)``, clip 1.0, fed by a ``DataLoaderShard`` over the
    native ``TokenDataset``; ELASTIC_STEPS steps. A supervised worker's first attempt
    (no flag file yet) saves after the ELASTIC_SAVES steps under ``ACCELERATE_FAULTS``;
    its second drops the plan, loads the newest valid checkpoint (automatic naming:
    quarantining the invalid ones), skips the batches already trained with
    ``skip_first_batches``, finishes and saves with ``safe_serialization=True``. The
    result (losses, leaf checksums, save and load stats, launches, kernel builds) goes to
    ``spec["result"]`` as JSON, even when an injected fault ends the attempt."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import DataLoader
    from accelerate_tpu_torch.lm_dataset import TokenDataset
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.telemetry import CompileMonitor
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration
    from accelerate_tpu_torch.utils.tree import named_parameters
    import accelerate_tpu_torch.checkpointing  # noqa: F401  (imported before the preload)

    t_start = time.perf_counter()
    preload_dynamo()  # loads while the worker sets up (and, resuming, reads its checkpoint)
    monitor = CompileMonitor().start()
    root = Path(spec["root"])
    res = {"role": spec["role"], "attempt": 1, "started_unix": time.time(),
           "libraries_missing": [n for n in ELASTIC_KERNELS
                                 if not _build._lib_path(n).exists()]}
    flag = spec.get("flag")
    if flag is not None:
        if os.path.exists(flag):
            res["attempt"] = 2
            os.environ.pop("ACCELERATE_FAULTS", None)
        else:
            Path(flag).write_text("attempt 1")
    saves, losses = [], []
    try:
        dev = torch.device(spec["device"])
        cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], **{
            "n_layers": ELASTIC_LAYERS, "dtype": torch.bfloat16, "attn_impl": "flash",
            "remat": True, "remat_policy": "full", **spec["overrides"]})
        acc = Accelerator(mixed_precision="bf16", device=dev, project_config=ProjectConfiguration(
            project_dir=str(root / "project"), automatic_checkpoint_naming=True))
        res["fault_plan"] = None if acc.fault_plan is None else repr(acc.fault_plan)
        loader = acc.prepare(DataLoader(TokenDataset(spec["corpus"], seq_len=spec["seq_len"],
                                                     seed=0),
                                        batch_size=spec["batch"], drop_last=True))
        params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                                   generator=torch.Generator(dev).manual_seed(0), device=dev)
        state = acc.create_train_state(params, fo.fused_adamw(1e-4))
        del params
        step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
        res["state_bytes"] = sum(t.numel() * t.element_size() for t in named_parameters(
            {"p": state.params, "o": state.opt_state}).values() if torch.is_tensor(t))
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        res["setup_s"] = time.perf_counter() - t_start
        _reset_train_counts(fa, fo)
        start = 0
        if res["attempt"] == 2:
            t0 = time.perf_counter()
            state = acc.load_state(train_state=state)
            res["load_call_s"] = time.perf_counter() - t0
            res["load"] = dict(acc.checkpoint_stats["load"])
            start = res["resumed_from"] = state.step
            qdir = root / "project" / "checkpoints" / "quarantined"
            res["quarantined"] = acc.checkpoints_quarantined
            res["quarantine_dir"] = sorted(p.name for p in qdir.iterdir()) if qdir.exists() else []
            shutil.rmtree(qdir, ignore_errors=True)  # 36 GB of disk back before the final save
        t0 = time.perf_counter()
        step_s = res["step_s"] = []  # each step to its loss on the host
        for batch in acc.skip_first_batches(loader, start):
            s0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append([state.step, float(metrics["loss"])])
            step_s.append(time.perf_counter() - s0)
            if spec.get("saves") and res["attempt"] == 1 and state.step in ELASTIC_SAVES:
                s0 = time.perf_counter()
                path = acc.save_state(train_state=state)  # the crash propagates
                saves.append({"step": state.step, "path": Path(path).name,
                              "call_s": time.perf_counter() - s0,
                              **dict(acc.checkpoint_stats["save"])})
            if state.step >= ELASTIC_STEPS:
                break
        sync()
        res["train_s"] = time.perf_counter() - t0
        if spec.get("final_dir"):
            s0 = time.perf_counter()
            acc.save_state(spec["final_dir"], train_state=state, safe_serialization=True)
            saves.append({"step": state.step, "path": "final", "call_s": time.perf_counter() - s0,
                          **dict(acc.checkpoint_stats["save"])})
        res["final_step"] = state.step
        res["leaf_checksums"] = leaf_checksums(state)
        res["param_checksums"] = _named_checksums(named_parameters(state.params), dev)
        return 0
    finally:
        res["losses"], res["saves"] = losses, saves
        res["launches"] = _train_counts(fa, fo)
        res["kernel_builds"] = monitor.by_kind.get("kernel_build", 0)
        res["wall_s"] = time.perf_counter() - t_start
        res["ended_unix"] = time.time()
        Path(spec["result"]).write_text(json.dumps(res))


def _worker_cmd(mode: str, spec) -> list:
    return [sys.executable, str(Path(__file__).resolve()), mode, json.dumps(spec)]


def _safetensors_tensors(path: Path) -> dict:
    """Every tensor of ``path`` (mapped from the file): one safetensors file, or a
    directory of ``model.safetensors`` or of the shards its index names."""
    from accelerate_tpu_torch.utils.serialization import load_flat_safetensors

    if path.is_file():
        return load_flat_safetensors(path)
    index = path / "model.safetensors.index.json"
    files = (sorted(set(json.loads(index.read_text())["weight_map"].values()))
             if index.exists() else ["model.safetensors"])
    out = {}
    for name in files:
        out.update(load_flat_safetensors(path / name))
    return out


def _same_bytes(a: dict, b: dict) -> bool:
    """The same names, dtypes, shapes and bytes (on the host)."""
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and torch.equal(a[k].reshape(-1).view(torch.uint8), b[k].reshape(-1).view(torch.uint8))
        for k in a)


def phase_elastic_train(dev) -> dict:
    """Elastic, fault-injected, checkpointed training at Llama-3-8B's width
    (ELASTIC_LAYERS layers, B=1, S=2048, 6 steps; ``elastic_worker``). One worker runs under
    ``elastic.ElasticSupervisor(max_restarts=2)`` with an enabled ``Telemetry``: attempt
    1 saves a good checkpoint at step 2, one corrupted after its marker at step 4
    (``ckpt.save:corrupt``) and dies in step 5's save (``ckpt.save:crash``, an uncommitted
    directory); attempt 2 quarantines both, resumes from step 2 through
    ``skip_first_batches``, finishes and saves with ``safe_serialization=True``. An
    uninterrupted worker (no faults, no saves) runs beside it. Checks: 2 attempts,
    one ``elastic.restart/v1`` record, 2 quarantined, resumed from step 2, every final
    leaf (params and moments) and every loss of a step both ran bitwise equal to the
    uninterrupted worker's, ``model.safetensors`` and ``merge-weights``' output bitwise
    equal to the final params, no kernel built in a worker, and each worker's launches
    2L/L/L flash and 1 AdamW per step."""
    from accelerate_tpu_torch import lm_dataset
    from accelerate_tpu_torch.elastic import ElasticSupervisor
    from accelerate_tpu_torch.telemetry import ELASTIC_RESTART_SCHEMA, Telemetry, validate_record
    from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

    t_phase = time.perf_counter()
    _fresh_state_singletons()
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="elastic_train_", dir=SHM_ROOT))
    free, total = torch.cuda.mem_get_info()
    res = {"phase": "elastic_train", "config": "llama3-8b", "layers": ELASTIC_LAYERS,
           "batch": [ELASTIC_B, ELASTIC_S], "steps": ELASTIC_STEPS, "faults": ELASTIC_FAULTS,
           "cut": f"depth {ELASTIC_LAYERS} of 32 layers (three checkpoints of the train state "
                  "at once, in host memory); widths as published", "checkpoint_root": str(root),
           "host_at_start": _host_room(root), "device_free_bytes": free,
           "parent_allocated_bytes": torch.cuda.memory_allocated()}
    emit({"phase": "elastic_train_host", **res["host_at_start"], "device_free_bytes": free})
    children = []  # every process started here, stopped in the finally
    try:
        from accelerate_tpu_torch.models import llama

        n_params = llama.num_params(dataclasses.replace(
            llama.CONFIGS["llama3-8b"], **{"n_layers": ELASTIC_LAYERS, **ELASTIC_OVERRIDES}))
        # Three states in /dev/shm at once, and two workers on the card at once (the
        # uninterrupted one beside the supervised one), each a state and its activations.
        res["host_bytes_needed"] = host_need = int(3.5 * 12 * n_params)
        res["device_bytes_needed"] = device_need = int(2 * 1.5 * 12 * n_params)
        if res["host_at_start"]["mem_available_bytes"] < host_need or free < device_need:
            raise PhaseFailed("not enough host or device memory for the elastic phase",
                              {"mem_available_bytes": res["host_at_start"]["mem_available_bytes"],
                               "host_needed": host_need, "device_free_bytes": free,
                               "device_needed": device_need})
        walls = {}
        corpus = root / "corpus.bin"
        lm_dataset.write_token_file(np.random.default_rng(0).integers(
            0, ELASTIC_OVERRIDES.get("vocab_size", 128256), ELASTIC_B * (ELASTIC_S + 1) * 16,
            dtype=np.int32), str(corpus))
        common = {"corpus": str(corpus), "device": str(dev), "overrides": ELASTIC_OVERRIDES,
                  "seq_len": ELASTIC_S, "batch": ELASTIC_B}
        base = {**common, "root": str(root / "baseline"), "role": "uninterrupted",
                "result": str(root / "baseline.json")}
        sup_spec = {**common, "root": str(root / "elastic"), "role": "supervised",
                    "saves": True, "flag": str(root / "attempt1.flag"),
                    "final_dir": str(root / "elastic" / "final")}
        env = {**os.environ, "ACCELERATE_FAULTS": ELASTIC_FAULTS}
        t0 = time.perf_counter()
        planned = [time.time()]  # when each worker was asked for: the baseline, attempts
        baseline = subprocess.Popen(_worker_cmd("--elastic-worker", base))
        children.append(baseline)
        results = []

        def make_plan(rendezvous):
            attempt = len(results) + 1
            results.append(str(root / f"attempt{attempt}.json"))
            planned.append(time.time())
            return [(_worker_cmd("--elastic-worker", {**sup_spec, "result": results[-1]}), env)]

        tel = Telemetry(TelemetryConfig(enabled=True, compile_events=False, memory_stats=False))
        sup = ElasticSupervisor(make_plan, max_restarts=2, monitor_interval=0.1, telemetry=tel)
        rc = sup.run()
        walls["supervised_s"] = time.perf_counter() - t0
        res["baseline_rc"] = baseline.wait()
        walls["with_baseline_s"] = time.perf_counter() - t0
        records = [r for r in tel.records if r.get("schema") == ELASTIC_RESTART_SCHEMA]
        res.update(supervisor_rc=rc, attempts=sup.attempts_used, restart_records=records,
                   restart_records_valid=all(validate_record(r) == [] for r in records))
        workers = [json.loads(Path(p).read_text()) for p in results]
        ref = json.loads(Path(base["result"]).read_text())
        emit({"phase": "elastic_train_workers", "wall_s": walls, "workers": [
            {k: w.get(k) for k in ("role", "attempt", "setup_s", "load_call_s", "train_s",
                                   "step_s", "wall_s", "final_step")}
            | {"saves_call_s": [s["call_s"] for s in w["saves"]]} for w in workers + [ref]]})
        a1, a2 = workers[0], workers[-1]
        res["exit_codes"] = [r["exit_codes"] for r in records] + [[rc]]
        # From the failed attempt's end to the next attempt's start (the supervisor's
        # teardown and poll, a fresh process and its imports), and to its state loaded.
        res["restart_s"] = a2["started_unix"] - a1["ended_unix"]
        # Each worker's start: from its process asked for to its worker function entered.
        res["worker_start_s"] = {"uninterrupted": ref["started_unix"] - planned[0],
                                 **{f"attempt{i + 1}": w["started_unix"] - planned[i + 1]
                                    for i, w in enumerate(workers)}}
        res["resume_s"] = res["restart_s"] + a2.get("setup_s", 0) + a2.get("load_call_s", 0)

        # The exported and the merged params against the final state's, on the card.
        final = Path(sup_spec["final_dir"])
        shutil.rmtree(root / "elastic" / "project", ignore_errors=True)
        # merge-weights runs while the export is checked.
        t0 = time.perf_counter()
        merge = subprocess.Popen([sys.executable, "-m", "accelerate_tpu_torch", "merge-weights",
                                  str(final), str(root / "merged")], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 cwd=Path(__file__).resolve().parent)
        children.append(merge)
        export = _safetensors_tensors(final / "model.safetensors")
        exported = _named_checksums(export, dev)  # against the worker's, on the card
        walls["export_check_s"] = time.perf_counter() - t0
        merge_out, merge_err = merge.communicate(timeout=600)
        walls["merge_s"] = time.perf_counter() - t0
        merged_equal = (merge.returncode == 0
                        and _same_bytes(_safetensors_tensors(root / "merged"), export))
        walls["merge_check_s"] = time.perf_counter() - t0
        res["merge"] = {"rc": merge.returncode, "stdout": merge_out[-500:],
                        "stderr": merge_err[-2000:],
                        "files": sorted(p.name for p in (root / "merged").glob("*"))}
        state_bytes = a2.get("state_bytes", 0)
        for w in [a1, a2, ref]:
            for s in w["saves"]:
                s["gb_per_s"] = state_bytes / 1e9 / s["total_s"] if s.get("total_s") else None
        if a2.get("load"):
            a2["load"]["gb_per_s"] = state_bytes / 1e9 / a2["load"]["total_s"]
        ref_losses = {s: l for s, l in ref["losses"]}
        L = ELASTIC_OVERRIDES.get("n_layers", ELASTIC_LAYERS)
        per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "fused_adamw": 1}
        launches = {"attempt1": a1["launches"], "attempt2": a2["launches"],
                    "uninterrupted": ref["launches"]}
        expect = {"attempt1": {k: v * len(a1["losses"]) for k, v in per_step.items()},
                  "attempt2": {k: v * len(a2["losses"]) for k, v in per_step.items()},
                  "uninterrupted": {k: v * ELASTIC_STEPS for k, v in per_step.items()}}
        res.update(
            workers=[{k: v for k, v in w.items() if k not in ("leaf_checksums",
                                                               "param_checksums")}
                     for w in workers + [ref]],
            state_bytes=state_bytes, launches=launches, launches_expected=expect,
            launches_total={k: sum(v[k] for v in launches.values()) for k in per_step},
            quarantined=a2.get("quarantined"), quarantine_dir=a2.get("quarantine_dir"),
            resumed_from=a2.get("resumed_from"), wall_s=walls,
            leaves=len(ref.get("leaf_checksums", [])))
        ok = {
            "two_attempts": rc == 0 and sup.attempts_used == 2 and len(workers) == 2,
            "one_restart_record": len(records) == 1 and records[0]["attempt"] == 0
            and records[0]["exit_codes"] == [1] and not records[0]["final"]
            and res["restart_records_valid"],
            "attempt1_faults": [s["step"] for s in a1["saves"]] == [2, 4]
            and a1["losses"][-1][0] == 5 and a1.get("fault_plan") is not None,
            "quarantined_two": a2.get("quarantined") == 2
            and a2.get("quarantine_dir") == ["checkpoint_1", "checkpoint_2"],
            "resumed_from_2": a2.get("resumed_from") == 2 and a2.get("final_step") == 6,
            "baseline_ok": res["baseline_rc"] == 0 and ref.get("final_step") == 6,
            "leaves_bitwise": bool(ref.get("leaf_checksums"))
            and a2.get("leaf_checksums") == ref["leaf_checksums"],
            "losses_bitwise": all(ref_losses.get(s) == l for s, l in a1["losses"] + a2["losses"]),
            "export_bitwise": bool(exported) and exported == a2.get("param_checksums"),
            "merge_bitwise": merged_equal,  # byte for byte the export, itself the params
            "no_kernel_build": all(w["kernel_builds"] == 0 and not w["libraries_missing"]
                                   for w in workers + [ref]),
            "launches": launches == expect,
            "finite": all(np.isfinite(l) for _, l in ref["losses"]),
        }
        res["checks"], res["ok"] = ok, all(ok.values())
        res["host_at_end"] = _host_room(root)
        res["phase_s"] = time.perf_counter() - t_phase
        emit(res)
        if not res["ok"]:
            raise PhaseFailed("elastic training failed its checks",
                              [k for k, v in ok.items() if not v])
        return res
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
        _fresh_state_singletons()


GANG_STEPS, GANG_DIE_AFTER = 6, 3  # rank 0 dies once, right after the step-3 checkpoint
GANG_LR = 1e-3


def _gang_batch(i: int, vocab: int) -> dict:
    return {"tokens": np.random.default_rng(100 + i).integers(0, vocab, (4, 129))}


def _gang_cfg():
    from accelerate_tpu_torch.models import llama

    return dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32, attn_impl="flash")


def gang_worker(out_dir: str, device: str) -> int:
    """One rank of ``elastic_gang`` (``chip_smoke.py --gang-worker DIR``, started by
    ``python -m accelerate_tpu_torch launch --multi-process``): the ``debug`` config in
    fp32 on the card over gloo (the two ranks share it; all-dp mesh), ``fused_adamw``,
    clip 1.0, GANG_STEPS steps of seeded global batches. Attempt 1 saves after step
    GANG_DIE_AFTER and rank 0 exits 17 (once: a flag file); attempt 2 loads that
    checkpoint and finishes. Each rank writes its result (and rank 0 the params)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.telemetry import CompileMonitor
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration

    t_start = time.perf_counter()
    monitor = CompileMonitor().start()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    rank = int(os.environ["RANK"])
    flag = out / "rank0_died"
    res = {"rank": rank, "attempt": 2 if flag.exists() else 1,
           "env": {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                                  "MASTER_ADDR", "MASTER_PORT")}}
    cfg = _gang_cfg()
    acc = Accelerator(device=device, backend="gloo", project_config=ProjectConfiguration(
        project_dir=str(out / "project"), automatic_checkpoint_naming=True))
    state = acc.create_train_state(
        llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        fo.fused_adamw(GANG_LR))
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    _reset_train_counts(fa, fo)
    if (out / "project" / "checkpoints").exists():
        state = acc.load_state(train_state=state)
    res["resumed_from"] = state.step
    losses = []
    while state.step < GANG_STEPS:
        state, metrics = step(state, _gang_batch(state.step, cfg.vocab_size))
        losses.append(float(metrics["loss"]))
        if state.step == GANG_DIE_AFTER and res["attempt"] == 1:
            acc.save_state(train_state=state)
            if rank == 0:
                flag.write_text("rank 0 died after the step-3 checkpoint")
                os._exit(17)
    res.update(losses=losses, world=acc.num_processes, launches=_train_counts(fa, fo),
               kernel_builds=monitor.by_kind.get("kernel_build", 0),
               wall_s=time.perf_counter() - t_start)
    if rank == 0:
        np.save(out / "params.npy", _flat_params(params_to_numpy(state.params)))
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    acc.wait_for_everyone()
    return 0


def start_elastic_gang(dev) -> dict:
    """The reference run of ``elastic_gang`` (one uninterrupted process on the card, the
    same global batches), then its launch started in the background: ``python -m
    accelerate_tpu_torch launch --multi-process --num-processes 2 --max-restarts 1
    chip_smoke.py --gang-worker DIR``. A thread waits for the launch (600 s at most, then
    its session is killed) and records its seconds. The launch's processes spend most of
    their time starting up and writing checkpoints, so it runs beside ``elastic_train``,
    whose workers do the same; :func:`phase_elastic_gang` waits for it and checks it."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw

    BUILD_ROOT.mkdir(exist_ok=True)
    run = {"out": Path(tempfile.mkdtemp(prefix="elastic_gang_", dir=BUILD_ROOT))}
    cfg = run["cfg"] = _gang_cfg()
    _fresh_state_singletons()
    acc = Accelerator(device=dev)
    state = acc.create_train_state(
        llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        fused_adamw(GANG_LR))
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    run["ref_losses"] = []
    for i in range(GANG_STEPS):
        state, metrics = step(state, _gang_batch(i, cfg.vocab_size))
        run["ref_losses"].append(float(metrics["loss"]))
    run["p_ref"] = _flat_params(params_to_numpy(state.params))
    del state, step
    _fresh_state_singletons()
    run["cmd"] = [sys.executable, "-m", "accelerate_tpu_torch", "launch", "--multi-process",
                  "--num-processes", "2", "--max-restarts", "1", str(Path(__file__).resolve()),
                  "--gang-worker", str(run["out"]), _rank_device(dev)]
    t0 = time.perf_counter()
    # A session of its own: on a time-out, or when the script stops early, the launch and
    # its ranks are killed together.
    launch = run["launch"] = subprocess.Popen(run["cmd"], stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True,
                                              start_new_session=True,
                                              cwd=Path(__file__).resolve().parent)

    def wait():
        try:
            run["stderr"] = launch.communicate(timeout=600)[1]
        except subprocess.TimeoutExpired:
            os.killpg(launch.pid, signal.SIGKILL)
            run["stderr"] = launch.communicate()[1]
        run["launch_s"] = time.perf_counter() - t0

    run["waiter"] = threading.Thread(target=wait, daemon=True)
    run["waiter"].start()
    return run


def stop_elastic_gang(run: dict) -> None:
    """Kill the gang's launch if it still runs (its whole session) and remove its files."""
    launch = run.get("launch")
    if launch is not None and launch.poll() is None:
        os.killpg(launch.pid, signal.SIGKILL)
    if run.get("waiter") is not None:
        run["waiter"].join()
    shutil.rmtree(run["out"], ignore_errors=True)


def phase_elastic_gang(dev, run: Optional[dict] = None) -> dict:
    """``python -m accelerate_tpu_torch launch --multi-process --num-processes 2
    --max-restarts 1 chip_smoke.py --gang-worker DIR``: two gloo ranks sharing the card
    (``gang_worker``); rank 0 dies once after the step-3 checkpoint, the supervisor tears
    rank 1 down and relaunches both on a fresh port; the gang resumes and finishes. Its
    final params against one uninterrupted process on the card (the same global
    batches) within ``train_tp_parity``'s fp32 tolerance; no kernel built in a rank.
    NCCL (one rank per card) needs a machine with several cards and is not run.
    ``run``: the launch :func:`start_elastic_gang` started (None: start it here)."""
    beside = run is not None
    run = run or start_elastic_gang(dev)
    try:
        run["waiter"].join()
        out, cfg, ref_losses, p_ref = run["out"], run["cfg"], run["ref_losses"], run["p_ref"]
        rc, stderr = run["launch"].returncode, run["stderr"]
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)
                 if (out / f"rank{r}.json").exists()]
        res = {"phase": "elastic_gang", "config": "debug", "command": " ".join(run["cmd"][1:]),
               "rc": rc, "launch_s": run["launch_s"],
               "ran_beside": "elastic_train" if beside else None, "ranks": ranks,
               "restart_lines": [l for l in stderr.splitlines() if "worker group" in l],
               "stderr_tail": stderr[-1500:], "losses_ref": ref_losses,
               "backend": "gloo (2 ranks share one card); NCCL, one rank per card, not run"}
        ok = {"rc": rc == 0, "died_once": (out / "rank0_died").exists(),
              "restarted": len(res["restart_lines"]) == 1 and "[17" in res["restart_lines"][0],
              "both_ranks_resumed": len(ranks) == 2 and all(
                  r["attempt"] == 2 and r["resumed_from"] == GANG_DIE_AFTER and r["world"] == 2
                  for r in ranks),
              "no_kernel_build": all(r["kernel_builds"] == 0 for r in ranks)}
        if ok["both_ranks_resumed"]:
            diff = np.abs(np.load(out / "params.npy") - p_ref)
            tight = float(np.mean(diff <= 2e-6 + 1e-5 * np.abs(p_ref)))
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(ranks[0]["losses"], ref_losses[GANG_DIE_AFTER:]))
            res.update(params_max_abs_err=float(diff.max()), params_tol_abs=GANG_LR / 2,
                       **{"params_share_within_2e-6+1e-5rel": tight},
                       loss_max_rel_err=loss_rel, loss_tol_rel=1e-4)
            ok["params"] = float(diff.max()) <= GANG_LR / 2 and tight >= 0.999
            ok["losses"] = loss_rel <= 1e-4
            per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
                        "flash_bwd_dkv": cfg.n_layers, "fused_adamw": 1}
            n = GANG_STEPS - GANG_DIE_AFTER
            ok["launches"] = all(r["launches"] == {k: v * n for k, v in per_step.items()}
                                 for r in ranks)
            res["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in per_step}
        res["checks"], res["ok"] = ok, all(ok.values())
        emit(res)
        if not res["ok"]:
            raise PhaseFailed("the elastic gang through the launch CLI failed its checks",
                              [k for k, v in ok.items() if not v])
        return res
    finally:
        stop_elastic_gang(run)
        _fresh_state_singletons()


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
    # Prefill chunks replay graphs (after each program's eager first call).
    paged, launches = path_launches(run["eng"])
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
    tokens_n1 = run["tokens"]
    del run
    # The same workload with decode_steps=8: graphs of 224·8 int8 and 32·8 paged
    # attention launches, tokens equal to the N = 1 run's.
    run = serve_main(params, cfg, dev, reset_counts, decode_steps=MULTI_N)
    s = run["stats"]
    paged8, launches8 = path_launches(run["eng"])
    expect8 = len(INT8_LAYER) * cfg.n_layers * (MULTI_N * s["decode_steps"] + chunks)
    differ = [i for i, (a, b) in enumerate(zip(run["tokens"], tokens_n1)) if a != b]
    res8 = {**_serve_result(run, "main_int8_multistep", init_s),
            "int8_matmul_launches": launches8, "int8_matmul_launches_expected": expect8,
            "int8_matmul_launches_ragged": qz.int8_matmul.launches_ragged,
            "paged_attention_launches": paged8,
            "paged_attention_launches_expected": cfg.n_layers * MULTI_N * s["decode_steps"],
            "requests_differing_from_main_int8": differ, "graphs": graph_stats(run["eng"]),
            "graph_nodes_ok": graph_nodes_ok(run["eng"], cfg.n_layers, int8=True)}
    res8["ok"] = (run["finite"] and run["in_range"] and run["all_done"] and not differ
                  and s["pages_in_use"] == 0 and launches8 == expect8
                  and paged8 == res8["paged_attention_launches_expected"]
                  and res8["graph_nodes_ok"] and qz.int8_matmul.launches_ragged == 0)
    emit(res8)
    if not res8["ok"]:
        raise SystemExit("int8 super-step main path failed its checks")
    prof8 = {**profile_decode(run["eng"], run["rng"], cfg.vocab_size,
                              steps=MULTI_PROFILE_STEPS), "weights": "int8"}
    emit(prof8)
    one_kernel_per_call(prof8, int8=True)
    del run
    dense = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    emit(decode_ab({"bf16": (dense, {}), "int8": (params, {})}, cfg))
    # In the super-step's graph the host no longer hides the kernels' device time.
    n8 = {"decode_steps": MULTI_N}
    emit(decode_ab({"bf16": (dense, n8), "int8": (params, n8)}, cfg, tokens=2 * MULTI_N))
    return {"launches": launches, "launches_multistep": launches8, "profile": prof,
            "profile_multistep": prof8, "int8_params": params, "dense_params": dense}


def decode_ab(variants: dict, cfg, tokens: int = 8) -> dict:
    """Prefill and decode wall times of two engines served alike, in alternation (A, B,
    B, A, ...) so that the host's load drifts alike over both: ``variants[name] =
    (params, engine keywords)``; each window is a fresh engine that admits 8 lanes from
    the same 200-token prompts (the engine's prefill time per request) and runs its
    first decode dispatch (a super-step's capture included), then decodes ``tokens``
    tokens a lane, timed on the host clock to a final sync: ms per decode token (a
    super-step's time over its N tokens)."""
    from accelerate_tpu_torch.serving import ContinuousBatcher

    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (8, 200))
    a, b = list(variants)

    def window(params, kw) -> tuple[float, float]:
        eng = ContinuousBatcher(params, cfg, **MAIN_ENGINE, **kw)
        n = eng.multi_step
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=n + tokens + 2)
        eng.step()  # admissions + the first decode dispatch
        torch.cuda.synchronize()
        prefill_ms = 1e3 * eng.stats()["prefill_s"] / len(prompts)
        t0 = time.perf_counter()
        for _ in range(tokens // n):
            eng.step()
        torch.cuda.synchronize()
        return prefill_ms, 1e3 * (time.perf_counter() - t0) / tokens

    runs = {a: [], b: []}
    prefill = {a: [], b: []}
    for name in (a, b, b, a):
        p_ms, s_ms = window(*variants[name])
        prefill[name].append(p_ms)
        runs[name].append(s_ms)
    med = {name: float(np.median(r)) for name, r in runs.items()}
    p_med = {name: float(np.median(r)) for name, r in prefill.items()}
    return {"phase": "decode_ab", "tokens_per_window": tokens, "lanes": 8,
            "decode_steps": {name: v[1].get("decode_steps", 1) for name, v in variants.items()},
            "order": f"({a}, {b}, {b}, {a})", "step_ms_runs": runs,
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
TRIGGER_RANK = 1  # the rank that calls set_trigger() in tp_rank_parity


def tp_accelerator(device, **kw):
    """A rank's ``Accelerator`` on TP_MESH, built through ``tp_plugin=`` (two ranks:
    dp takes what tp leaves, 1)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import TensorParallelPlugin

    return Accelerator(device=device, backend="gloo",
                       tp_plugin=TensorParallelPlugin(tp_size=TP_MESH["tp"]), **kw)


def _tp_mesh_ok(r) -> bool:
    """The rank's mesh is TP_MESH (every other axis 1) and its type TP."""
    return (r["mesh"] == {k: TP_MESH.get(k, 1) for k in r["mesh"]}
            and r["distributed_type"] == "TP")


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
    """One rank of ``train_tp_parity``: the ``debug`` config in fp32 on dp1×tp2 (the
    ``Accelerator`` built through ``tp_plugin=``), the params made on the CPU from seed 0
    and sharded by ``partition_specs``, ``fused_adamw`` and ``loss_impl="fused_tp"``;
    losses, grad norms, the gathered params, the kernels' launches, the mesh, and two
    ``check_trigger`` calls after rank TRIGGER_RANK's ``set_trigger``."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.ops import fused_xent as fx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = gloo_cuda_probe(device)
    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32, attn_impl="flash",
                              loss_impl="fused_tp")
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    acc = tp_accelerator(device)
    specs = llama.partition_specs(cfg)
    state = acc.create_train_state(params, fo.fused_adamw(lr), partition_specs=specs)
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    _reset_tp_counts(fa, fo, fx)
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = _tp_counts(fa, fo, fx)
    flat = params_to_numpy(state.params, mesh=acc.mesh, specs=specs)
    # One rank raises the trigger; every rank's check sees it, and the next one does not.
    if acc.process_index == TRIGGER_RANK:
        acc.set_trigger()
    trigger = [acc.check_trigger(), acc.check_trigger()]
    return {"rank": acc.process_index, "gloo_cuda_all_reduce": probe, "losses": losses,
            "grad_norms": norms, "launches": launches, "params": _flat_params(flat),
            "backend": acc.state.backend, "device": str(acc.device),
            "mesh": dict(acc.mesh.shape), "distributed_type": str(acc.distributed_type),
            "trigger": trigger}


def _flat_params(flat: dict) -> np.ndarray:
    return np.concatenate([np.ravel(x) for x in [flat["embed"], flat["lm_head"], flat["ln_f"]]
                           + [v for layer in flat["layers"] for v in layer.values()]])


def phase_train_tp_parity(dev, launched=None) -> None:
    """The tensor-parallel train step on the card (2 gloo ranks sharing it, dp1×tp2,
    ``loss_impl="fused_tp"``, kernel #6 and the fused-CE backward on each rank's vocab
    slice) against the same step on the CPU in one process (``loss_impl="fused"``, the
    plain versions): ``debug`` config, fp32, TF32 off, 3 steps of ``fused_adamw`` with
    ``max_grad_norm=1.0``; losses, the gathered params, and each step's global grad norm
    (AdamW's update barely moves when a leaf's gradient is scaled by a constant, so a
    tp-scaled or twice-reduced gradient shows in the norm, not in the params). The ranks
    build their ``Accelerator`` through ``tp_plugin=TensorParallelPlugin(tp_size=2)``: the
    mesh must be dp1×tp2; rank TRIGGER_RANK's ``set_trigger`` must fire ``check_trigger``
    on both ranks, and the next check must not.
    ``launched``: the ranks' results and seconds from ``phase_train_ranks``' shared
    launch (None: this phase launches its own ranks)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.launchers import notebook_launcher
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw

    lr, steps = TP_PARITY_LR, TP_PARITY_STEPS
    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.float32, attn_impl="flash",
                              loss_impl="fused")
    tokens = _tp_parity_tokens()
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
    if launched is None:
        t0 = time.perf_counter()
        card = _rank_device(dev)
        ranks = notebook_launcher(tp_rank_parity, (tokens, lr, steps, card), 2, device=card,
                                  backend="gloo", timeout_s=600)
        launched = (ranks, time.perf_counter() - t0)
    ranks, launch_s = launched
    L = cfg.n_layers
    expect = {"fused_xent_partial": steps, "fused_xent_bwd": steps, "fused_xent_fwd": 0,
              "flash_fwd": L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
              "fused_adamw": steps}
    res = {"phase": "train_tp_parity", "config": "debug", "mesh": TP_MESH,
           "loss_impl": "fused_tp (card, 2 gloo ranks) vs fused (CPU, one process)",
           "losses_cpu": l_cpu, "grad_norms_cpu": n_cpu, "launch_s": launch_s, "launches_expected_per_rank": expect,
           "accelerator": f"tp_plugin=TensorParallelPlugin(tp_size={TP_MESH['tp']})",
           "trigger_rank": TRIGGER_RANK, "ranks": []}
    ok = True
    for r in ranks:
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], l_cpu))
        norm_rel = max(abs(a - b) / abs(b) for a, b in zip(r["grad_norms"], n_cpu))
        diff = np.abs(r["params"] - p_cpu)
        tight = float(np.mean(diff <= 2e-6 + 1e-5 * np.abs(p_cpu)))
        r_ok = (loss_rel <= 1e-4 and norm_rel <= 1e-5 and float(diff.max()) <= lr / 2
                and tight >= 0.999
                and r["launches"] == expect and all(r["gloo_cuda_all_reduce"].values())
                and _tp_mesh_ok(r) and r["trigger"] == [True, False])
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


# 1 warm-up step and 1 timed (5 steps before slice 20, 3 before slice 22: the second
# warm-up step waited out a rank's first-step import of torch._dynamo, now preloaded).
TP_STEPS = 2
TP_PARITY_LR, TP_PARITY_STEPS = 1e-3, 3


def _tp_parity_tokens():
    from accelerate_tpu_torch.models import llama

    return np.random.default_rng(4).integers(0, llama.CONFIGS["debug"].vocab_size, (2, 129))


def _tp_main_tokens():
    return np.random.default_rng(0).integers(0, 128256, (TRAIN_B, TRAIN_S + 1))


def tp_rank_main(tokens, device: str) -> dict:
    """One rank of ``train_tp``: ``train_main``'s model (Llama-3-8B widths, TRAIN_LAYERS
    layers, the same seeded fp32 params made on the card) sharded by
    ``partition_specs`` over dp1×tp2 (the ``Accelerator`` built through ``tp_plugin=``),
    bf16 over fp32 masters, remat, flash attention, ``loss_impl="fused_tp"``,
    ``fused_adamw(1e-4)``, ``max_grad_norm=1.0``."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.ops import fused_xent as fx
    from accelerate_tpu_torch.utils.tree import tree_leaves

    dev = torch.device(device)
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=TRAIN_LAYERS,
                              dtype=torch.bfloat16, attn_impl="flash", remat=True,
                              remat_policy="full", loss_impl="fused_tp")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc = tp_accelerator(dev, mixed_precision="bf16")
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
            "step_ms_runs": [1e3 * s for s in step_s], "step_ms": 1e3 * float(np.mean(step_s[1:])),
            "init_s": init_s, "init_peak_bytes": init_peak, "step_peak_bytes": step_peak,
            "launches": launches, "profile": profile,
            "local_params": sum(leaf.numel() for leaf in tree_leaves(state.params)),
            "layer_leaf_sizes_mod_1024": shard_sizes, "mesh": dict(acc.mesh.shape),
            "distributed_type": str(acc.distributed_type)}


def phase_train_tp(dev, first_loss: float, launched=None) -> dict:
    """The tensor-parallel training path at Llama-3-8B's full width, depth TRAIN_LAYERS:
    two gloo ranks share the card (dp1×tp2), each holding half of every projection, of
    the embedding and of the head, on ``train_main``'s seeded weights and batch. The
    first loss must be within 2e-3 of ``train_main``'s, and each rank's launches per step
    must be kernel #6 once, the fused-CE backward once, the flash forward 2L (remat), dq
    and dk/dv L each, AdamW once. The step time is two ranks on one card with the
    collectives staged through host memory by gloo: no tensor-parallel speed.
    ``launched``: the ranks' results and seconds from ``phase_train_ranks``' shared
    launch (None: this phase launches its own ranks)."""
    from accelerate_tpu_torch.launchers import notebook_launcher

    _fresh_state_singletons()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parent_bytes = torch.cuda.memory_allocated()
    if launched is None:
        t0 = time.perf_counter()
        card = _rank_device(dev)
        ranks = notebook_launcher(tp_rank_main, (_tp_main_tokens(), card), 2, device=card,
                                  backend="gloo", timeout_s=900)
        launched = (ranks, time.perf_counter() - t0)
    ranks, launch_s = launched
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
                and r["launches"] == expect and r["layer_leaf_sizes_mod_1024"] == [0]
                and _tp_mesh_ok(r))
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


# ------------------------------------------ slice 19: fp8 training and LoRA adapters
FP8_PEAK_FLOPS = 1979e12  # dense fp8 tensor-core peak of one H100 SXM (data sheet)
#: Llama-3-8B's projection shapes (K, N) at M = 2048 tokens, plus a decode step's M = 8
#: (rows padded to 16 after the amax) and a ragged shape padded on every dimension.
FP8_SHAPES = [(2048, 4096, 4096), (2048, 4096, 1024), (2048, 4096, 14336),
              (2048, 14336, 4096), (8, 4096, 1024), (130, 200, 72)]
#: max |card - plain| / max |plain| of each fp8 product in fp32. The products of fp8
#: codes are exact; Hopper's fp8 MMA keeps about 14 mantissa bits of its running sum
#: within an instruction before cuBLASLt promotes it to fp32 (DeepSeek-V3's report):
#: 1.2e-4 to 3.4e-4 measured on an H100 (700 W), K from 200 to 14336.
FP8_PRODUCT_TOL = 1e-3
#: The same for fp8_dot's bf16 outputs, forward and both gradients: one bf16 rounding.
FP8_DOT_TOL = 1e-2


def _fp8_case(gen, dev, M, K, N):
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    g = (torch.randn((M, N), generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    return x, w, g


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_fp8_dot_check(dev) -> dict:
    """``ops.fp8``'s products through ``torch._scaled_mm`` against the plain version (the
    codes widened to fp32, multiplied, divided by the scales) on the card: Llama-3-8B's
    projection shapes at M = 2048, a decode step's M = 8 and a ragged shape, both
    formats, the forward product and both backward products (fp32 outputs); then
    ``fp8_dot``'s bf16 forward and gradients through autograd against the same plain
    composition. Times: the fp8 product alone, the whole fp8_dot forward (amaxes,
    quantize passes, layout copies, product) and a bf16 ``x @ w`` of the same shape."""
    from accelerate_tpu_torch.ops import fp8

    gen = torch.Generator(dev).manual_seed(19)
    cases, failed = [], {}
    for M, K, N in FP8_SHAPES:
        x, w, g = _fp8_case(gen, dev, M, K, N)
        for fmt in (fp8.Format.HYBRID, fp8.Format.E4M3):
            fwd_dt, bwd_dt = fp8._fmt_dtypes(fmt)
            xs = fp8.compute_scale(fp8._amax(x), fwd_dt)
            ws = fp8.compute_scale(fp8._amax(w), fwd_dt)
            gs = fp8.compute_scale(fp8._amax(g), bwd_dt)
            xq, wq, gq = fp8.quantize(x, xs, fwd_dt), fp8.quantize(w, ws, fwd_dt), \
                fp8.quantize(g, gs, bwd_dt)
            products = {"fwd": (xq, wq, xs, ws), "dx": (gq, wq.t(), gs, ws),
                        "dw": (xq.t(), gq, xs, gs)}
            errs = {}
            for which, (a, b, sa, sb) in products.items():
                got = fp8.scaled_product(a, b, sa, sb, torch.float32)
                want = fp8.scaled_product_reference(a, b, sa, sb, torch.float32)
                errs[which] = _rel(got, want)
            name = f"M{M}_K{K}_N{N}_{fmt}"
            rec = {"case": name, "max_rel_err": errs}
            if max(errs.values()) > FP8_PRODUCT_TOL:
                failed[name] = errs
            if (M, K, N) == FP8_SHAPES[0]:
                rec["fp8_dot_bf16"] = _fp8_dot_autograd(fp8, x, w, g, fmt)
                if max(rec["fp8_dot_bf16"].values()) > FP8_DOT_TOL:
                    failed[name + "_fp8_dot"] = rec["fp8_dot_bf16"]
            if M == 2048 and fmt == fp8.Format.HYBRID:
                rec["times"] = _fp8_times(fp8, x, w, xq, wq, xs, ws)
            cases.append(rec)
    engines = _fp8_engine_graphs(dev)
    if not engines["ok"]:
        failed["fp8_engine_graphs"] = engines
    res = {"phase": "fp8_dot_check", "cases": cases, "tol_product": FP8_PRODUCT_TOL,
           "tol_fp8_dot_bf16": FP8_DOT_TOL, "fp8_engine_graphs": engines, "ok": not failed}
    emit(res)
    if failed:
        raise PhaseFailed("fp8 products on the card disagree with the plain version", failed)
    return res


def _fp8_engine_graphs(dev) -> dict:
    """``use_fp8`` serving on the card (``debug``, bf16): the paged engine's 4-step
    super-step, captured into CUDA graphs with the amaxes, scales and ``_scaled_mm``
    inside, against the same engine one step at a time: the same greedy tokens."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(llama.CONFIGS["debug"], dtype=torch.bfloat16, use_fp8=True)
    params = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(3), device=dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in (20, 57, 9)]
    tokens, calls = {}, {}
    for n in (1, 4):
        eng = ContinuousBatcher(params, cfg, max_slots=4, max_len=128, prompt_bucket=32,
                                page_size=16, decode_steps=n)
        fp8.scaled_product.launches = 0
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        tokens[n] = [list(r.tokens) for r in reqs]
        calls[n] = {"eager_scaled_mm": fp8.scaled_product.launches, "graphs": len(eng.graphs)}
    return {"config": "debug bf16", "tokens_equal": tokens[1] == tokens[4], "calls": calls,
            "ok": tokens[1] == tokens[4] and calls[4]["graphs"] > 0}


def _fp8_dot_autograd(fp8, x, w, g, fmt) -> dict:
    """fp8_dot's bf16 forward, dx and dw through autograd (current scaling) against the
    plain composition of the same quantize passes and products."""
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fp8.fp8_dot(xr, wr, fmt)
    y.backward(g)
    fwd_dt, bwd_dt = fp8._fmt_dtypes(fmt)
    xs, ws = fp8.compute_scale(fp8._amax(x), fwd_dt), fp8.compute_scale(fp8._amax(w), fwd_dt)
    gs = fp8.compute_scale(fp8._amax(g), bwd_dt)
    xq, wq, gq = fp8.quantize(x, xs, fwd_dt), fp8.quantize(w, ws, fwd_dt), \
        fp8.quantize(g, gs, bwd_dt)
    ref = fp8.scaled_product_reference
    return {"fwd": _rel(y, ref(xq, wq, xs, ws, torch.bfloat16)),
            "dx": _rel(xr.grad, ref(gq, wq.t(), gs, ws, torch.bfloat16)),
            "dw": _rel(wr.grad, ref(xq.t(), gq, xs, gs, torch.bfloat16))}


def _fp8_times(fp8, x, w, xq, wq, xs, ws) -> dict:
    """Device ms (CUDA-graph replay) of the fp8 product alone (bf16 out), of the whole
    fp8_dot forward, of its plain version, and of cuBLAS's bf16 ``x @ w``; bounds of the
    fp8 product (fp8 peak or HBM) and of the bf16 product."""
    M, K = x.shape
    N = w.shape[1]
    t = {"product_ms": device_ms(lambda i: fp8.scaled_product(xq, wq, xs, ws, torch.bfloat16),
                                 10, 5),
         "fp8_dot_fwd_ms": device_ms(lambda i: fp8.fp8_dot(x, w), 10, 5),
         "plain_ms": device_ms(lambda i: fp8.scaled_product_reference(
             xq, wq, xs, ws, torch.bfloat16), 3, 3),
         "bf16_matmul_ms": device_ms(lambda i: x @ w, 10, 5)}
    ops = 2 * M * K * N
    t["bound_ms"] = 1e3 * max(ops / FP8_PEAK_FLOPS, (M * K + K * N + 2 * M * N) / HBM_BYTES_PER_S)
    t["bound_by"] = ("operations" if ops / FP8_PEAK_FLOPS
                     > (M * K + K * N + 2 * M * N) / HBM_BYTES_PER_S else "bytes")
    t["bf16_bound_ms"] = 1e3 * max(ops / PEAK_FLOPS[torch.bfloat16],
                                   2 * (M * K + K * N + M * N) / HBM_BYTES_PER_S)
    # cuBLASLt alone on operands already laid out (no transpose copy), with the fp32
    # promotion the port asks for and without it (use_fast_accum), and that one's error.
    b = fp8._padded_rows(wq.t(), N, K).t()
    sa, sb = torch.reciprocal(xs), torch.reciprocal(ws)

    def mm(fast):
        out = torch._scaled_mm(xq, b, scale_a=sa, scale_b=sb, out_dtype=torch.float32,
                               use_fast_accum=fast)
        return out[0] if isinstance(out, tuple) else out

    t["scaled_mm_only_ms"] = device_ms(lambda i: mm(False), 10, 5)
    t["scaled_mm_fast_accum_ms"] = device_ms(lambda i: mm(True), 10, 5)
    want = fp8.scaled_product_reference(xq, wq, xs, ws, torch.float32)
    t["fast_accum_max_rel_err"] = _rel(mm(True), want)
    t["promoted_max_rel_err"] = _rel(mm(False), want)
    return t


FP8_TRAIN_STEPS = 5  # 2 warm-up and 3 timed
#: First loss vs train_main's on the same params and batch: fp8 operand rounding at 8
#: layers moved it 8.0e-6 (relative) on the card.
FP8_TRAIN_TOL_REL = 1e-4


def phase_train_fp8(dev, first_loss: float) -> dict:
    """``train_main``'s recipe (Llama-3-8B widths, TRAIN_LAYERS layers, flash, every block
    checkpointed, chunked CE, ``fused_adamw(1e-4)``, clip 1.0, the same seeded params and
    batch) with ``use_fp8=True`` under ``Accelerator(mixed_precision="fp8")`` and a
    delayed-scaling recipe (history 4), in two arms: O1 (fp32 moments, the AdamW
    kernel) and O2 (scaled-fp8 moments). Checks: finite losses that fall, the first
    within ``FP8_TRAIN_TOL_REL`` of ``first_loss``, the amax history (x and w rows
    filled, the grad row zero), O2's moment bytes a quarter of O1's, and the kernels'
    launches."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.utils.dataclasses import FP8RecipeKwargs
    from accelerate_tpu_torch.utils.tree import tree_leaves

    L, n = TRAIN_LAYERS, FP8_TRAIN_STEPS
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=L, dtype=torch.bfloat16,
                              attn_impl="flash", remat=True, remat_policy="full",
                              use_fp8=True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    n_params = llama.num_params(cfg)
    flops_per_token = 6 * n_params + 6 * L * TRAIN_S * cfg.d_model
    arms, failed = {}, {}
    for arm in ("O1", "O2"):
        _fresh_state_singletons()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                                   generator=torch.Generator(dev).manual_seed(0), device=dev)
        recipe = FP8RecipeKwargs(use_delayed_scaling=True, amax_history_len=4, opt_level=arm)
        acc = Accelerator(mixed_precision="fp8", device=dev, kwargs_handlers=[recipe])
        state = acc.create_train_state(params, fo.fused_adamw(1e-4))
        del params
        step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
        _reset_train_counts(fa, fo)
        fp8.scaled_product.launches = 0
        losses, step_s = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = _train_counts(fa, fo)
        expect = {"flash_fwd": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dkv": L * n,
                  "fused_adamw": n if arm == "O1" else 0}
        # 7 projections a layer: one product in each forward (twice under remat) and
        # two in its backward.
        scaled = fp8.scaled_product.launches
        hist = state.fp8_state.history.cpu()
        moments = [t for t in tree_leaves([state.opt_state.mu, state.opt_state.nu])]
        step_ms = 1e3 * float(np.mean(step_s[2:]))
        tokens_per_step = TRAIN_B * TRAIN_S
        rec = {
            "opt_level": arm, "losses": losses, "step_ms_runs": [1e3 * t for t in step_s],
            "step_ms": step_ms, "tokens_per_s": tokens_per_step / (step_ms / 1e3),
            "mfu_at_bf16_peak": tokens_per_step * flops_per_token / (step_ms / 1e3)
            / PEAK_FLOPS[torch.bfloat16],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "launches_expected": expect,
            "scaled_mm_calls": scaled, "scaled_mm_calls_expected": 7 * L * 4 * n,
            "moment_bytes": sum(t.numel() * t.element_size() for t in moments),
            "moment_dtypes": sorted({str(t.dtype) for t in moments}),
            "amax_history": hist.tolist(), "fp8_state_step": int(state.fp8_state.step),
        }
        rec["first_loss_rel_err_vs_train_main"] = abs(losses[0] - first_loss) / abs(first_loss)
        checks = {
            "finite": all(np.isfinite(losses)),
            "losses_fall": losses[-1] < losses[0],
            "first_loss": rec["first_loss_rel_err_vs_train_main"] <= FP8_TRAIN_TOL_REL,
            "history": bool((hist[:2, :min(n, 4)] > 0).all()) and bool((hist[2] == 0).all())
            and rec["fp8_state_step"] == n,
            "launches": launches == expect and scaled == rec["scaled_mm_calls_expected"],
        }
        rec["checks"] = checks
        failed.update({f"{arm}_{k}": rec for k, ok in checks.items() if not ok})
        arms[arm] = rec
        if arm == "O1":
            emit({**profile_fp8_step(step, state, batch), "opt_level": arm})
        del state, step, acc
    ratio = arms["O2"]["moment_bytes"] / arms["O1"]["moment_bytes"]
    if ratio != 0.25:
        failed["o2_moment_bytes"] = ratio
    res = {"phase": "train_fp8", "config": "llama3-8b", "layers": L,
           "cut": f"depth {L} of 32 layers, as train_main", "batch": [TRAIN_B, TRAIN_S],
           "recipe": "HYBRID, delayed scaling, amax history 4 (max), margin 0",
           "params": n_params, "flops_per_token": flops_per_token, "arms": arms,
           "o2_moment_bytes_over_o1": ratio, "first_loss_train_main": first_loss,
           "first_loss_tol_rel": FP8_TRAIN_TOL_REL, "ok": not failed}
    emit(res)
    _fresh_state_singletons()
    if failed:
        raise PhaseFailed("fp8 training failed its checks", failed)
    return res


def profile_fp8_step(step, state, batch) -> dict:
    """One fp8 train step under ``torch.profiler``, with ``ops.fp8``'s amax, quantize
    and layout helpers wrapped in ``record_function`` ranges: the device time of the
    ``_scaled_mm`` calls, of the quantize passes (clip and cast), of the amaxes, of the
    layout copies (transposes and padding) and of the rest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from accelerate_tpu_torch.ops import fp8

    names = {"quantize": "fp8.quantize", "_amaxes": "fp8.amax", "_padded_rows": "fp8.layout"}
    saved = {k: getattr(fp8, k) for k in names}

    def ranged(fn, label):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    for k, label in names.items():
        setattr(fp8, k, ranged(saved[k], label))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for k, fn in saved.items():
            setattr(fp8, k, fn)
    busy_us, by_range = 0.0, {"scaled_mm": 0.0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # The ranges also appear as device-side annotations: not kernels.
            if e.key not in names.values():
                busy_us += e.self_device_time_total
        elif e.key == "aten::_scaled_mm":
            by_range["scaled_mm"] += e.device_time_total
        elif e.key in names.values():
            by_range[e.key] = by_range.get(e.key, 0.0) + e.device_time_total
    split = {k: v / 1e3 for k, v in by_range.items()}
    split["rest"] = busy_us / 1e3 - sum(split.values())
    return {"phase": "train_fp8_profile", "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_idle_share": (1 - busy_us / 1e3 / wall_ms) if busy_us else None,
            "device_ms_split": split if busy_us else None}


LORA_RANK = 16
LORA_S = 2048
LORA_STEPS = 7  # 2 warm-up and 5 timed
LORA_PEAK_ROOM = 12 << 30  # peak memory above what was resident before the phase
LORA_ENGINE = dict(max_slots=4, max_len=256, prompt_bucket=64, page_size=16)


def _lora_cfg(cfg):
    return dataclasses.replace(cfg, lora_rank=LORA_RANK, attn_impl="flash", remat=True,
                               remat_policy="full")


def phase_train_lora(dev, base: dict) -> dict:
    """LoRA at Llama-3-8B's full width and depth: ``base`` (the bf16 params the int8
    phase made, 32 layers) frozen, adapters of rank 16 on wq/wk/wv/wo
    (``lora.add_adapters``), ``lora_optimizer(adamw(1e-3))``, bf16 compute, flash, every
    block checkpointed, one seeded batch of 1 x 2048: 2 warm-up and 5 timed steps.
    Checks: the base unchanged (checksums), the adapters moved, losses falling, no
    base leaf handed to ``torch.autograd.grad`` (every call recorded), the peak memory
    above what was resident within LORA_PEAK_ROOM, the flash launches. Then
    ``merge_lora``; a greedy drain of a paged engine over the adapted params against
    one over the merged params (near ties allowed, as ``divergence_rows`` allows them,
    and the adapted row held against ``llama.forward``'s);
    an ``only_lora`` → ``load_lora`` round trip, bitwise."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama, lora
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.utils.tree import tree_leaves

    _fresh_state_singletons()
    cfg = _lora_cfg(dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16))
    L = cfg.n_layers
    base_leaves = tree_leaves(base)
    base_bytes = sum(t.numel() * t.element_size() for t in base_leaves)
    base_sums = [_checksum(t) for t in base_leaves]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lora.add_adapters(base, cfg, generator=torch.Generator(dev).manual_seed(1))
    acc = Accelerator(mixed_precision="bf16", device=dev)
    state = acc.create_train_state(params, lora.lora_optimizer(optim.adamw(1e-3)))
    adapters0 = {k: v.clone() for k, v in lora.only_lora(state.params).items()}
    base_ptrs = {t.data_ptr() for t in base_leaves}
    # The frozen base enters the state as it is: bf16, not copied to fp32 masters.
    kept = base_ptrs <= {t.data_ptr() for t in tree_leaves(state.params)}
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg))
    tokens = np.random.default_rng(19).integers(0, cfg.vocab_size, (1, LORA_S + 1))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    grad_calls = []
    autograd_grad = torch.autograd.grad

    def recording_grad(outputs, inputs, *a, **kw):
        grad_calls.append((len(inputs), sum(t.data_ptr() in base_ptrs for t in inputs)))
        return autograd_grad(outputs, inputs, *a, **kw)

    _reset_train_counts(fa, fo)
    losses, step_s = [], []
    torch.autograd.grad = recording_grad
    try:
        for _ in range(LORA_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
    finally:
        torch.autograd.grad = autograd_grad
    peak_above = torch.cuda.max_memory_allocated() - resident
    launches = _train_counts(fa, fo)
    expect = {"flash_fwd": 2 * L * LORA_STEPS, "flash_bwd_dq": L * LORA_STEPS,
              "flash_bwd_dkv": L * LORA_STEPS, "fused_adamw": 0}
    n_adapters = 2 * len(cfg.lora_targets) * L
    moved = any(not torch.equal(adapters0[k], v) for k, v in lora.only_lora(state.params).items())
    step_ms = 1e3 * float(np.mean(step_s[2:]))
    # Frozen base: the forward (2N) and the activation gradients (2N) a token, plus the
    # recomputed forward of every checkpointed block (2N), and attention's.
    n_params = llama.num_params(cfg)
    flops_per_token = 6 * n_params + 6 * L * LORA_S * cfg.d_model
    rec = {"phase": "train_lora", "config": "llama3-8b", "layers": L, "lora_rank": LORA_RANK,
           "lora_targets": list(cfg.lora_targets), "batch": [1, LORA_S], "losses": losses,
           "step_ms_runs": [1e3 * t for t in step_s], "step_ms": step_ms,
           "tokens_per_s": LORA_S / (step_ms / 1e3),
           "mfu_at_bf16_peak_frozen_base": LORA_S * flops_per_token / (step_ms / 1e3)
           / PEAK_FLOPS[torch.bfloat16], "flops_per_token_frozen_base": flops_per_token,
           "base_bytes": base_bytes, "memory_resident_before_bytes": resident,
           "peak_above_resident_bytes": peak_above, "peak_room_bytes": LORA_PEAK_ROOM,
           "autograd_grad_calls": len(grad_calls),
           "autograd_grad_inputs": sorted({c[0] for c in grad_calls}),
           "base_leaves_handed_to_autograd": sum(c[1] for c in grad_calls),
           "launches": launches, "launches_expected": expect,
           "base_kept_in_place": kept}
    checks = {
        "base_unchanged": [_checksum(t) for t in base_leaves] == base_sums,
        "adapters_moved": moved, "finite": all(np.isfinite(losses)),
        "losses_fall": all(b < a for a, b in zip(losses, losses[1:])),
        "no_base_gradient": rec["base_leaves_handed_to_autograd"] == 0
        and rec["autograd_grad_inputs"] == [n_adapters] and len(grad_calls) == LORA_STEPS,
        "peak_memory": peak_above <= LORA_PEAK_ROOM, "launches": launches == expect,
        "base_kept_in_place": kept,
    }
    del step, acc
    # Serving: the adapted params against the merged ones, one greedy drain each.
    merged, merged_cfg = lora.merge_lora(state.params, cfg)
    serve = _lora_drains(state.params, cfg, merged, merged_cfg)
    checks["serving"] = serve["ok"]
    # The adapter file: only_lora → load_lora into a fresh adapted tree, bitwise.
    saved = {k: v.detach().cpu() for k, v in lora.only_lora(state.params).items()}
    fresh = lora.add_adapters(base, cfg, generator=torch.Generator(dev).manual_seed(2))
    loaded = lora.only_lora(lora.load_lora(fresh, saved))
    checks["only_lora_round_trip"] = (sorted(loaded) == sorted(saved) and all(
        torch.equal(loaded[k].cpu(), saved[k]) for k in saved))
    rec.update(serving=serve, adapter_file_entries=len(saved),
               adapter_file_bytes=sum(v.numel() * v.element_size() for v in saved.values()),
               checks=checks, ok=all(checks.values()))
    emit(rec)
    del merged, fresh, state
    _fresh_state_singletons()
    if not rec["ok"]:
        raise PhaseFailed("LoRA training failed its checks",
                          {k: v for k, v in checks.items() if not v})
    return rec


def _lora_workload(vocab: int):
    rng = np.random.default_rng(20)
    return [(rng.integers(0, vocab, int(n)), dict(max_new_tokens=16))
            for n in rng.integers(40, 120, 4)]


def _lora_drains(adapted, cfg, merged, merged_cfg) -> dict:
    """One greedy drain of a paged engine (``LORA_ENGINE``) over ``adapted`` and one over
    ``merged``; for each request whose tokens differ, at its first divergence d, the two
    engines' logits rows replayed alone: a near tie is a top-two gap of the adapted row
    within twice the rows' largest difference, that difference at most ``DELTA_MAX``
    (``divergence_rows``' rule: ``x@W + (x@A)@B`` and ``x@(W + AB)`` round apart, as
    the JAX package's own adapter test warns); and the adapted row within ``DELTA_MAX``
    of ``llama.forward``'s over the adapted params and the same tokens."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import ContinuousBatcher

    workload = _lora_workload(cfg.vocab_size)
    sides = {"adapted": (adapted, cfg), "merged": (merged, merged_cfg)}
    tokens, launches = {}, {}
    for side, (p, c) in sides.items():
        eng = ContinuousBatcher(p, c, **LORA_ENGINE)
        reqs = [eng.submit(prompt, **kw) for prompt, kw in workload]
        before = path_launches(eng)[0]
        eng.run()
        torch.cuda.synchronize()
        launches[side] = path_launches(eng)[0] - before
        tokens[side] = [list(r.tokens) for r in reqs]
        del eng
    differ = {i: next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
              for i, (a, b) in enumerate(zip(tokens["adapted"], tokens["merged"])) if a != b}
    ties = {}
    rows = {side: _lora_rows(p, c, workload, differ, tokens[side])
            for side, (p, c) in sides.items()}
    for i, d in differ.items():
        (a_row, a_tok), (m_row, m_tok) = rows["adapted"][i], rows["merged"][i]
        delta = float((a_row - m_row).abs().max())
        top = torch.topk(a_row, 2).values
        gap = float(top[0] - top[1])
        # The adapted engine's row against llama.forward over the same adapted params
        # and the same tokens: the decode path applies the adapters as the forward does.
        with torch.no_grad():
            ids = torch.as_tensor(np.concatenate([workload[i][0], tokens["adapted"][i][:d]]),
                                  device=adapted["embed"].device)[None]
            f_row = llama.forward(adapted, ids, cfg)[0, -1].float().cpu()
        delta_forward = float((a_row - f_row).abs().max())
        ties[i] = {"d": d, "delta": delta, "gap": gap, "delta_vs_forward": delta_forward,
                   "ok": delta <= DELTA_MAX and gap <= 2 * delta
                   and delta_forward <= DELTA_MAX
                   and a_tok == tokens["adapted"][i][d] and m_tok == tokens["merged"][i][d]}
    n_tokens = {s: sum(len(t) for t in v) for s, v in tokens.items()}
    return {"engine": LORA_ENGINE, "requests": len(workload), "tokens": n_tokens,
            "paged_attention_launches": launches, "requests_differing": len(differ),
            "near_ties": ties,
            "ok": all(t["ok"] for t in ties.values()) and all(v > 0 for v in launches.values())
            and all(n == 16 * len(workload) for n in n_tokens.values())}


def _lora_rows(params, cfg, workload, first: dict, tokens) -> dict:
    """``{request: (logits row, token)}``: the row each request's token ``d = first[i]``
    was chosen from, replayed on one fresh ``LORA_ENGINE`` engine (every lane
    independent of the others; read as the token lands), and the replayed token. Token
    0 comes from the prefill: its row is the last prompt position of ``llama.forward``."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import ContinuousBatcher

    rows = {}
    eng = ContinuousBatcher(params, cfg, **LORA_ENGINE)
    for i, d in first.items():
        prompt = workload[i][0]
        if d == 0:
            with torch.no_grad():
                ids = torch.as_tensor(prompt, device=params["embed"].device)[None]
                rows[i] = (llama.forward(params, ids, cfg)[0, -1].float().cpu(), tokens[i][0])
            continue
        holder = []

        def hook(tok, i=i, d=d, holder=holder):
            req = holder[0]
            if len(req.tokens) == d + 1:
                rows[i] = (eng.last_logits[eng.slot_req.index(req)].float().cpu(), tok)

        holder.append(eng.submit(prompt, max_new_tokens=d + 1, on_token=hook))
    eng.run()
    return rows


QLORA_STEPS = 3


def phase_qlora_closure(dev, qparams: dict) -> dict:
    """Adapters over the int8 base of ``main_int8`` in the closure form: the train state
    holds only the adapters (rank 16 on wq/wk/wv/wo, 32 layers), the loss closes over
    the frozen int8 base (int8 projections through kernel #10, gradients to the
    adapters through ``quant_matmul``'s backward), bf16, flash, remat, one seeded batch
    of 1 x 2048, 3 steps. Checks: the int8 bytes unchanged, finite falling losses, #10's
    launches exact (7 projections a layer, forward and recomputed forward). Then #10's
    device ms per call at M = 2048 for each projection shape, beside cuBLAS bf16."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama, lora
    from accelerate_tpu_torch.ops import quantization as qz
    from accelerate_tpu_torch.utils.tree import tree_leaves

    _fresh_state_singletons()
    cfg = _lora_cfg(dataclasses.replace(llama.CONFIGS["llama3-8b"], dtype=torch.bfloat16))
    L = cfg.n_layers
    codes = [leaf.data for layer in qparams["layers"] for leaf in layer.values()
             if isinstance(leaf, qz.QuantizedWeight)]
    sums = [_checksum(t.view(torch.int16) if t.numel() % 2 == 0 else t) for t in codes]
    adapted = lora.add_adapters(qparams, cfg, generator=torch.Generator(dev).manual_seed(1))
    adapters = {"layers": [{k: v for k, v in layer.items() if "_lora_" in k}
                           for layer in adapted["layers"]]}
    del adapted

    def closure_loss(ad, b):
        full = {**qparams, "layers": [{**base, **extra} for base, extra
                                      in zip(qparams["layers"], ad["layers"])]}
        return llama.loss_fn(full, b, cfg)

    acc = Accelerator(mixed_precision="bf16", device=dev)
    state = acc.create_train_state(adapters, optim.adamw(1e-3))
    step = acc.build_train_step(closure_loss)
    tokens = np.random.default_rng(19).integers(0, cfg.vocab_size, (1, LORA_S + 1))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    qz.int8_matmul.launches = qz.int8_matmul.launches_ragged = 0
    losses, step_s = [], []
    for _ in range(QLORA_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = qz.int8_matmul.launches
    expect = len(INT8_LAYER) * L * 2 * QLORA_STEPS
    n_state = len(tree_leaves(state.params))
    checks = {"int8_unchanged": [_checksum(t.view(torch.int16) if t.numel() % 2 == 0 else t)
                                 for t in codes] == sums,
              "finite": all(np.isfinite(losses)), "losses_fall": losses[-1] < losses[0],
              "launches": launches == expect,
              "state_is_adapters": n_state == 2 * len(cfg.lora_targets) * L}
    del step, acc, state
    gen = torch.Generator(dev).manual_seed(21)
    times = {}
    for name in ("wq", "wv", "w_gate", "w_down"):  # wk, wo, w_up repeat these shapes
        layer0 = qparams["layers"][0][name]
        K, N = layer0.shape
        x = torch.randn((LORA_S, K), generator=gen, device=dev).to(torch.bfloat16)
        w = qz.dequantize_weight(layer0, torch.bfloat16)
        k_ms = device_ms(lambda i: qz.int8_matmul(x, layer0.data, layer0.scales,
                                                  torch.bfloat16), 5, 3)
        ops = 2 * LORA_S * K * N
        nbytes = LORA_S * K * 2 + K * N + 4 * N + LORA_S * N * 2
        times[f"{K}x{N}"] = {
            "kernel_ms": k_ms, "dense_bf16_ms": device_ms(lambda i: x @ w, 5, 3),
            "bound_ms": 1e3 * max(ops / PEAK_FLOPS[torch.bfloat16], nbytes / HBM_BYTES_PER_S),
            "bound_by": ("operations" if ops / PEAK_FLOPS[torch.bfloat16]
                         > nbytes / HBM_BYTES_PER_S else "bytes")}
        del x, w
    res = {"phase": "qlora_closure", "config": "llama3-8b", "layers": L,
           "lora_rank": LORA_RANK, "batch": [1, LORA_S], "losses": losses,
           "step_ms_runs": [1e3 * t for t in step_s], "int8_matmul_launches": launches,
           "int8_matmul_launches_expected": expect,
           "int8_matmul_launches_ragged": qz.int8_matmul.launches_ragged,
           "int8_matmul_at_m2048": times, "checks": checks, "ok": all(checks.values())}
    emit(res)
    _fresh_state_singletons()
    if not res["ok"]:
        raise PhaseFailed("QLoRA closure training failed its checks",
                          {k: v for k, v in checks.items() if not v})
    return res


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


# ------------------------------- slice 20: ZeRO/FSDP, cpu_offload and packed batches
#: The packed batch of every slice-20 phase: documents of 64-1536 tokens (seeded
#: lengths) packed first-fit by ``ops.packing.pack_sequences`` into rows of S + 1.
PACK_S, PACK_DOCS = 2048, (64, 1536)
PACK_DRAWS = 64  # documents drawn at most while a row still has room
PACKED_LAYERS = 2  # packed_check's depth (forward only)
#: packed_check's limits (bf16 weights at 8B width): the packed loss against the
#: token-weighted mean of the documents' own losses (relative); each document's hidden
#: states in its packed slots against its own, alone (the norm of the difference over
#: the reference's; 4.2e-3 measured on an H100); the live hidden states of the flash
#: path, and of the bf16 einsum path, against an fp32 einsum reference (likewise: 1.10e-2
#: and 1.30e-2 measured: the bf16 forward's rounding, not the attention kernel's); the
#: planted fault (segment ids dropped; 0.73 measured) must miss the per-document limit
#: by PACKED_FAULT_MARGIN times at least.
PACKED_LOSS_TOL, PACKED_DOC_TOL, PACKED_HIDDEN_TOL = 2e-3, 1e-2, 2e-2
PACKED_FAULT_MARGIN = 10
FSDP_LAYERS = 2  # train_fsdp's and train_offload (a)'s depth
FSDP_MESH = {"dp": 1, "fsdp": 2}
FSDP_STEPS = {3: 3, 2: 2, 1: 2}  # steps of each ZeRO stage's arm
#: A bf16 step's loss against the one-rank arm's (train_tp's first-loss rule), and the
#: gathered params after the arm's steps: AdamW's first updates are about lr * sign(g),
#: so an element whose gradient is at bf16 noise may move the other way (2 lr a step),
#: while the rest agree closely.
FSDP_LOSS_TOL, FSDP_LR = 2e-3, 1e-4
FSDP_PARAM_SHARE = 0.99  # share of elements within lr / 2 of the one-rank arm's
FSDP_CKPT_LAYERS = 1  # fsdp_ckpt's depth
OFFLOAD_LAYERS = 32  # train_offload (b): Llama-3-8B's full depth
OFFLOAD_STEPS = 3  # 1 warm-up and 2 timed
SHM = Path("/dev/shm")  # checkpoints here: the card's host limits disk writes a call


def packed_batch(vocab: int, rows: int, seed: int) -> tuple[dict, list]:
    """``rows`` rows of ``PACK_S + 1`` tokens packed first-fit from seeded documents
    (lengths uniform in ``PACK_DOCS``): documents are drawn until every row has less room
    than the shortest document, or PACK_DRAWS have been drawn; a document that fits no
    row is skipped. Raises unless every row holds at least 2 documents, one starting
    past slot 0, with the positions restarting at 0 at each document's first slot.
    Returns (the packed batch, the documents)."""
    from accelerate_tpu_torch.ops.packing import pack_sequences

    rng = np.random.default_rng(seed)
    cap = PACK_S + 1
    used, docs = [0] * rows, []
    for _ in range(PACK_DRAWS):
        if cap - min(used) < PACK_DOCS[0]:
            break
        n = int(rng.integers(PACK_DOCS[0], PACK_DOCS[1] + 1))
        doc = rng.integers(1, vocab, n).astype(np.int32)
        row = next((r for r in range(rows) if used[r] + n <= cap), None)
        if row is not None:  # first fit, as pack_sequences places it
            used[row] += n
            docs.append(doc)
    packed = pack_sequences(docs, cap, max_bins=rows)
    seg, pos = packed["segment_ids"], packed["positions"]
    starts = (seg != 0) & np.concatenate(
        [np.ones((rows, 1), bool), seg[:, 1:] != seg[:, :-1]], axis=1)
    if not (packed["tokens"].shape[0] == rows and (seg.max(1) >= 2).all()
            and starts[:, 1:].any(1).all() and (pos[starts] == 0).all()
            and ((pos[:, 1:] == pos[:, :-1] + 1) | starts[:, 1:] | (seg[:, 1:] == 0)).all()):
        raise PhaseFailed("the packed batch does not hold 2 documents a row",
                          {"rows": rows, "used": used, "documents": len(docs)})
    return packed, docs


def packed_layout(packed: dict, docs: list) -> dict:
    """What a phase prints of its packed batch: documents a row, their lengths, the
    slots where a document starts past slot 0, the live share."""
    seg = packed["segment_ids"]
    starts = [[int(i) for i in np.flatnonzero((s[1:] != s[:-1]) & (s[1:] != 0)) + 1]
              for s in seg]
    return {"rows": list(packed["tokens"].shape), "documents": len(docs),
            "documents_per_row": [int(s.max()) for s in seg],
            "doc_lengths": [len(d) for d in docs], "starts_past_slot_0": starts,
            "live_share": float((seg != 0).mean())}


def _fsdp_cfg(layers: int, **kw):
    from accelerate_tpu_torch.models import llama

    return dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=layers,
                               dtype=torch.bfloat16, attn_impl="flash", remat=True,
                               remat_policy="full", loss_impl="auto", **kw)


def phase_packed_check(dev) -> dict:
    """One packed batch at Llama-3-8B's width, depth PACKED_LAYERS, forward only (bf16
    weights; 2 rows of 4-5 documents each): JAX's ``test_packed_loss_matches_unpacked_sum``
    and ``test_packed_flash_matches_xla_path`` at full width. Checks: the packed rows'
    loss within PACKED_LOSS_TOL of the token-weighted mean of each document's loss
    computed alone; each document's hidden states in its packed slots against the same
    document's computed alone through the same kernels (segment isolation and the
    per-segment positions, within PACKED_DOC_TOL); the live slots' hidden states through
    the flash kernels' segment route and through the bf16 einsum attention (the
    block-diagonal mask, ``attn_impl="xla"``) each against an fp32 einsum reference,
    within PACKED_HIDDEN_TOL (the einsum path the witness that the distance is the bf16
    forward's); a planted fault, the same rows with
    their segment ids dropped (positions kept), caught by the per-document check by at
    least PACKED_FAULT_MARGIN times its tolerance. Kernel #2's launches on the segment
    route: one a layer in the packed loss."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(_fsdp_cfg(PACKED_LAYERS), remat=False)
    params = llama.init_params(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    packed, docs = packed_batch(cfg.vocab_size, 2, seed=20)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
    inputs = batch["tokens"][:, :-1]
    kw = dict(positions=batch["positions"][:, :-1], segment_ids=batch["segment_ids"][:, :-1])
    live = kw["segment_ids"] != 0
    # Each document's (row, first slot), in the documents' order: first fit, as packed.
    used, slots = [0, 0], []
    for doc in docs:
        r = next(r for r in range(2) if used[r] + len(doc) <= PACK_S + 1)
        slots.append((r, used[r]))
        used[r] += len(doc)

    def rel(x, ref):
        return float((x - ref).norm() / ref.norm())

    def doc_err(x_packed, alone):
        """The packed slots' hidden states of every document against its own (the
        slots that predict a next token: the document's length less 1)."""
        got = torch.cat([x_packed[r, s:s + len(a)] for (r, s), a in zip(slots, alone)])
        return rel(got, torch.cat(alone))

    with torch.no_grad():
        fa._fwd.launches = 0
        packed_loss = float(llama.loss_fn(params, batch, cfg))
        segment_launches = fa._fwd.launches
        total, count, alone = 0.0, 0, []
        for doc in docs:
            tok = torch.as_tensor(doc[None], device=dev)
            loss = float(llama.loss_fn(params, {"tokens": tok}, cfg))
            total, count = total + loss * (len(doc) - 1), count + len(doc) - 1
            alone.append(llama.forward_hidden(params, tok[:, :-1], cfg)[0].float())
        x_flash = llama.forward_hidden(params, inputs, cfg, **kw).float()
        doc_rel = doc_err(x_flash, alone)
        # The planted fault: a kernel that ignored the segment ids.
        x_fault = llama.forward_hidden(params, inputs, cfg, positions=kw["positions"]).float()
        fault_rel = doc_err(x_fault, alone)
        x_xla = llama.forward_hidden(params, inputs, dataclasses.replace(cfg, attn_impl="xla"),
                                     **kw).float()
        del x_fault, alone
        ref_params = tree_map(lambda t: t.float() if torch.is_tensor(t) else t, params)
        del params
        _free_cuda()
        x_ref = llama.forward_hidden(
            ref_params, inputs, dataclasses.replace(cfg, attn_impl="xla", dtype=torch.float32),
            **kw)
        del ref_params
        scale = x_ref.square().mean(-1, keepdim=True).sqrt()
        hidden_max = float(((x_flash - x_ref).abs() / scale)[live].max())
        hidden_err = rel(x_flash[live], x_ref[live])
        xla_err = rel(x_xla[live], x_ref[live])
        flash_vs_xla = rel(x_flash[live], x_xla[live])
    unpacked = total / count
    loss_rel = abs(packed_loss - unpacked) / abs(unpacked)
    res = {"phase": "packed_check", "config": "llama3-8b", "layers": PACKED_LAYERS,
           **packed_layout(packed, docs), "packed_loss": packed_loss,
           "unpacked_token_weighted_loss": unpacked, "loss_rel_err": loss_rel,
           "loss_tol_rel": PACKED_LOSS_TOL, "doc_hidden_rel_err": doc_rel,
           "doc_hidden_tol": PACKED_DOC_TOL,
           "fault_segment_ids_dropped_doc_hidden_rel_err": fault_rel,
           "fault_margin_min": PACKED_FAULT_MARGIN,
           "hidden_rel_err_vs_fp32": hidden_err, "hidden_tol": PACKED_HIDDEN_TOL,
           "hidden_max_err_over_row_rms_vs_fp32": hidden_max,
           "xla_bf16_hidden_rel_err_vs_fp32": xla_err, "flash_vs_xla_bf16_rel_err": flash_vs_xla,
           "flash_fwd_segment_launches": segment_launches,
           "segment_launches_expected": PACKED_LAYERS}
    res["ok"] = (loss_rel <= PACKED_LOSS_TOL and doc_rel <= PACKED_DOC_TOL
                 and fault_rel >= PACKED_FAULT_MARGIN * PACKED_DOC_TOL
                 and hidden_err <= PACKED_HIDDEN_TOL and xla_err <= PACKED_HIDDEN_TOL
                 and segment_launches == PACKED_LAYERS
                 and math.isfinite(packed_loss))
    emit(res)
    if not res["ok"]:
        raise SystemExit("packed batch at 8B width failed its checks")
    return {"launches": {"flash_fwd": segment_launches}}


def _state_bytes(state, own_bytes: int) -> dict:
    """A train state's resident fp32 bytes: params, moments, and the gradients the step
    makes (``own_bytes``: each leaf's piece this rank updates)."""
    from accelerate_tpu_torch.utils.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if torch.is_tensor(t) and t.dim() > 0)

    params, moments = nbytes(state.params), nbytes(state.opt_state)
    return {"params": params, "moments": moments, "grads": own_bytes,
            "total": params + moments + own_bytes}


def _own_bytes(state, mesh, stage: int) -> int:
    """Bytes of the gradients a step of ``stage`` leaves on this rank: the fsdp pieces
    (ZeRO-3), the slices (ZeRO-2), the whole leaves (ZeRO-1 and one rank)."""
    from accelerate_tpu_torch.utils.tree import tree_leaves

    leaves = tree_leaves(state.params)
    zd = state.zero_dims or [None] * len(leaves)
    n = 1 if mesh is None else mesh.shape["fsdp"]
    return sum(p.numel() * p.element_size() // (n if d is not None and stage == 2 else 1)
               for p, d in zip(leaves, zd))


def _fsdp_train(acc, cfg, seed: int, batch: dict, steps: int, after_step=None,
                **step_kw) -> dict:
    """``steps`` of the slice-20 recipe (``fused_adamw(FSDP_LR)``, clip 1.0, the loss
    that gathers its ZeRO-3 leaves per layer) on fresh seeded fp32 params: losses, step
    times, launches of #2-#4 and #9, peak memory, the collectives' counts and bytes a
    step. ``after_step(i, state)`` runs after step ``i`` (1-based), outside the timing."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.parallel import fsdp

    dev = acc.device
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                               generator=torch.Generator(dev).manual_seed(seed), device=dev)
    state = acc.create_train_state(params, fo.fused_adamw(FSDP_LR))
    del params
    torch.cuda.empty_cache()
    step = acc.build_train_step(fsdp.gathers_fsdp_shards(
        lambda p, b: llama.loss_fn(p, b, cfg)), max_grad_norm=1.0, **step_kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts(fa, fo)
    fsdp.reset_stats()
    losses, norms, step_s = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if after_step is not None:
            after_step(len(losses), state)
    return {"state": state, "step": step, "losses": losses, "grad_norms": norms,
            "step_ms_runs": [1e3 * s for s in step_s], "init_s": init_s,
            "init_peak_bytes": init_peak, "step_peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": _train_counts(fa, fo),
            "collectives_per_step": {k: v / max(steps, 1) for k, v in fsdp.STATS.items()}}


def _piece_checksum(t: torch.Tensor, box=None, whole_shape=None) -> torch.Tensor:
    """``_checksum``'s two sums (int64 on ``t``'s device) of the piece ``t`` of a whole
    leaf: ``box`` (per dim, the piece's start and length in ``whole_shape``) places
    each word at its position in the whole leaf, so the pieces' sums add up to the
    whole leaf's ``_checksum``; None: ``t`` is the whole leaf."""
    words = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    shape = list(t.shape) if whole_shape is None else list(whole_shape)
    starts = [0] * len(shape) if box is None else [s for s, _ in box]
    strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    sums = torch.zeros(2, dtype=torch.int64, device=t.device)
    for first in range(0, words.numel(), 1 << 26):
        x = words[first:first + (1 << 26)].to(torch.int64)
        q = torch.arange(first, first + x.numel(), device=t.device, dtype=torch.int64)
        pos = torch.zeros_like(q)
        for d in reversed(range(t.dim())):
            pos += (q % t.shape[d] + starts[d]) * strides[d]
            q //= t.shape[d]
        sums += torch.stack([x.sum(), (x * (2 * pos + 1)).sum()])
    return sums


def state_checksums(acc, state) -> dict:
    """``{path: (plain, weighted)}`` of every whole tensor leaf of a train state, from
    each rank's pieces: each distinct piece's sums (the ranks holding a copy of one add
    it once) added over the ranks in one all-reduce; no leaf is gathered."""
    from accelerate_tpu_torch import checkpointing as ck
    from accelerate_tpu_torch.parallel.tp import all_reduce

    flat = ck._flat_state(state)
    live = ck._state_index(flat, acc, ck._split_dims(state, flat, acc.mesh))
    paths, sums = [], []
    for leaf in live["leaves"]:
        if "value" in leaf:
            continue
        split_axes = {a for a, key in (("tp", "split"), ("fsdp", "fsdp_split"))
                      if leaf.get(key) is not None}
        mine = acc.mesh is None or all(
            i == 0 for a, i in acc.mesh.coords.items() if a not in split_axes)
        box = ck.leaf_box(leaf, live)
        sums.append(_piece_checksum(flat[leaf["path"]], box, leaf["whole_shape"]).cpu()
                    if mine else torch.zeros(2, dtype=torch.int64))
        paths.append(leaf["path"])
    total = torch.stack(sums).contiguous()
    if acc.mesh is not None and acc.mesh.size > 1:
        all_reduce(total, "sum", torch.distributed.group.WORLD)
    return {p: tuple(int(v) for v in row) for p, row in zip(paths, total)}


def _param_agreement(acc, state, ref: dict) -> dict:
    """Each rank's params against its slice of the one-rank arm's (``ref``: ``{path:
    tensor}`` on the card, the parent's, mapped through CUDA IPC): the largest
    difference and the share within lr / 2 over the whole params (the counts of
    replicated pieces taken once), in one all-reduce."""
    from accelerate_tpu_torch import checkpointing as ck
    from accelerate_tpu_torch.parallel.tp import all_reduce

    flat = ck._flat_state(state)
    live = ck._state_index(flat, acc, ck._split_dims(state, flat, acc.mesh))
    worst, within, n = 0.0, 0, 0
    for leaf in live["leaves"]:
        if not leaf["path"].startswith("params/"):
            continue
        box = ck.leaf_box(leaf, live)
        want = ref[leaf["path"].removeprefix("params/")][tuple(slice(s, s + k) for s, k in box)]
        diff = (flat[leaf["path"]] - want).abs()
        worst = max(worst, float(diff.max()))
        split = leaf.get("split") is not None or leaf.get("fsdp_split") is not None
        if split or acc.mesh.coords["fsdp"] == 0:
            within += int((diff <= FSDP_LR / 2).sum())
            n += diff.numel()
    stats = torch.tensor([float(within), float(n)], dtype=torch.float64)
    top = torch.tensor([worst], dtype=torch.float64)
    all_reduce(stats, "sum", torch.distributed.group.WORLD)
    all_reduce(top, "max", torch.distributed.group.WORLD)
    return {"params_max_abs_diff": float(top[0]),
            "params_share_within_half_lr": float(stats[0] / stats[1])}


def _free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def fsdp_rank_main(packed: dict, device: str, refs: dict, ckpt_dir: str) -> dict:
    """One rank of ``train_fsdp`` and ``fsdp_ckpt`` (two gloo ranks sharing the card,
    dp1×fsdp2). The arms ZeRO-3, ZeRO-2, ZeRO-1 (FSDP_STEPS each) on the packed batch,
    each held to the one-rank arm's params after as many steps (``refs``: the parent's
    tensors on the card, mapped here through CUDA IPC), then a depth-FSDP_CKPT_LAYERS
    ZeRO-3 state saved SHARDED and FULL_STATE_DICT, trained a step, and the FULL
    checkpoint loaded back in place."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.parallel import MeshConfig, fsdp
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin
    from accelerate_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
    out = {"arms": {}}

    def accelerator(stage, **plugin_kw):
        AcceleratorState._reset_state()
        GradientState._reset_state()
        return Accelerator(mixed_precision="bf16", device=dev, backend="gloo",
                           mesh_config=MeshConfig(**FSDP_MESH),
                           fsdp_plugin=FullyShardedDataParallelPlugin(zero_stage=stage,
                                                                      **plugin_kw))

    for stage, steps in FSDP_STEPS.items():
        t_arm = time.perf_counter()
        acc = accelerator(stage)
        run = _fsdp_train(acc, _fsdp_cfg(FSDP_LAYERS), 0, batch, steps)
        run["train_wall_s"] = time.perf_counter() - t_arm
        state = run.pop("state")
        run.pop("step")
        run["resident_bytes"] = _state_bytes(state, _own_bytes(state, acc.mesh, stage))
        # Leaves below min_weight_size stay whole: params, 2 moments and a gradient each.
        run["replicated_bytes"] = 4 * sum(
            p.numel() * p.element_size() for p, d in zip(
                tree_leaves(state.params), state.fsdp_dims or [None] * 10**6) if d is None)
        t1 = time.perf_counter()
        run.update(_param_agreement(acc, state, refs[steps]))
        run["agreement_s"] = time.perf_counter() - t1
        run["routes"] = {k: fsdp.collective_route(acc.mesh.group("fsdp"), state.params["ln_f"])
                         for k in ("all_gather", "reduce_scatter")}
        run["rank"], run["distributed_type"] = acc.process_index, str(acc.distributed_type)
        out["arms"][stage] = run
        del state
        _free_cuda()
        run["arm_wall_s"] = time.perf_counter() - t_arm

    # fsdp_ckpt: SHARDED, then FULL_STATE_DICT, on a depth-FSDP_CKPT_LAYERS ZeRO-3 state.
    t_ck = time.perf_counter()
    acc = accelerator(3)
    run = _fsdp_train(acc, _fsdp_cfg(FSDP_CKPT_LAYERS), 1, batch, 1)
    state, step = run["state"], run["step"]
    ck = {"steps_before_save": 1, "setup_s": time.perf_counter() - t_ck}
    t0 = time.perf_counter()
    acc.save_state(str(Path(ckpt_dir) / "sharded"), train_state=state)
    ck["sharded_save_s"] = time.perf_counter() - t0
    ck["sharded_stats"] = acc.checkpoint_stats["save"]
    ck["saved_checksums"] = state_checksums(acc, state)
    acc.fsdp_plugin.state_dict_type = "FULL_STATE_DICT"
    t0 = time.perf_counter()
    acc.save_state(str(Path(ckpt_dir) / "full"), train_state=state)
    ck["full_save_s"] = time.perf_counter() - t0
    ck["full_stats"] = acc.checkpoint_stats["save"]
    ck["full_files"] = sorted(os.listdir(Path(ckpt_dir) / "full"))
    state, _ = step(state, batch)  # the state moves on before the load
    ck["moved_checksums_differ"] = state_checksums(acc, state) != ck["saved_checksums"]
    t0 = time.perf_counter()
    state = acc.load_state(str(Path(ckpt_dir) / "full"), train_state=state)
    ck["full_load_s"] = time.perf_counter() - t0
    ck["full_load_checksums"] = state_checksums(acc, state)
    ck["rank"] = acc.process_index
    ck["wall_s"] = time.perf_counter() - t_ck
    out["ckpt"] = ck
    del state, step
    AcceleratorState._reset_state()
    GradientState._reset_state()
    _free_cuda()
    return out


def shared_ranks(jobs) -> dict:
    """The rank function of ``phase_train_ranks``' one launch: each ``(function name,
    args)`` of ``jobs`` in turn on a fresh ``AcceleratorState`` (the process group and
    the warmed process stay): its result and wall seconds (``jobs``), and the host clock
    when the rank entered this function and left it (the launch's start and exit around
    them)."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    # The jobs' modules, imported before the preload.
    import accelerate_tpu_torch.accelerator  # noqa: F401
    import accelerate_tpu_torch.checkpointing  # noqa: F401
    import accelerate_tpu_torch.models.llama  # noqa: F401
    import accelerate_tpu_torch.ops.fused_xent  # noqa: F401
    import torch.profiler  # noqa: F401

    entered = time.time()
    preload_dynamo()  # loads during the first (tp parity) job, which has no remat
    out = []
    for name, args in jobs:
        AcceleratorState._reset_state()
        GradientState._reset_state()
        t0 = time.perf_counter()
        result = globals()[name](*args)
        out.append((result, time.perf_counter() - t0))
        _free_cuda()
    return {"jobs": out, "entered_unix": entered, "left_unix": time.time()}


def phase_train_ranks(dev, work: Path) -> dict:
    """One spawn of two gloo ranks sharing the card for ``train_tp_parity``,
    ``train_tp`` and ``train_fsdp`` (with ``fsdp_ckpt``'s saves), in that order
    (``shared_ranks``): a rank process pays its start and its first step's warm-up
    (10-20 s each) once. Before the launch, ``train_fsdp``'s one-rank arm runs here and
    its params after 2 and 3 steps stay on the card for the ranks (CUDA IPC) until the
    launch returns; during it, ``fsdp_ckpt_loads`` runs in a thread here. Returns each
    job's per-rank results and the launch's seconds; the phases' reports and checks
    follow."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.launchers import notebook_launcher
    from accelerate_tpu_torch.utils.tree import named_parameters

    _fresh_state_singletons()
    packed, docs = packed_batch(_fsdp_cfg(1).vocab_size, 2, seed=20)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
    refs = {}

    def snapshot(i, state):  # the params after each arm's step count, for the ranks
        if i in FSDP_STEPS.values():
            refs[i] = {k: v.detach().clone() for k, v in named_parameters(state.params).items()}

    one = _fsdp_train(Accelerator(mixed_precision="bf16", device=dev), _fsdp_cfg(FSDP_LAYERS),
                      0, batch, max(FSDP_STEPS.values()), after_step=snapshot)
    state = one.pop("state")
    one["resident_bytes"] = _state_bytes(state, _own_bytes(state, None, 0))
    del state, one["step"], one["collectives_per_step"], batch
    _fresh_state_singletons()
    _free_cuda()
    card = _rank_device(dev)
    jobs = [("tp_rank_parity", (_tp_parity_tokens(), TP_PARITY_LR, TP_PARITY_STEPS, card)),
            ("tp_rank_main", (_tp_main_tokens(), card)),
            ("fsdp_rank_main", (packed, card, refs, str(work / "ckpt")))]
    parent_bytes = torch.cuda.memory_allocated()
    # fsdp_ckpt's loads in this process run in a thread beside the ranks, each as soon as
    # the ranks' checkpoint it reads has committed.
    loads, done = {}, threading.Event()

    def load_beside():
        try:
            loads.update(fsdp_ckpt_loads(dev, work / "ckpt", done))
        except BaseException as e:  # re-raised below, after the launch
            loads["error"] = e

    thread = threading.Thread(target=load_beside, daemon=True)
    t0, t0_unix = time.perf_counter(), time.time()
    thread.start()
    try:
        launched = notebook_launcher(shared_ranks, (jobs,), 2, device=card, backend="gloo",
                                     timeout_s=1200)
    finally:
        launch_s, t1_unix = time.perf_counter() - t0, time.time()
        done.set()
        thread.join()
    ranks = [r["jobs"] for r in launched]
    refs.clear()
    _free_cuda()
    if "error" in loads:
        raise loads["error"]
    walls = {name: [r[k][1] for r in ranks] for k, (name, _) in enumerate(jobs)}
    emit({"phase": "train_ranks", "launch_s": launch_s, "job_wall_s_by_rank": walls,
          # From the launch to each rank's first job (spawn, imports, the process group)
          # and from its last job to the launch's return (exit, results read back).
          "rank_start_s": [r["entered_unix"] - t0_unix for r in launched],
          "rank_exit_s": [t1_unix - r["left_unix"] for r in launched],
          "parent_allocated_bytes_during_launch": parent_bytes,
          "fsdp_ckpt_loads_thread_s": loads["thread_s"],
          "fsdp_ckpt_loads_waited_s": loads["waited_s"]})
    out = {name: ([r[k][0] for r in ranks], max(walls[name]))
           for k, (name, _) in enumerate(jobs)}
    out["fsdp_inputs"] = {"one": one, "packed": packed, "docs": docs, "loads": loads}
    return out


def phase_train_fsdp(dev, work: Path, launched, inputs: dict) -> dict:
    """ZeRO/FSDP training at Llama-3-8B's width, depth FSDP_LAYERS, on one seeded packed
    batch (2 rows of 2048): against a one-rank replicated arm (``inputs["one"]``, run by
    ``phase_train_ranks``, whose params after 2 and 3 steps the ranks read through CUDA
    IPC), two gloo ranks sharing the card (dp1×fsdp2) ran the ZeRO-3, ZeRO-2 and ZeRO-1
    arms (``fsdp_rank_main``), and after them ``fsdp_ckpt``'s saves (``launched``: their
    results and seconds). Every arm's losses within FSDP_LOSS_TOL of the one-rank arm's;
    its params after its steps with every element within 2·lr a step and
    FSDP_PARAM_SHARE of them within lr / 2 of the one-rank arm's; ZeRO-3's resident fp32
    state (params, gradients, moments) half of the one-rank arm's on each rank, give or
    take the leaves below ``min_weight_size``; kernel #9 once a step a rank, #2-#4
    2L/L/L (remat). Prints each arm's step ms, each rank's peak memory, the gathered and
    reduce-scattered bytes a step and the collective route the gloo group took
    (``cuda_ipc``: the ranks share the card)."""
    one, packed, docs = inputs["one"], inputs["packed"], inputs["docs"]
    ranks, launch_s = launched
    parent_bytes = torch.cuda.memory_allocated()
    try:
        L = FSDP_LAYERS
        res = {"phase": "train_fsdp", "config": "llama3-8b", "layers": L, "mesh": FSDP_MESH,
               "backend": "gloo (2 ranks share one card; the fsdp collectives through CUDA IPC)",
               "packed": packed_layout(packed, docs), "one_rank": one, "launch_s": launch_s, "parent_allocated_bytes": parent_bytes,
               "loss_tol_rel": FSDP_LOSS_TOL, "params_share_min": FSDP_PARAM_SHARE,
               "arms": {}}
        ok = True
        for stage, steps in FSDP_STEPS.items():
            expect = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                      "flash_bwd_dkv": L * steps, "fused_adamw": steps}
            arm = {"steps": steps, "launches_expected_per_rank": expect, "ranks": []}
            for r in ranks:
                a = r["arms"][stage]
                rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], one["losses"]))
                a_ok = (rel <= FSDP_LOSS_TOL and a["launches"] == expect
                        and all(np.isfinite(a["losses"]))
                        and a["params_max_abs_diff"] <= 2 * FSDP_LR * steps
                        and a["params_share_within_half_lr"] >= FSDP_PARAM_SHARE)
                if stage == 3:
                    a["resident_share_of_one_rank"] = a["resident_bytes"]["total"] / one[
                        "resident_bytes"]["total"]
                    a_ok = a_ok and 2 * a["resident_bytes"]["total"] == (
                        one["resident_bytes"]["total"] + a["replicated_bytes"])
                ok = ok and a_ok
                arm["ranks"].append({**a, "loss_max_rel_err": rel, "ok": a_ok})
            arm["step_ms"] = max(float(np.mean(r["arms"][stage]["step_ms_runs"][1:]))
                                 for r in ranks)
            res["arms"][f"zero{stage}"] = arm
        res["ok"] = ok
        emit(res)
        ckpt = phase_fsdp_ckpt(dev, ranks, inputs["loads"], work / "ckpt")
        if not ok:
            raise SystemExit("ZeRO/FSDP training at 8B width failed its checks")
        return {"launches": {k: sum(r["arms"][s]["launches"][k] for s in FSDP_STEPS
                                    for r in ranks[:1]) for k in ranks[0]["arms"][3]["launches"]},
                "res": res, "ckpt": ckpt}
    finally:
        shutil.rmtree(work / "ckpt", ignore_errors=True)


def _wait_for(path: Path, done: threading.Event) -> None:
    """Until ``path`` exists; raises once ``done`` is set without it."""
    while not path.exists():
        if done.is_set() and not path.exists():
            raise RuntimeError(f"{path} never appeared: the ranks stopped before writing it")
        time.sleep(0.2)


def fsdp_ckpt_loads(dev, ckpt_dir: Path, done: threading.Event) -> dict:
    """This process's side of ``fsdp_ckpt``, run in a thread while the ranks run on: as
    each checkpoint of the ranks commits (its marker written last), the SHARDED one is
    loaded into a one-rank replicated state (the reshard), then merged by
    ``merge-weights`` in a thread of its own (its params' checksums) while the FULL one
    is awaited and loaded into the same state. Each leaf's checksums are taken after
    each load."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.checkpointing import COMMIT_MARKER
    from accelerate_tpu_torch.commands.merge import merge_weights
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import fused_optim as fo

    t_start = time.perf_counter()
    out = {}
    _wait_for(ckpt_dir / "sharded" / COMMIT_MARKER, done)
    out["waited_s"] = time.perf_counter() - t_start
    cfg = _fsdp_cfg(FSDP_CKPT_LAYERS)
    acc = Accelerator(mixed_precision="bf16", device=dev)
    params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                               generator=torch.Generator(dev).manual_seed(3), device=dev)
    state = acc.create_train_state(params, fo.fused_adamw(FSDP_LR))
    del params

    def load(name, fmt):
        nonlocal state
        _wait_for(ckpt_dir / name / COMMIT_MARKER, done)
        t0 = time.perf_counter()
        state = acc.load_state(str(ckpt_dir / name), train_state=state)
        out[f"{fmt}_s"] = time.perf_counter() - t0
        out[f"{fmt}_stats"] = dict(acc.checkpoint_stats["load"])
        out[f"{fmt}_checksums"] = state_checksums(acc, state)

    def merge():
        try:
            t0 = time.perf_counter()
            merge_weights(str(ckpt_dir / "sharded"), str(ckpt_dir / "merged"))
            out["merge_s"] = time.perf_counter() - t0
            out["merged_checksums"] = {
                f"params/{k}": tuple(int(x) for x in _piece_checksum(v.to(dev)))
                for k, v in _safetensors_tensors(ckpt_dir / "merged").items()}
            shutil.rmtree(ckpt_dir / "merged", ignore_errors=True)
        except BaseException as e:  # re-raised below
            out["merge_error"] = e

    load("sharded", "reshard_2_to_1")
    merging = threading.Thread(target=merge, daemon=True)
    merging.start()
    load("full", "full_into_1")
    merging.join()
    if "merge_error" in out:
        raise out.pop("merge_error")
    del state, acc
    _free_cuda()
    out["thread_s"] = time.perf_counter() - t_start
    return out


def phase_fsdp_ckpt(dev, ranks, loads: dict, ckpt_dir: Path) -> dict:
    """The checkpoints the ranks of ``train_fsdp`` saved (depth FSDP_CKPT_LAYERS, ZeRO-3,
    in host memory under /dev/shm): the SHARDED save loaded into a one-rank replicated
    state (the reshard) and the FULL_STATE_DICT checkpoint loaded into one rank
    (``loads``: ``fsdp_ckpt_loads``, run while the ranks ran on), each bitwise equal to
    the ranks' gathered state (per-leaf checksums); the FULL checkpoint loaded back
    into the 2 ranks, bitwise; ``merge-weights`` of the SHARDED save bitwise equal to
    the gathered params."""
    saved = ranks[0]["ckpt"]["saved_checksums"]
    res = {"phase": "fsdp_ckpt", "config": "llama3-8b", "layers": FSDP_CKPT_LAYERS,
           "where": str(ckpt_dir), "ranks": [{k: v for k, v in r["ckpt"].items()
                                              if not k.endswith("checksums")}
                                             for r in ranks],
           **{k: v for k, v in loads.items() if not k.endswith("checksums")}}
    checks = {"ranks_saved_the_same_state": all(r["ckpt"]["saved_checksums"] == saved
                                                for r in ranks),
              "full_reload_on_two_ranks_bitwise": all(
                  r["ckpt"]["full_load_checksums"] == saved and r["ckpt"]["moved_checksums_differ"]
                  for r in ranks),
              "full_file_without_sharded_state": all(
                  "model_full.pkl" in r["ckpt"]["full_files"]
                  and "sharded_state" not in r["ckpt"]["full_files"] for r in ranks),
              "reshard_2_to_1_bitwise": loads["reshard_2_to_1_checksums"] == saved,
              "full_into_1_bitwise": loads["full_into_1_checksums"] == saved,
              "merge_weights_bitwise": loads["merged_checksums"] == {
                  k: v for k, v in saved.items() if k.startswith("params/")}}
    res.update(checks=checks, ok=all(checks.values()))
    emit(res)
    if not res["ok"]:
        raise SystemExit("ZeRO/FSDP checkpoints at 8B width failed their checks")
    return res


def _offload_arm(dev, cfg, batch, steps: int, offload: bool, cast_params: bool = True,
                 checksums: bool = True) -> dict:
    """``steps`` of the slice-20 recipe on one rank, with the optimizer state in host
    memory when ``offload`` (``FullyShardedDataParallelPlugin(zero_stage=0,
    cpu_offload=True)``): losses, step times, launches, the moment stream's stats a
    step, whether every moment stayed on the host, pinned, after every step, and the
    resident bytes."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.ops import fused_optim as fo
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin
    from accelerate_tpu_torch.utils.tree import tree_leaves

    _fresh_state_singletons()
    acc = Accelerator(mixed_precision="bf16", device=dev, fsdp_plugin=(
        FullyShardedDataParallelPlugin(zero_stage=0, cpu_offload=True) if offload else None))
    streams, on_host = [], [True]

    def after_step(i, state):
        if offload:
            streams.append(dict(fo.OFFLOAD_STATS))
            on_host[0] = on_host[0] and all(
                t.device.type == "cpu" and t.is_pinned()
                for t in tree_leaves([state.opt_state.mu, state.opt_state.nu]))

    run = _fsdp_train(acc, cfg, 0, batch, steps, after_step=after_step,
                      cast_params=cast_params)
    state = run.pop("state")
    del run["step"], run["collectives_per_step"]
    moments = tree_leaves([state.opt_state.mu, state.opt_state.nu])
    run.update(streams=streams, moments_on_pinned_host=on_host[0] if offload else None,
               pinned_host_bytes=sum(t.numel() * t.element_size() for t in moments
                                     if t.device.type == "cpu"),
               resident_bytes=_state_bytes(state, _own_bytes(state, None, 0)),
               sizes=[p.numel() for p in tree_leaves(state.params)])
    if checksums:  # moments on the host are summed on the card, a leaf at a time
        run["checksums"] = [tuple(int(x) for x in _piece_checksum(t.to(dev)))
                            for t in tree_leaves([state.params, state.opt_state])
                            if torch.is_tensor(t)]
    del state, acc
    _fresh_state_singletons()
    _free_cuda()
    return run


def _offload_depth() -> tuple[int, dict]:
    """The deepest Llama-3-8B cut up to OFFLOAD_LAYERS whose fp32 params and gradients
    (8 bytes a param) fit the card's free memory with 8 GB to spare, and whose moments
    (8 bytes a param) fit the host's available memory with 4 GB to spare."""
    from accelerate_tpu_torch.models import llama

    free, _ = torch.cuda.mem_get_info()
    host = _meminfo("MemAvailable")
    for layers in range(OFFLOAD_LAYERS, 0, -1):
        n = llama.num_params(_fsdp_cfg(layers))
        if 8 * n + (8 << 30) <= free and 8 * n + (4 << 30) <= host:
            break
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))
    return layers, {"device_free_bytes": free, "host_available_bytes": host,
                    "host_total_bytes": _meminfo("MemTotal"), "shmem_bytes": _meminfo("Shmem"),
                    "this_process_rss_bytes": rss,
                    "params": llama.num_params(_fsdp_cfg(layers)),
                    "params_at_full_depth": llama.num_params(_fsdp_cfg(OFFLOAD_LAYERS))}


def phase_train_offload(dev) -> dict:
    """ZeRO-Offload on one rank: (a) depth FSDP_LAYERS, 3 steps with the moments in
    pinned host memory against the same steps without offload: params and moments
    bitwise (per-leaf checksums: the same kernel on the same elements, in chunks);
    (b) Llama-3-8B at full depth (32 layers; else the deepest the card and the host
    hold, by arithmetic before the run), one packed row of 2048, ``cast_params=False``,
    1 warm-up and 2 timed steps: losses finite and not rising, every moment on the host
    and pinned after every step, kernel #9 once a chunk."""
    from accelerate_tpu_torch.ops import fused_optim as fo

    cfg = _fsdp_cfg(FSDP_LAYERS)
    packed, _ = packed_batch(cfg.vocab_size, 2, seed=20)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
    plain = _offload_arm(dev, cfg, batch, 3, offload=False)
    off = _offload_arm(dev, cfg, batch, 3, offload=True)
    chunks = len(fo.offload_chunks([n for n in off["sizes"] if n % 1024 == 0],
                                   fo.OFFLOAD_CHUNK_ELEMS))
    a = {"layers": FSDP_LAYERS, "losses": off["losses"], "losses_no_offload": plain["losses"],
         "bitwise": off["checksums"] == plain["checksums"] and off["losses"] == plain["losses"],
         "step_ms_runs": off["step_ms_runs"], "step_ms_runs_no_offload": plain["step_ms_runs"],
         "chunks_per_step": chunks, "launches": off["launches"],
         "moments_on_pinned_host": off["moments_on_pinned_host"],
         "pinned_host_bytes": off["pinned_host_bytes"], "stream": off["streams"][-1]}
    a["ok"] = (a["bitwise"] and a["moments_on_pinned_host"]
               and off["launches"]["fused_adamw"] == 3 * chunks)
    del plain, off
    layers, room = _offload_depth()
    packed1, docs1 = packed_batch(cfg.vocab_size, 1, seed=21)
    batch1 = {k: torch.as_tensor(v, device=dev) for k, v in packed1.items()}
    full = _offload_arm(dev, _fsdp_cfg(layers), batch1, OFFLOAD_STEPS, offload=True,
                        cast_params=False, checksums=False)
    chunks = len(fo.offload_chunks([n for n in full["sizes"] if n % 1024 == 0],
                                   fo.OFFLOAD_CHUNK_ELEMS))
    timed = full["streams"][1:]
    moment_bytes = full["pinned_host_bytes"]
    b = {"layers": layers, "full_depth": layers == OFFLOAD_LAYERS, "room_before": room,
         "packed": packed_layout(packed1, docs1),
         "losses": full["losses"], "step_ms_runs": full["step_ms_runs"],
         "step_ms": float(np.mean(full["step_ms_runs"][1:])), "init_s": full["init_s"],
         "init_peak_bytes": full["init_peak_bytes"], "step_peak_bytes": full["step_peak_bytes"],
         "pinned_host_bytes": moment_bytes, "chunks_per_step": chunks,
         "launches": full["launches"], "moments_on_pinned_host": full["moments_on_pinned_host"],
         "h2d_s": [s["h2d_s"] for s in timed], "d2h_s": [s["d2h_s"] for s in timed],
         "h2d_gb_per_s": [s["h2d_bytes"] / s["h2d_s"] / 1e9 for s in timed if s["h2d_s"]],
         "d2h_gb_per_s": [s["d2h_bytes"] / s["d2h_s"] / 1e9 for s in timed if s["d2h_s"]],
         "apply_s": [s["s"] for s in timed]}
    b["ok"] = (all(np.isfinite(full["losses"]))
               and all(y <= x for x, y in zip(full["losses"], full["losses"][1:]))
               and full["moments_on_pinned_host"]
               and full["launches"]["fused_adamw"] == OFFLOAD_STEPS * chunks)
    # A depth below OFFLOAD_LAYERS passes (the host's memory bounds it) but is flagged.
    res = {"phase": "train_offload", "config": "llama3-8b", "depth_2": a, "deep": b,
           "full_depth": b["full_depth"], "ok": a["ok"] and b["ok"]}
    emit(res)
    if not res["ok"]:
        raise SystemExit("cpu_offload training failed its checks")
    return {"launches": {k: a["launches"][k] + full["launches"][k] for k in a["launches"]},
            "layers": layers, "full_depth": b["full_depth"], "res": res}


def _kernel_row(name, source, replaces, launches, max_abs_err, t, library=None,
                **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"), "library": library,
            **extra}


def preload_dynamo() -> threading.Thread:
    """Import ``torch._dynamo`` in a thread: the first checkpointed block imports it
    (``torch._disable_dynamo``), 5-9 s of loading in a fresh process, so the process
    loads it while it does other work. Start it after the thread that goes on has done
    its own imports (two threads importing one module in turn is safe; a cycle is not)."""
    thread = threading.Thread(target=__import__, args=("torch._dynamo",), daemon=True)
    thread.start()
    return thread


def main() -> int:
    # A worker process of the elastic phases (started by this script's supervisor or
    # the launch CLI it runs): its mode and spec follow the script's path.
    if sys.argv[1:2] == ["--elastic-worker"]:
        return elastic_worker(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--gang-worker"]:
        return gang_worker(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        for proc, _ in (EARLY_BUILD or {}).get("procs", {}).values():
            proc.kill()
            proc.wait()
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
    build = EARLY_BUILD or _build.start(["fused_xent"] if fwd_only
                                        else list(_build.KERNEL_SOURCES))
    # torch._dynamo (imported by the first checkpointed block) is imported, and its
    # bytecode written to PYCACHE for the processes started later, while nvcc builds
    # (started before torch was imported).
    preload = preload_dynamo()
    # The training kernels first: paged attention's source takes the longest to compile
    # (54-61 s of a 61 s build on one machine, the next 25 s), so the training phases
    # that launch only flash attention, AdamW and the fused CE run while it compiles.
    train_sources = ["fused_xent"] if fwd_only else list(TRAIN_SOURCES)
    libs = run_phase("device", _build.finish, build, train_sources)
    preload.join()
    build_wait_s = {"training_kernels": time.perf_counter() - t0}

    def report_build() -> None:
        for lib in libs.values():
            log = lib.with_suffix(".log")
            if log.exists():
                print(log.read_text(), file=sys.stderr)
        emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": sum(build_wait_s.values()),
              "build_wait_s": build_wait_s, "sources": list(libs)})
        run_phase("spills", check_spills, libs)

    if fwd_only:  # a probe for same-call comparisons
        report_build()
        emit({"phase": "xent_fwd_times", "nvidia_smi": smi,
              **run_phase("xent_fwd_times", xent_fwd_times, dev)})
        return 0

    def finish_build() -> None:
        t1 = time.perf_counter()
        libs.update(run_phase("device_serving", _build.finish, build))
        build_wait_s["serving_kernels"] = time.perf_counter() - t1
        report_build()

    if "--int8-split-sweep" in sys.argv[1:]:  # a probe, run only when asked
        finish_build()
        for t in run_phase("int8_split_sweep", int8_split_sweep,
                           torch.Generator(dev).manual_seed(6), dev):
            emit({"phase": "int8_split_sweep", **t})
        return 0

    # Training (slice 2) while paged attention compiles.
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
    # HF Accelerate's loop surface (slice 22): accumulate() and clip_grad_*_ against the
    # constructor route, no_sync().
    torch.cuda.empty_cache()
    accum = run_phase("train_accumulate", phase_train_accumulate, dev)
    _free_cuda()
    finish_build()

    # Serving (slice 1).
    kern = run_phase("kernel", phase_kernel, dev)
    run_phase("engine", phase_engine, dev)
    # The super-step (slice 10): the same engine replaying CUDA graphs of N steps.
    run_phase("engine_multistep", phase_engine_multistep, dev)
    # The admission path (slice 12): prefix cache and buckets against the CPU.
    run_phase("engine_prefix", phase_engine_prefix, dev)
    # Speculative serving (slice 13) against the CPU.
    run_phase("engine_spec", phase_engine_spec, dev)
    # Disaggregated serving (slice 14) against the CPU.
    run_phase("engine_disagg", phase_engine_disagg, dev)
    serve = run_phase("main", phase_main, dev)
    serve_multi = run_phase("main_multistep", phase_main_multistep, dev, serve)
    serve_prefill = run_phase("main_prefill", phase_main_prefill, dev, serve)
    serve_prefix = run_phase("main_prefix", phase_main_prefix, dev, serve)
    serve_spec = run_phase("main_spec", phase_main_spec, dev, serve)
    serve_spec_draft = run_phase("main_spec_draft", phase_main_spec_draft, dev, serve)
    # Disaggregated prefill/decode serving (slice 14): the gateway stack over two
    # replicas sharing the card and the params.
    serve_disagg = run_phase("main_disagg", phase_main_disagg, dev, serve)
    # The fault boundary and request tracing (slice 15).
    run_phase("engine_faults", phase_engine_faults, dev)
    serve_faults = run_phase("main_faults", phase_main_faults, dev, serve)
    # The serving control plane (slice 16): the serve-bench gates at 8B.
    serve_control = run_phase("main_control", phase_main_control, dev, serve)
    # serve-bench's remaining modes (slice 17) at 8B.
    serve_bench = run_phase("main_bench", phase_main_bench, dev, serve)
    del serve["params"]
    gc.collect()
    torch.cuda.empty_cache()
    run_phase("generate", phase_generate, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # fp8 training (slice 19): the products against their plain version, then
    # train_main's recipe under fp8 with delayed scaling, O1 and O2.
    run_phase("fp8_dot_check", phase_fp8_dot_check, dev)
    torch.cuda.empty_cache()
    train_fp8 = run_phase("train_fp8", phase_train_fp8, dev, train["losses"][0])
    # Training I/O (slice 11): save and resume at 8B width, then the checkpoint rules.
    torch.cuda.empty_cache()
    resume = run_phase("train_resume", phase_train_resume, dev)
    run_phase("checkpoint_debug", phase_checkpoint_debug, dev)
    # Elastic training under the supervisor and through the launch CLI (slice 18): the
    # gang's launch runs beside elastic_train (both mostly start processes and write
    # checkpoints); elastic_gang then waits for it.
    gang_run = run_phase("elastic_gang_start", start_elastic_gang, dev)
    try:
        elastic = run_phase("elastic_train", phase_elastic_train, dev)
        gang = run_phase("elastic_gang", phase_elastic_gang, dev, gang_run)
    finally:
        stop_elastic_gang(gang_run)

    # Int8 weight-only serving (slice 4).
    torch.cuda.empty_cache()
    int8 = run_phase("int8_matmul", phase_int8_matmul, dev)
    run_phase("quant_engine_vs_cpu", phase_engine, dev, "int8")
    run_phase("quant_engine_vs_cpu", phase_engine, dev, "nf4")
    serve_int8 = run_phase("main_int8", phase_main_int8, dev)
    # LoRA (slice 19) over main_int8's 8B params: adapters on the bf16 base, then in the
    # closure form over the int8 base.
    lora_run = run_phase("train_lora", phase_train_lora, dev, serve_int8.pop("dense_params"))
    gc.collect()
    torch.cuda.empty_cache()
    qlora = run_phase("qlora_closure", phase_qlora_closure, dev, serve_int8.pop("int8_params"))

    # Tensor-parallel training (slice 5): the parent frees its cached memory first, since
    # the two ranks share the card.
    gc.collect()
    torch.cuda.empty_cache()
    partial = run_phase("fused_xent_partial", phase_fused_xent_partial, dev)

    # ZeRO/FSDP, cpu_offload and packed batches (slice 20).
    _free_cuda()
    packed = run_phase("packed_check", phase_packed_check, dev)
    _free_cuda()
    offload = run_phase("train_offload", phase_train_offload, dev)
    _free_cuda()
    # The multi-rank training phases share one launch of two gloo ranks (slices 5, 20).
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fsdp_", dir=SHM if SHM.is_dir() else None))
    try:
        shared = run_phase("train_ranks", phase_train_ranks, dev, work)
        run_phase("train_tp_parity", phase_train_tp_parity, dev, shared["tp_rank_parity"])
        train_tp = run_phase("train_tp", phase_train_tp, dev, train["losses"][0],
                             shared["tp_rank_main"])
        fsdp_run = run_phase("train_fsdp", phase_train_fsdp, dev, work,
                             shared["fsdp_rank_main"], shared["fsdp_inputs"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit({"phase_seconds": dict(PHASE_SECONDS),
          "total_s": time.perf_counter() - t0, "nvidia_smi": smi})
    emit({"kernels": run_phase("kernels", kernel_rows, kern, serve, flash, adamw,
                               xent, train, train_fused, int8, serve_int8, partial,
                               train_tp, serve_multi, resume, serve_prefill,
                               serve_prefix, serve_spec, serve_spec_draft, serve_disagg,
                               serve_faults, serve_control, serve_bench, elastic, gang,
                               train_fp8, lora_run, qlora, packed, fsdp_run, offload,
                               accum)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_rows(kern, serve, flash, adamw, xent, train, train_fused, int8, serve_int8,
                partial, train_tp, serve_multi, resume, serve_prefill, serve_prefix,
                serve_spec, serve_spec_draft, serve_disagg, serve_faults,
                serve_control, serve_bench, elastic, gang, train_fp8, lora_run,
                qlora, packed, fsdp_run, offload, accum) -> list:
    """The kernels line: one row per kernel of the port, from the phases' results. The
    serving kernels' launches add their main paths' runs: N = 1, the super-step's,
    the bucketed, the prefix-cache, the speculative, the disaggregated drains (the
    decode replicas' launches over adopted pages; eager launches plus graph nodes times
    replays, with the kill and crash runs), the faulted 8B drain and the control plane's
    paged benches (trace replay and both chaos arms) and serve-bench's remaining modes'
    paged engines; the training kernels' add train_main's, train_resume's and the elastic
    phases' worker processes' (every attempt's and the uninterrupted worker's, counted by
    each worker's own counters; the gang's relaunched ranks), and slice 20's: the packed
    forward's segment route, rank 0 of train_fsdp's three ZeRO arms, and train_offload's
    arms (#9 once a chunk); and slice 22's train_accumulate (its arm A, the
    ``accumulate()`` route)."""

    def train_launches(kernel):
        by_path = {"train_main": train["launches"][kernel],
                   "train_resume": resume["launches"][kernel],
                   "elastic_train": elastic["launches_total"][kernel],
                   "elastic_gang": gang["launches"][kernel],
                   "train_fp8_o1": train_fp8["arms"]["O1"]["launches"][kernel],
                   "train_fp8_o2": train_fp8["arms"]["O2"]["launches"][kernel],
                   "train_lora": lora_run["launches"][kernel],
                   "packed_check": packed["launches"].get(kernel, 0),
                   "train_fsdp": fsdp_run["launches"][kernel],
                   "train_offload": offload["launches"][kernel],
                   "train_accumulate": accum["launches"][kernel]}
        # train_offload (b)'s launches are those of the depth it ran.
        return sum(by_path.values()), {"launches_by_path": by_path,
                                       "train_offload_layers": offload["layers"],
                                       "train_offload_full_depth": offload["full_depth"]}

    lora_paged = lora_run["serving"]["paged_attention_launches"]

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
                    "accelerate_tpu/ops/paged_attention.py:106",
                    serve["launches"] + serve_multi["launches"] + serve_prefill["launches"]
                    + serve_prefix["launches"] + serve_spec["launches"]
                    + serve_spec_draft["launches"] + serve_disagg["launches"]
                    + serve_disagg["launches_kill"] + serve_faults["launches_crash"]
                    + serve_faults["launches"] + serve_control["launches"]
                    + serve_bench["launches"] + lora_paged["adapted"]
                    + lora_paged["merged"],
                    kern["max_abs_err"], kern, design=PAGED_DESIGN,
                    launches_by_path={"main": serve["launches"],
                                      "main_multistep": serve_multi["launches"],
                                      "main_prefill": serve_prefill["launches"],
                                      "main_prefix": serve_prefix["launches"],
                                      "main_spec": serve_spec["launches"],
                                      "main_spec_draft": serve_spec_draft["launches"],
                                      "main_disagg": serve_disagg["launches"],
                                      "main_disagg_kill": serve_disagg["launches_kill"],
                                      "main_disagg_crash": serve_faults["launches_crash"],
                                      "main_faults": serve_faults["launches"],
                                      "main_control": serve_control["launches"],
                                      "main_bench": serve_bench["launches"],
                                      "train_lora_adapted": lora_paged["adapted"],
                                      "train_lora_merged": lora_paged["merged"]},
                    t4_verify={k: kern["t4"][k] for k in ("kernel_ms", "plain_ms",
                                                         "bound_ms", "bound_by", "route")},
                    max_abs_err_t4_verify=kern["max_abs_err_t4"],
                    device_ms_per_spec_super_step=serve_spec["profile"]["paged_attention_ms"],
                    device_ms_per_super_step=serve_multi["profile"][
                        "paged_attention_ms_per_step"],
                    device_kernels_per_decode_step=serve["profile"][
                        "paged_attention_kernels_per_step"],
                    device_kernels_per_decode_step_int8=serve_int8["profile"][
                        "paged_attention_kernels_per_step"]),
        _kernel_row("flash_fwd", csrc + "flash_attention.cu", fa_py + ":155",
                    train_launches("flash_fwd")[0], max(fe["o"], fe["lse"]), ft["fwd"],
                    "scaled_dot_product_attention forward (flash, enable_gqa)",
                    design=FLASH_DESIGN, **train_launches("flash_fwd")[1]),
        _kernel_row("flash_bwd_dq", csrc + "flash_attention.cu", fa_py + ":343",
                    train_launches("flash_bwd_dq")[0], fe["dq"], ft["dq"], bwd_library,
                    design=FLASH_DESIGN, **train_launches("flash_bwd_dq")[1]),
        _kernel_row("flash_bwd_dkv", csrc + "flash_attention.cu", fa_py + ":422",
                    train_launches("flash_bwd_dkv")[0], max(fe["dk"], fe["dv"]), ft["dkv"],
                    bwd_library, design=FLASH_DESIGN, **train_launches("flash_bwd_dkv")[1]),
        _kernel_row("fused_adamw", csrc + "fused_adamw.cu",
                    "accelerate_tpu/ops/fused_optim.py:101", train_launches("fused_adamw")[0],
                    max(adamw["max_abs_err_fp32"], adamw["max_abs_err_bf16"]), adamw,
                    "torch._fused_adamw_", **train_launches("fused_adamw")[1]),
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
                    "accelerate_tpu/ops/quantization.py:153",
                    serve_int8["launches"] + serve_int8["launches_multistep"]
                    + qlora["int8_matmul_launches"],
                    int8["max_abs_err"], int8,
                    "torch._weight_int8pack_mm (weight [N, K], bf16 scales)",
                    launches_by_path={"main_int8": serve_int8["launches"],
                                      "main_int8_multistep": serve_int8["launches_multistep"],
                                      "qlora_closure": qlora["int8_matmul_launches"]},
                    times_at_m2048=qlora["int8_matmul_at_m2048"],
                    device_ms_per_super_step=serve_int8["profile_multistep"][
                        "int8_matmul_union_ms_per_step"],
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

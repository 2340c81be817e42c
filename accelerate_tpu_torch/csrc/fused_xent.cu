// Fused linear + cross-entropy for Hopper (sm_90a), CUDA C++ with plain C entry points.
//
// Replaces four TPU kernels of accelerate_tpu/ops/fused_xent.py:
//   score tiles + fxent_combine_kernel         <- _fwd_kernel     (:82, pallas_call in
//                                                _launch_fwd at :224)
//   score tiles + fxent_combine_partial_kernel <- _fwd_partial_kernel (:96, the same
//                                                pallas_call through _launch_fwd)
//   fxent_ws_kernel (bf16: d, dw, dx per vocab slab) / fxent_bwd_f32_kernel
//                                             <- _bwd_dx_kernel (:128, pallas_call at
//                                                :258) and _bwd_dw_kernel (:151, :277)
// The score tiles are fxent_ws_kernel's statistics epilogue (bf16) or
// fxent_fwd_f32_kernel (fp32). They compute the same functions. x [T,D] and w [D,V]
// share a type (bf16 or fp32);
// targets [T] are int32, and -1 (or any id outside [0, V)) matches no column. Scores
// s = x.w are dots over D in the input type with fp32 sums, capped as cap*tanh(s/cap)
// when cap > 0. Columns at or past V count in no max or sum. The forward writes
// lse = m + log(l) and nll = lse - (the target's score), both fp32. The backward
// recomputes the scores and takes d = (exp(capped - lse) - onehot) * g, times
// 1 - (capped/cap)^2 under the cap; d is rounded to w's type before d.w^T and to x's
// type before x^T.d, both products sum in fp32, and dx / dw are written in x's / w's
// type. The partial forward (the vocab-sharded head of tensor parallelism: w is one
// rank's [D, Vl] slice and the targets are shard-local, so a row whose target another
// rank owns has an id outside [0, Vl)) writes the row's raw online statistics instead:
// m (the max of its capped scores), l (the sum of exp(score - m), taken at that final
// max) and tgt (the target's capped score, 0 when no column matches), all fp32, which
// the ranks merge across the tp group. As in the Pallas kernels, #5 and #6 share their
// score tiles (_online_tile there, the same kernel here) and differ only in what the
// last step writes.
//
// Design. A TPU grid runs in order on one core: the Pallas forward carries (m, l, tgt)
// across the vocab axis in VMEM, and the backward carries a [block_t, D] (dx) or
// [D, block_v] (dw) fp32 sum across a sequential axis -- 4 MB at D = 4096, far past
// the 227 KB of shared memory of one block. Here every product runs in one kernel,
// fxent_ws_kernel: a block of three warpgroups owns a 128 x 256 output tile and sums
// over all of its depth in registers, fed by a TMA producer warp (see below).
//   forward : M = T, N = V, K = D. The statistics epilogue writes, for every
//             row of its tile, the partial (max, sum of exp at that max, target
//             score) of its 256 columns; a combine pass merges a row's cdiv(V, 256)
//             partials in a fixed order (split-K, as csrc/paged_attention.cu
//             combines its chunks). The score tile never reaches device memory.
//   backward: over vocab slabs of the head (the loop is ops/fused_xent.py's
//             _bwd_slabs), three products per slab, each output tile owned by one
//             block: d for the slab (the scores recomputed once, 2 T D V flops in
//             all), dw[:, slab] = x^T . d, written once, and dx32 += d . w[:, slab]^T
//             into an fp32 [T, D] buffer in slab order, the last slab writing dx
//             itself. 6 T D V flops against the Pallas pair's 8 T D V (which recompute
//             the scores in each); no atomics, so the sums' order is fixed; a bf16
//             [T, slab] buffer for d (128 MB at T = 4096) in place of whole logits.
//
// Two paths:
//   bf16 (the training path): fxent_ws_kernel, wgmma m64n256k16 (bf16 in, fp32
//     accumulate) fed by TMA through a 4-stage mbarrier ring.
//   fp32: shared-memory tiles and plain fp32 products (no TF32, whose ten mantissa
//     bits would not hold the fp32 tolerance), 64-column forward partials; the
//     backward adds into dx and dw with atomics.
//
// Bound on this card (H100 SXM): at the training shape (T = D = 4096, V = 128256) the
// kernels are bound by their matrix products over 989 TFLOP/s bf16 dense (2 T D V =
// 4.30 TFLOP, 4.35 ms, for the forward; 6 T D V for the backward); reading w (1.05 GB)
// takes 0.31 ms. What the design does about it: every product runs on wgmma with its
// operands streamed by TMA, and the head is read in place (no padded copy). The
// forward's launch is persistent (a block an SM walking over its tiles), so the
// producer loads a tile's first stages while the consumers run the previous tile's
// epilogue (an exp per score, quad shuffles, three stores a row), during which the
// tensor cores idle; its 256-column partials (24.6 MB at the training shape) are a
// quarter of 64-column ones. The backward's slabs add traffic the bound does not
// count: d written once and read twice (2 GB at the training shape) and the fp32 dx
// buffer read and written once per slab (1 GB), about 0.9 ms at 3.35 TB/s. The partial
// forward of a tensor-parallel rank has the forward's bound with V the shard's width
// (2 T D Vl flops: 2.18 ms at Vl = 64128) and the same design; its combine pass writes
// (m, l, tgt) in place of (nll, lse).

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' _NEG_INF

enum DType { kF32 = 0, kBF16 = 1 };

// Everything a kernel needs. Strides (ldx, ldw) are in elements; the last dim of x and
// w is contiguous.
struct Args {
  const void* x;         // [T, D] row pitch ldx
  const void* w;         // [D, V] row pitch ldw
  const int* tgt;        // [T]
  const float* lse;      // [T] backward
  const float* g;        // [T] backward: the cotangent of nll
  float* part;           // forward: partial (m, l, tgt), each [T, nv]
  float* dx32;           // fp32 backward: dx [T, D]
  float* dw32;           // fp32 backward: dw [D, V]
  int T, D, V, nv;
  int64_t ldx, ldw;
  float cap;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// cap * tanh(s / cap) and its derivative 1 - (capped / cap)^2 (s and 1 without a cap).
__device__ __forceinline__ float capped(float s, float cap, float* chain) {
  if (cap > 0.0f) {
    const float c = cap * tanhf(s / cap);
    const float r = c / cap;
    *chain = 1.0f - r * r;
    return c;
  }
  *chain = 1.0f;
  return s;
}

// d for one score: (p - onehot) * g, times the chain under the cap; 0 off the table.
__device__ __forceinline__ float dlogit(float s, bool valid, bool is_tgt, float lse, float g,
                                        float cap, bool fast_exp) {
  if (!valid) return 0.0f;
  float chain;
  const float c = capped(s, cap, &chain);
  const float p = fast_exp ? __expf(c - lse) : expf(c - lse);
  float d = (p - (is_tgt ? 1.0f : 0.0f)) * g;
  if (cap > 0.0f) d = d * chain;
  return d;
}

// Merge the partials of every vocab tile of a row: one warp per row.
__global__ void fxent_combine_kernel(const float* __restrict__ part, float* __restrict__ nll,
                                     float* __restrict__ lse, int T, int nv) {
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= T) return;
  const int64_t plane = static_cast<int64_t>(T) * nv;
  const float* m = part + static_cast<int64_t>(t) * nv;
  const float* l = m + plane;
  const float* tg = l + plane;
  float mx = kNegInf;
  for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, m[j]);
  mx = warp_max(mx);
  float sum = 0.0f, tv = 0.0f;
  for (int j = lane; j < nv; j += 32) {
    sum += l[j] * expf(m[j] - mx);
    tv += tg[j];  // one tile holds the target's score, the others 0
  }
  sum = warp_sum(sum);
  tv = warp_sum(tv);
  if (lane == 0) {
    const float ls = mx + logf(sum);
    lse[t] = ls;
    nll[t] = ls - tv;
  }
}

// The same merge for the partial forward: the row's (m, l, tgt), l at the final max.
__global__ void fxent_combine_partial_kernel(const float* __restrict__ part,
                                             float* __restrict__ m_out,
                                             float* __restrict__ l_out,
                                             float* __restrict__ tgt_out, int T, int nv) {
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= T) return;
  const int64_t plane = static_cast<int64_t>(T) * nv;
  const float* m = part + static_cast<int64_t>(t) * nv;
  const float* l = m + plane;
  const float* tg = l + plane;
  float mx = kNegInf;
  for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, m[j]);
  mx = warp_max(mx);
  float sum = 0.0f, tv = 0.0f;
  for (int j = lane; j < nv; j += 32) {
    sum += l[j] * expf(m[j] - mx);
    tv += tg[j];
  }
  sum = warp_sum(sum);
  tv = warp_sum(tv);
  if (lane == 0) {
    m_out[t] = mx;
    l_out[t] = sum;
    tgt_out[t] = tv;
  }
}

// ------------------------------------------------------------------ fp32 (shared memory)
constexpr int kF32T = 32, kF32V = 64, kF32K = 32;  // kF32V: a forward partial's columns

struct F32Smem {
  float x[kF32T][kF32K + 1];
  float w[kF32K][kF32V + 1];
  float s[kF32T][kF32V + 1];
};

// Stage x[t0.., k0..] and w[k0.., v0..] (zeros outside the tensors).
__device__ __forceinline__ void f32_stage(F32Smem& sm, const Args& a, int t0, int v0, int k0) {
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  for (int i = threadIdx.x; i < kF32T * kF32K; i += kThreads) {
    const int r = i / kF32K, k = i % kF32K, t = t0 + r, d = k0 + k;
    sm.x[r][k] = (t < a.T && d < a.D) ? x[t * a.ldx + d] : 0.0f;
  }
  for (int i = threadIdx.x; i < kF32K * kF32V; i += kThreads) {
    const int k = i / kF32V, c = i % kF32V, d = k0 + k, v = v0 + c;
    sm.w[k][c] = (d < a.D && v < a.V) ? w[d * a.ldw + v] : 0.0f;
  }
}

// sm.s = the raw score tile x[t0.., :] . w[:, v0..]. Thread i owns column i % 64 of
// rows i / 64 + 4 j.
__device__ void f32_scores(F32Smem& sm, const Args& a, int t0, int v0) {
  const int c = threadIdx.x % kF32V, rb = threadIdx.x / kF32V;
  float acc[kF32T / 4] = {};
  for (int k0 = 0; k0 < a.D; k0 += kF32K) {
    f32_stage(sm, a, t0, v0, k0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kF32K; ++k) {
      const float wv = sm.w[k][c];
#pragma unroll
      for (int j = 0; j < kF32T / 4; ++j) acc[j] += sm.x[rb + 4 * j][k] * wv;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kF32T / 4; ++j) sm.s[rb + 4 * j][c] = acc[j];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fxent_fwd_f32_kernel(const Args a) {
  __shared__ F32Smem sm;
  const int t0 = blockIdx.x * kF32T, vt = blockIdx.y, v0 = vt * kF32V;
  f32_scores(sm, a, t0, v0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t plane = static_cast<int64_t>(a.T) * a.nv;
  for (int r = warp; r < kF32T; r += kThreads / 32) {
    const int t = t0 + r;
    if (t >= a.T) break;
    const int tg = a.tgt[t];
    float val[2];
    bool ok[2];
    float mx = kNegInf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + lane + 32 * h;
      float chain;
      ok[h] = v < a.V;
      val[h] = ok[h] ? capped(sm.s[r][lane + 32 * h], a.cap, &chain) : kNegInf;
      mx = fmaxf(mx, val[h]);
    }
    mx = warp_max(mx);
    float l = 0.0f, tv = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      l += expf(val[h] - mx);
      if (v0 + lane + 32 * h == tg) tv += val[h];
    }
    l = warp_sum(l);
    tv = warp_sum(tv);
    if (lane == 0) {
      const int64_t o = static_cast<int64_t>(t) * a.nv + vt;
      a.part[o] = mx;
      a.part[plane + o] = l;
      a.part[2 * plane + o] = tv;
    }
  }
}

__global__ void __launch_bounds__(kThreads) fxent_bwd_f32_kernel(const Args a) {
  __shared__ F32Smem sm;
  const int t0 = blockIdx.x * kF32T, v0 = blockIdx.y * kF32V;
  f32_scores(sm, a, t0, v0);
  for (int i = threadIdx.x; i < kF32T * kF32V; i += kThreads) {
    const int r = i / kF32V, c = i % kF32V, t = t0 + r, v = v0 + c;
    const bool live = t < a.T;
    sm.s[r][c] = dlogit(sm.s[r][c], live && v < a.V, live && v == a.tgt[t],
                        live ? a.lse[t] : 0.0f, live ? a.g[t] : 0.0f, a.cap, false);
  }
  __syncthreads();
  for (int c0 = 0; c0 < a.D; c0 += kF32K) {
    // x[t0.., c0..] and w[c0.., v0..]: the same staging as the scores'.
    f32_stage(sm, a, t0, v0, c0);
    __syncthreads();
    for (int i = threadIdx.x; i < kF32T * kF32K; i += kThreads) {  // dx = d . w^T
      const int r = i / kF32K, k = i % kF32K, t = t0 + r, d = c0 + k;
      float acc = 0.0f;
      for (int c = 0; c < kF32V; ++c) acc += sm.s[r][c] * sm.w[k][c];
      if (t < a.T && d < a.D) atomicAdd(a.dx32 + static_cast<int64_t>(t) * a.D + d, acc);
    }
    for (int i = threadIdx.x; i < kF32K * kF32V; i += kThreads) {  // dw = x^T . d
      const int k = i / kF32V, c = i % kF32V, d = c0 + k, v = v0 + c;
      float acc = 0.0f;
      for (int r = 0; r < kF32T; ++r) acc += sm.x[r][k] * sm.s[r][c];
      if (d < a.D && v < a.V) atomicAdd(a.dw32 + static_cast<int64_t>(d) * a.V + v, acc);
    }
    __syncthreads();
  }
}

// ------------------------------------------------ bf16 products (wgmma + TMA)
// One kernel, fxent_ws_kernel, runs every bf16 product of the fused CE; its epilogue
// EPI says which:
//   stats: the forward's score tile x[t, :] . w[:, c] (M = T, N = V, K = D: x K-major,
//          w MN-major), and for each row of it the partial (m, l, tgt) of its 256
//          columns into part (three fp32 [T, cdiv(V, 256)] planes) for the combine;
// and, over vocab slabs of the head (the slab loop is in ops/fused_xent.py), the
// backward's three products, each one of the Pallas pair's:
//   d  : d[t, c] = dlogit(x[t, :] . w[:, v0 + c]) for the slab's columns, in bf16 into
//        a [T, slab] buffer (M = T, N = slab, K = D: x K-major, w MN-major);
//   dw : dw[:, v0 + c] = x^T . d, written once in bf16 (M = D, N = slab, K = T: x
//        MN-major, d MN-major);
//   dx : dx32 (+)= d . w[:, slab]^T into an fp32 [T, D] buffer, slab after slab; the
//        last slab's kernel writes dx in bf16 instead (M = T, N = D, K = slab: d
//        K-major, w K-major).
// Every output tile has one owner block, which sums over all of K in registers: no
// atomics, and a sum order that is the same from run to run. A block of three
// warpgroups owns a 128 x 256 output tile. Warpgroup 2's first thread streams A
// (128 x 64) and B (64 x 256) tiles by TMA (2-D maps, 128-byte
// swizzle, zero fill past the tensor's end, so ragged T, D, V and slab edges need no
// masking in the loads) into a 4-stage ring with full/empty mbarriers; warpgroups 0 and
// 1 each issue wgmma m64n256k16 on their 64 rows (an fp32 accumulator of 128 registers
// a thread), keep one k step's wgmma batch in flight while freeing the stage before it,
// and run the epilogue from registers. Blocks take their tiles in groups of 8 row
// tiles (all column tiles of a group before the next), so the tiles in flight share
// their operands in L2.

constexpr int kGM = 128, kGN = 256, kGK = 64;  // output tile rows, cols; depth per stage
constexpr int kGStages = 4;
constexpr int kGThreads = 3 * kWgThreads;
constexpr int kGProducerRegs = 24, kGConsumerRegs = 240;
constexpr int kGATile = kGM * kGK * 2, kGBTile = kGK * kGN * 2;
constexpr int kGStage = kGATile + kGBTile;
constexpr int kGSmemUsed = kGStages * kGStage + 2 * kGStages * 8;
constexpr int kGSmem = kGSmemUsed + 1024;  // slack for the 1024-byte alignment
constexpr int kGGroupM = 8;

enum Epi { kEpiD = 0, kEpiDw = 1, kEpiDx = 2, kEpiStats = 3 };

struct Gemm {
  int M, N, K;            // output rows, output cols, depth
  int tiles_m, tiles_n;
  void* out;              // d: the slab (bf16); dw: dw + v0 (bf16); dx: dx (bf16)
  int64_t ld_out;
  float* acc32;           // dx: the fp32 [T, D] buffer
  const int* tgt;         // d, stats: targets; d: lse, g, the slab's first column
  float* part;            // stats: the partials (m, l, tgt), each [M, tiles_n]
  const float* lse;
  const float* g;
  int v0;
  float cap;              // d, stats: the softcap (used when CAP)
  int first, last;        // dx: the first and the last slab
};

// An operand tile as TMA writes it: K-major (rows of 64 depth values, 128 bytes each,
// 8-row groups 1024 bytes apart; a k step of 16 adds 32 bytes) or MN-major (64-column
// blocks of kGK rows, 8 KB apart; a k step of 16 rows adds 2048 bytes).
template <bool MN> __device__ __forceinline__ uint64_t op_desc(const unsigned char* tile) {
  return MN ? make_desc(tile, kGK * 128, 1024, 1) : make_desc(tile, 16, 1024, 1);
}
template <bool MN> __device__ __forceinline__ constexpr uint64_t op_step(int kk) {
  return MN ? (kk * 16 * 128) >> 4 : (kk * 32) >> 4;
}

// d (+)= A · B for one warpgroup, m64n256k16, bf16 in, fp32 accumulate, both operands
// from shared memory; TA / TB: A / B MN-major (transposed). The first k step of a tile
// passes accumulate = 0.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[32][4], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// Store two neighbouring values of a row: one 2-element store where the row pitch keeps
// it aligned (vec), else one store per column inside the matrix.
__device__ __forceinline__ void store2(bf16* p, int col, int cols, float a, float b,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (col + 1 < cols) p[1] = __float2bfloat16(b);
  }
}

// The block's tile number `tile` → its first output row and column: groups of kGGroupM
// row tiles, every column tile of a group in turn.
__device__ __forceinline__ void tile_origin(const Gemm& gm, int tile, int* m0, int* n0) {
  const int per_group = kGGroupM * gm.tiles_n;
  const int grp = tile / per_group, rem = tile % per_group;
  const int gsz = min(kGGroupM, gm.tiles_m - grp * kGGroupM);
  *m0 = (grp * kGGroupM + rem % gsz) * kGM;
  *n0 = (rem / gsz) * kGN;
}

// The statistics epilogue of one tile (the forward): each row's partial (m, l, tgt) of
// its 256 columns. Accumulator element (j, c) sits in row r0 + 8 (c / 2) and column
// c0 + 8 j + (c % 2); tgr holds the two rows' targets.
template <bool CAP>
__device__ __forceinline__ void stats_epilogue(const Gemm& gm, float (&acc)[kGN / 8][4], int r0,
                                               int c0, int n0, const int (&tgr)[2]) {
  // A row's 256 scores lie in one quad of lanes, 64 each: cap them, mask the columns
  // at or past N (TMA's zero fill scored them 0), and take the row's max, its sum of
  // exp at that max and its target's score, each reduced over the quad; the quad's
  // first lane writes the partial. Every lane runs the shuffles, in rows past M too
  // (those write nothing). Selects, not branches, inside the unrolled loops.
  const int64_t plane = static_cast<int64_t>(gm.M) * gm.tiles_n;
  const int lim = gm.N - c0;  // element (j, e) lies inside the matrix iff 8 j + e < lim
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i, tg = tgr[i];
    const int toff = tg >= 0 && tg < gm.N ? tg - c0 : -1;  // ids outside [0, N): none
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kGN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[j][2 * i + e];
        if (CAP) s = gm.cap * tanhf(s / gm.cap);
        s = 8 * j + e < lim ? s : kNegInf;
        acc[j][2 * i + e] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = quad_max(mx);
    float l = 0.0f, tv = 0.0f;
#pragma unroll
    for (int j = 0; j < kGN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l += __expf(acc[j][2 * i + e] - mx);
        tv = 8 * j + e == toff ? acc[j][2 * i + e] : tv;
      }
    }
    l = quad_sum(l);
    tv = quad_sum(tv);  // one lane of the quad holds the target's score, the others 0
    if (row < gm.M && threadIdx.x % 4 == 0) {
      const int64_t o = static_cast<int64_t>(row) * gm.tiles_n + n0 / kGN;
      gm.part[o] = mx;
      gm.part[plane + o] = l;
      gm.part[2 * plane + o] = tv;
    }
  }
}

// The backward's epilogues (d, dw, dx) of one tile, accumulator layout as above.
template <int EPI, bool CAP>
__device__ __forceinline__ void tile_epilogue(const Gemm& gm, float (&acc)[kGN / 8][4], int r0,
                                              int c0) {
  const bool vec = gm.ld_out % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= gm.M) continue;
    if (EPI == kEpiD) {
      // d = (exp(capped - lse) - onehot) * g, times the chain under the cap; 0 past the
      // slab's last column (those columns are never read back).
      const int tg = gm.tgt[row] - gm.v0;
      const float ls = gm.lse[row], gg = gm.g[row];
      bf16* drow = static_cast<bf16*>(gm.out) + row * gm.ld_out;
#pragma unroll
      for (int j = 0; j < kGN / 8; ++j) {
        const int col = c0 + 8 * j;
        float dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dv[e] = dlogit(acc[j][2 * i + e], col + e < gm.N, col + e == tg, ls, gg,
                         CAP ? gm.cap : 0.0f, true);
        if (col < gm.N) store2(drow + col, col, gm.N, dv[0], dv[1], vec);
      }
    } else if (EPI == kEpiDw) {
      bf16* orow = static_cast<bf16*>(gm.out) + row * gm.ld_out;
#pragma unroll
      for (int j = 0; j < kGN / 8; ++j) {
        const int col = c0 + 8 * j;
        if (col < gm.N) store2(orow + col, col, gm.N, acc[j][2 * i], acc[j][2 * i + 1], vec);
      }
    } else {
      // dx: the fp32 sum of the slabs so far plus this one's; written in bf16 at the last
      // slab, else back into the fp32 buffer (pitch ld_out, as dx).
      float* arow = gm.acc32 + row * gm.ld_out;
      bf16* orow = static_cast<bf16*>(gm.out) + row * gm.ld_out;
#pragma unroll
      for (int j = 0; j < kGN / 8; ++j) {
        const int col = c0 + 8 * j;
        if (col >= gm.N) continue;
        float a = acc[j][2 * i], b = acc[j][2 * i + 1];
        if (!gm.first) {
          if (vec) {
            const float2 prev = *reinterpret_cast<const float2*>(arow + col);
            a += prev.x;
            b += prev.y;
          } else {
            a += arow[col];
            if (col + 1 < gm.N) b += arow[col + 1];
          }
        }
        if (gm.last) {
          store2(orow + col, col, gm.N, a, b, vec);
        } else if (vec) {
          *reinterpret_cast<float2*>(arow + col) = make_float2(a, b);
        } else {
          arow[col] = a;
          if (col + 1 < gm.N) arow[col + 1] = b;
        }
      }
    }
  }
}

// Output tiles of A (M x K) · B (K x N), 128 x 256 each; A_MN / B_MN: the operand is
// stored MN-major (A as [K][M], B as [K][N]) rather than K-major (A as [M][K], B as
// [N][K]). The epilogue EPI writes each tile or its rows' statistics (CAP: the scores
// are capped). A block takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... (one per
// block when the grid has a block per tile, as the backward's launches do): the ring's
// stages and phases run on across its tiles, so the producer loads the next tile's
// first stages while the consumers run the epilogue.
template <int EPI, bool A_MN, bool B_MN, bool CAP>
__global__ void __launch_bounds__(kGThreads, 1)
    fxent_ws_kernel(const __grid_constant__ Gemm gm, const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGStages * kGStage);
  uint64_t* empty = full + kGStages;
  const int tiles = gm.tiles_m * gm.tiles_n;
  const int nk = (gm.K + kGK - 1) / kGK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 2) {
    // ------------------------------------------------------------------- producer
    setmaxnreg_dec<kGProducerRegs>();
    if (threadIdx.x != 2 * kWgThreads) return;  // one thread issues the copies
    int it = 0;  // k steps issued by this block, over all its tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(gm, tile, &m0, &n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kGStages, k0 = kt * kGK;
        unsigned char* sA = smem + s * kGStage;
        unsigned char* sB = sA + kGATile;
        mbar_wait(&empty[s], ((it / kGStages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], kGStage);
        if (A_MN) {
#pragma unroll
          for (int cb = 0; cb < kGM / 64; ++cb)
            tma_load2d(sA + cb * kGK * 128, &tm_a, &full[s], m0 + 64 * cb, k0);
        } else {
          tma_load2d(sA, &tm_a, &full[s], k0, m0);
        }
        if (B_MN) {
#pragma unroll
          for (int cb = 0; cb < kGN / 64; ++cb)
            tma_load2d(sB + cb * kGK * 128, &tm_b, &full[s], n0 + 64 * cb, k0);
        } else {
          tma_load2d(sB, &tm_b, &full[s], k0, n0);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------------------- consumers
  setmaxnreg_inc<kGConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads;  // output rows m0 + 64 cw .. + 63
  // The warpgroup's 64 rows of A: K-major, 64 rows of 128 bytes further; MN-major, the
  // next 64-column block.
  const int a_off = A_MN ? cw * kGK * 128 : cw * 64 * 128;
  int it = 0;  // k steps consumed by this block, over all its tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(gm, tile, &m0, &n0);
    const int r0 = m0 + 64 * cw + 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4;
    const int c0 = n0 + 2 * (threadIdx.x % 4);
    int tgr[2] = {-1, -1};  // stats: the rows' targets, loaded while the products run
    if (EPI == kEpiStats) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r0 + 8 * i < gm.M) tgr[i] = gm.tgt[r0 + 8 * i];
    }
    float acc[kGN / 8][4];
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kGStages;
      const unsigned char* sA = smem + s * kGStage;
      const unsigned char* sB = sA + kGATile;
      mbar_wait(&full[s], (it / kGStages) & 1);
      const uint64_t dA = op_desc<A_MN>(sA + a_off), dB = op_desc<B_MN>(sB);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGK / 16; ++kk)
        wgmma_256<A_MN, B_MN>(acc, dA + op_step<A_MN>(kk), dB + op_step<B_MN>(kk),
                              kt > 0 || kk > 0);
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();  // the batch of k step kt - 1 is done: its stage is free
      if (kt > 0) mbar_arrive(&empty[(it - 1) % kGStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) mbar_arrive(&empty[(it - 1) % kGStages]);  // the tile's last stage

    // -------------------------------------------------------------------- epilogue
    if (EPI == kEpiStats) {
      stats_epilogue<CAP>(gm, acc, r0, c0, n0, tgr);
    } else {
      tile_epilogue<EPI, CAP>(gm, acc, r0, c0);
    }
  }
}

// --------------------------------------------------------------------------- dispatch
int cdiv(int a, int b) { return (a + b - 1) / b; }

// Vocab columns per forward partial: the bf16 kernel's tile, the fp32 kernel's block.
int num_vtiles(int V, int dtype) { return cdiv(V, dtype == kBF16 ? kGN : kF32V); }

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Args& a, cudaStream_t stream) {
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  if (smem > 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

// A 2-D TMA map over the bf16 matrix [rows, cols] at `base` (row pitch `ld` elements),
// read in boxes of 64 columns by `box_rows` rows in the 128-byte swizzle; elements
// outside the matrix read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int64_t ld,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols > 0 ? cols : 1),
                              static_cast<cuuint64_t>(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * 2)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One product over 128 x 256 output tiles: the backward's with a block a tile; the
// forward's statistics with at most a block an SM, each walking over its share of the
// tiles, so that a tile's epilogue overlaps the next tile's first loads.
template <int EPI, bool A_MN, bool B_MN, bool CAP>
cudaError_t launch_ws(Gemm gm, const CUtensorMap& ta, const CUtensorMap& tb,
                      cudaStream_t stream) {
  gm.tiles_m = cdiv(gm.M, kGM);
  gm.tiles_n = cdiv(gm.N, kGN);
  int blocks = gm.tiles_m * gm.tiles_n;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err;
  if (EPI == kEpiStats) {
    int dev, sms;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    blocks = min(blocks, sms);
  }
  auto kernel = fxent_ws_kernel<EPI, A_MN, B_MN, CAP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kGThreads, kGSmem, stream>>>(gm, ta, tb);
  return cudaGetLastError();
}

// The forward's score tiles of either type, writing the partials of a.part (a.nv of
// them a row). bf16: the statistics epilogue of fxent_ws_kernel, x K-major and w
// MN-major, as the backward's d kernel reads them (D >= 1).
cudaError_t launch_fwd_tiles(const Args& a, int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return launch(fxent_fwd_f32_kernel, dim3(cdiv(a.T, kF32T), a.nv), 0, a, st);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  if (a.T == 0 || a.V == 0) return cudaSuccess;
  Gemm gm{};
  gm.M = a.T;
  gm.N = a.V;
  gm.K = a.D;
  gm.tgt = a.tgt;
  gm.part = a.part;
  gm.cap = a.cap;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a.x, a.T, a.D, a.ldx, kGM) || !tensor_map(&tb, a.w, a.D, a.V, a.ldw, kGK))
    return cudaErrorInvalidValue;
  return a.cap > 0.0f ? launch_ws<kEpiStats, false, true, true>(gm, ta, tb, st)
                      : launch_ws<kEpiStats, false, true, false>(gm, ta, tb, st);
}

Args make_args(const void* x, const void* w, const int* tgt, int T, int D, int V, int64_t ldx,
               int64_t ldw, float softcap, int dtype) {
  Args a{};
  a.x = x;
  a.w = w;
  a.tgt = tgt;
  a.T = T;
  a.D = D;
  a.V = V;
  a.nv = num_vtiles(V, dtype);
  a.ldx = ldx;
  a.ldw = ldw;
  a.cap = softcap;
  return a;
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` and returns cudaGetLastError() (0 on success);
// a type other than fp32/bf16 (dtype 0/1) returns cudaErrorInvalidValue. x [T,D] and
// w [D,V] have a contiguous last dim and row pitches ldx / ldw (elements); for bf16 the
// bases and pitches are 16-byte aligned and columns past D (x) or V (w) up to the next
// multiple of 8 are zeros. targets, lse and g are int32 / fp32 / fp32 [T].

// Partials per row of the forward of type dtype: its partial buffer holds 3 * T * this
// floats.
int fxent_num_vtiles(int V, int dtype) { return num_vtiles(V, dtype); }

// nll and lse (fp32 [T]) from x, w and targets; part is scratch of 3 * T * nv floats.
int fxent_fwd_launch(const void* x, const void* w, const int* targets, float* part,
                     float* nll, float* lse, int T, int D, int V, int64_t ldx, int64_t ldw,
                     float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = make_args(x, w, targets, T, D, V, ldx, ldw, softcap, dtype);
  a.part = part;
  cudaError_t err = launch_fwd_tiles(a, dtype, st);
  if (err != cudaSuccess || T == 0 || V == 0) return err;
  fxent_combine_kernel<<<cdiv(T, kThreads / 32), kThreads, 0, st>>>(part, nll, lse, T, a.nv);
  return cudaGetLastError();
}

// The partial forward of a vocab shard: m, l and tgt (fp32 [T]) from x, the shard
// w [D, V] and shard-local targets (ids outside [0, V) match nothing); part is scratch
// of 3 * T * nv floats.
int fxent_fwd_partial_launch(const void* x, const void* w, const int* targets, float* part,
                             float* m, float* l, float* tgt, int T, int D, int V,
                             int64_t ldx, int64_t ldw, float softcap, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = make_args(x, w, targets, T, D, V, ldx, ldw, softcap, dtype);
  a.part = part;
  cudaError_t err = launch_fwd_tiles(a, dtype, st);
  if (err != cudaSuccess || T == 0 || V == 0) return err;
  fxent_combine_partial_kernel<<<cdiv(T, kThreads / 32), kThreads, 0, st>>>(part, m, l, tgt,
                                                                            T, a.nv);
  return cudaGetLastError();
}

// fp32 dx [T,D] and dw [D,V] (contiguous) from x, w, targets, lse and g: zeroed here,
// then summed into by the fp32 kernel's atomics.
int fxent_bwd_f32_launch(const void* x, const void* w, const int* targets, const float* lse,
                         const float* g, float* dx, float* dw, int T, int D, int V,
                         int64_t ldx, int64_t ldw, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = make_args(x, w, targets, T, D, V, ldx, ldw, softcap, kF32);
  a.lse = lse;
  a.g = g;
  a.dx32 = dx;
  a.dw32 = dw;
  cudaError_t err = cudaMemsetAsync(dx, 0, static_cast<int64_t>(T) * D * sizeof(float), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(dw, 0, static_cast<int64_t>(D) * V * sizeof(float), st);
  if (err != cudaSuccess) return err;
  return launch(fxent_bwd_f32_kernel, dim3(cdiv(T, kF32T), cdiv(V, kF32V)), 0, a, st);
}

// The bf16 backward, one vocab slab (columns v0 .. v0 + vn of w) per call of each of the
// three below; d is the slab buffer [T, >= vn] (bf16, row pitch ldd, a multiple of 8).
// T and D are at least 1.

// d[t, c] = dlogit(x[t] . w[:, v0 + c]) for c < vn (targets are global ids).
int fxent_bwd_d_launch(const void* x, const void* w, const int* targets, const float* lse,
                       const float* g, void* d, int T, int D, int64_t ldx, int64_t ldw, int v0,
                       int vn, int64_t ldd, float softcap, void* stream) {
  Gemm gm{};
  gm.M = T;
  gm.N = vn;
  gm.K = D;
  gm.out = d;
  gm.ld_out = ldd;
  gm.tgt = targets;
  gm.lse = lse;
  gm.g = g;
  gm.v0 = v0;
  gm.cap = softcap;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, x, T, D, ldx, kGM) ||
      !tensor_map(&tb, static_cast<const bf16*>(w) + v0, D, vn, ldw, kGK))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return softcap > 0.0f ? launch_ws<kEpiD, false, true, true>(gm, ta, tb, st)
                        : launch_ws<kEpiD, false, true, false>(gm, ta, tb, st);
}

// dw[:, v0 .. v0 + vn] = x^T . d, in bf16 (dw [D, V] contiguous).
int fxent_bwd_dw_launch(const void* x, const void* d, void* dw, int T, int D, int V,
                        int64_t ldx, int v0, int vn, int64_t ldd, void* stream) {
  Gemm gm{};
  gm.M = D;
  gm.N = vn;
  gm.K = T;
  gm.out = static_cast<bf16*>(dw) + v0;
  gm.ld_out = V;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, x, T, D, ldx, kGK) || !tensor_map(&tb, d, T, vn, ldd, kGK))
    return cudaErrorInvalidValue;
  return launch_ws<kEpiDw, true, true, false>(gm, ta, tb, static_cast<cudaStream_t>(stream));
}

// dx32 (+)= d . w[:, v0 .. v0 + vn]^T (fp32 [T, D]; `first`: written, not added to);
// `last`: dx [T, D] (bf16) is written instead. dx32 may be null when first and last.
int fxent_bwd_dx_launch(const void* d, const void* w, float* dx32, void* dx, int T, int D,
                        int64_t ldw, int v0, int vn, int64_t ldd, int first, int last,
                        void* stream) {
  Gemm gm{};
  gm.M = T;
  gm.N = D;
  gm.K = vn;
  gm.out = dx;
  gm.ld_out = D;
  gm.acc32 = dx32;
  gm.first = first;
  gm.last = last;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, d, T, vn, ldd, kGM) ||
      !tensor_map(&tb, static_cast<const bf16*>(w) + v0, D, vn, ldw, kGN))
    return cudaErrorInvalidValue;
  return launch_ws<kEpiDx, false, false, false>(gm, ta, tb, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block of the kernels of type dtype (the wrapper checks
// it against the card's 227 KB); 0 for a type without dynamic memory.
int fxent_smem_bytes(int dtype) { return dtype == kBF16 ? kGSmem : 0; }

}  // extern "C"

// Fused linear + cross-entropy for Hopper (sm_90a), CUDA C++ with plain C entry points.
//
// Replaces three TPU kernels of accelerate_tpu/ops/fused_xent.py:
//   fxent_fwd_*_kernel + fxent_combine_kernel <- _fwd_kernel     (:82, pallas_call in
//                                                _launch_fwd at :224)
//   fxent_bwd_*_kernel (+ fxent_cast_kernel)  <- _bwd_dx_kernel (:128, pallas_call at
//                                                :258) and _bwd_dw_kernel (:151, :277)
// They compute the same functions. x [T,D] and w [D,V] share a type (bf16 or fp32);
// targets [T] are int32, and -1 (or any id outside [0, V)) matches no column. Scores
// s = x.w are dots over D in the input type with fp32 sums, capped as cap*tanh(s/cap)
// when cap > 0. Columns at or past V count in no max or sum. The forward writes
// lse = m + log(l) and nll = lse - (the target's score), both fp32. The backward
// recomputes the scores and takes d = (exp(capped - lse) - onehot) * g, times
// 1 - (capped/cap)^2 under the cap; d is rounded to w's type before d.w^T and to x's
// type before x^T.d, both products sum in fp32, and dx / dw are written in x's / w's
// type.
//
// Design. A TPU grid runs in order on one core: the Pallas forward carries (m, l, tgt)
// across the vocab axis in VMEM, and the backward carries a [block_t, D] (dx) or
// [D, block_v] (dw) fp32 sum across a sequential axis -- 4 MB at D = 4096, far past
// the 227 KB of shared memory of one block. Here every block owns one (token tile,
// vocab tile) pair and nothing is carried between blocks:
//   forward : the block computes its score tile over all of D and writes, for every
//             row and every 64 of its columns, the partial (max, sum of exp at that
//             max, target score); a combine pass merges the partials of a row (split-K,
//             as csrc/paged_attention.cu combines its chunks).
//   backward: one kernel for dx and dw. The block recomputes its score tile, forms d
//             once, then walks D in chunks: dx[t tile, chunk] += d . w[chunk, v tile]^T
//             and dw[chunk, v tile] += x[t tile, chunk]^T . d, each added into an fp32
//             buffer ([T,D] and [D,V]) with atomics (one float4 atomic per 4 columns
//             on the bf16 path); a cast pass writes dx and dw in the input type. The
//             scores are computed once per block instead of once per product
//             (6 T D V flops against the Pallas pair's 8 T D V); the price is an fp32
//             [D,V] buffer (2.1 GB at V = 128256, D = 4096) and sums whose order
//             changes from run to run.
// The score tile never reaches device memory; d lives in registers and shared memory.
// Blocks take their tiles in groups of 8 token tiles (block_tile), which keeps the dx
// and dw the blocks in flight add into inside L2.
//
// Two paths:
//   bf16 (the training path): a 128 x 256 tile per block, 8 warps each owning 64 x 64
//     of it and issuing mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix
//     operands; the score loop stages D in chunks of 64 through a 3-deep cp.async ring.
//     d is rounded to bf16 into a shared tile, the A operand of d.w^T and the B operand
//     of x^T.d. The wide vocab tile halves the dx atomics of a 128-wide one.
//   fp32: shared-memory tiles and plain fp32 products (no TF32, whose ten mantissa
//     bits would not hold the fp32 tolerance).
//
// Bound on this card (H100 SXM): at the training shape (T = D = 4096, V = 128256) the
// kernels are bound by their matrix products over 989 TFLOP/s bf16 dense (2 T D V for
// the forward, 6 T D V for the backward); reading w (1.05 GB) takes 0.31 ms. What the
// design does about it: every product runs on the tensor cores and the head is read
// in place (no padded copy). It still issues mma.sync rather than wgmma, loads without
// TMA, and the backward's atomics and fp32 buffers cost traffic the Pallas pair does
// not -- later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' _NEG_INF

enum DType { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

// Everything a kernel needs. Strides (ldx, ldw) are in elements; the last dim of x and
// w is contiguous.
struct Args {
  const void* x;         // [T, D] row pitch ldx
  const void* w;         // [D, V] row pitch ldw
  const int* tgt;        // [T]
  const float* lse;      // [T] backward
  const float* g;        // [T] backward: the cotangent of nll
  float* part;           // forward: partial (m, l, tgt), each [T, nv]
  float* dx32;           // backward: fp32 [T, D]
  float* dw32;           // backward: fp32 [D, V]
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

__global__ void fxent_cast_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                                  int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = __float2bfloat16(src[i]);
}

constexpr int kPartV = 64;  // vocab columns per partial (m, l, tgt) of the forward

// ------------------------------------------------------------------ fp32 (shared memory)
constexpr int kF32T = 32, kF32V = 64, kF32K = 32;
static_assert(kF32V == kPartV, "a forward partial is one block's columns");

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

// ---------------------------------------------------------------- bf16 (tensor cores)
constexpr int kBT = 128, kBV = 256;  // token rows, vocab columns of a block's tile
constexpr int kWarpT = 64, kWarpV = 64;  // a warp's part of the score tile (2 x 4 warps)
constexpr int kKC = 64;              // D per stage of the score loop
constexpr int kStages = 3;
constexpr int kDc = 64;              // D per chunk of the backward's products
constexpr int kGroupT = 8;           // token tiles per group of the block order
constexpr int kLdX = kKC + 8;        // pitches (elements) of the staged tiles: 16 bytes
constexpr int kLdW = kBV + 8;        //   of padding spread a column over the banks
constexpr int kLdXc = kDc + 8;
constexpr int kStageBytes = (kBT * kLdX + kKC * kLdW) * 2;
constexpr int kDTileBytes = kBT * kLdW * 2;
constexpr int kChunkBytes = (kDc * kLdW + kBT * kLdXc) * 2;
constexpr int kFwdSmem = kStages * kStageBytes;
constexpr int kBwdSmem = kStages * kStageBytes > kDTileBytes + 2 * kChunkBytes
                             ? kStages * kStageBytes
                             : kDTileBytes + 2 * kChunkBytes;
static_assert(kPartV == kWarpV, "a forward partial is one warp's columns");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  // fill=false zero-fills the 16 bytes without reading global memory.
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16) at rows m0.., cols k0.. of a tile stored [m][k].
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int m0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, tile + (m0 + (l % 8) + ((l / 8) % 2) * 8) * ld + k0 + (l / 16) * 8);
}

// The same A fragment from a tile stored [k][m] (a transposing load).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* tile, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(a, tile + (k0 + (l % 8) + (l / 16) * 8) * ld + m0 + ((l / 8) % 2) * 8);
}

// B fragments of the n-tiles n0 and n0 + 8 at k-step k0, from a tile stored [n][k]:
// b[0], b[1] for n0; b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                          int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, tile + (n0 + (l % 8) + (l / 16) * 8) * ld + k0 + ((l / 8) % 2) * 8);
}

// The same from a tile stored [k][n] (a transposing load).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                          int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(b, tile + (k0 + (l % 8) + ((l / 8) % 2) * 8) * ld + n0 + (l / 16) * 8);
}

// Accumulator element (j, c) of a thread sits at row gid + 8 * (c / 2) of the warp's 16
// and column 8 * j + 2 * tig + (c % 2).
__device__ __forceinline__ int acc_row(int c) { return (threadIdx.x % 32) / 4 + 8 * (c >> 1); }
__device__ __forceinline__ int acc_col(int j, int c) {
  return 8 * j + 2 * (threadIdx.x % 4) + (c & 1);
}

// Add one 16 x 8 accumulator tile of a warp (rows row0.., cols col0..) into an fp32
// matrix of pitch ld (rows_valid x cols_valid). Lanes trade pairs with their quad
// neighbour, so that each holds 4 consecutive columns of one row and adds them with one
// vector atomic (vec: ld is a multiple of 4); scalar atomics at a ragged edge.
__device__ __forceinline__ void add_tile(float* base, int64_t ld, int row0, int col0,
                                         const float (&acc)[4], int rows_valid,
                                         int cols_valid, bool vec) {
  const int lane = threadIdx.x % 32, tig = lane % 4;
  const bool odd = tig & 1;
  // Even lanes keep row gid and send their row gid + 8 pair; odd lanes the reverse.
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[0] : acc[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[1] : acc[3], 1);
  const int row = row0 + lane / 4 + (odd ? 8 : 0);
  const int col = col0 + 2 * (tig & ~1);
  const float4 v = odd ? make_float4(r0, r1, acc[2], acc[3]) : make_float4(acc[0], acc[1], r0, r1);
  if (row >= rows_valid) return;
  float* p = base + row * ld + col;
  if (vec && col + 3 < cols_valid) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < cols_valid) atomicAdd(p + k, e[k]);
  }
}

// Stage rows [r0, r0 + rows) x cols [c0, c0 + cols) of a row-major bf16 tensor (row
// pitch ld elements, rows_valid x cols_valid in size) into a shared tile of pitch
// sld; 16-byte pieces outside the tensor are zero-filled. The row pitch and base are
// 16-byte aligned and columns past cols_valid up to the next multiple of 8 are zeros
// (the wrapper's layout), so a piece is read whole or not at all.
__device__ __forceinline__ void stage_bf16(bf16* dst, int sld, const bf16* src, int64_t ld,
                                           int r0, int rows, int rows_valid, int c0, int cols,
                                           int cols_valid) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool fill = r0 + r < rows_valid && c0 + c < cols_valid;
    cp_async16(dst + r * sld + c, fill ? src + (r0 + r) * ld + c0 + c : src, fill);
  }
}

// The block's (token tile, vocab tile): blocks walk the grid in groups of kGroupT token
// tiles (all vocab tiles of one group before the next), so that the blocks in flight
// at one time share a few MB of x and, in the backward, add into a few MB of dx and dw
// that stay in L2 (walking all 32 token tiles per vocab tile kept the whole 64 MB of
// dx hot, past the 50 MB of L2).
__device__ __forceinline__ void block_tile(int* t0, int* v0) {
  const int nt = gridDim.x, nvt = gridDim.y;
  const int bid = blockIdx.x + nt * blockIdx.y;
  const int grp = bid / (kGroupT * nvt), rem = bid % (kGroupT * nvt);
  const int gsz = min(kGroupT, nt - grp * kGroupT);
  *t0 = (grp * kGroupT + rem % gsz) * kBT;
  *v0 = (rem / gsz) * kBV;
}

// s += x[t0.., :] . w[:, v0..] over all of D: the warp's 64 x 64 part of the 128 x 256
// tile (rows m0 + 16 mi, columns n0 + 8 j), D staged in chunks of kKC through a
// kStages-deep cp.async ring. Ends with every copy landed and the block synchronised,
// so the caller may reuse the shared memory.
__device__ __forceinline__ void mma_scores(float (&s)[kWarpT / 16][kWarpV / 8][4],
                                           unsigned char* smem, const Args& a, int t0, int v0,
                                           int m0, int n0) {
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int nk = (a.D + kKC - 1) / kKC;
  auto sx = [&](int st) { return reinterpret_cast<bf16*>(smem + st * kStageBytes); };
  auto sw = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * kStageBytes + kBT * kLdX * 2);
  };
  auto load = [&](int kt) {
    const int st = kt % kStages, k0 = kt * kKC;
    stage_bf16(sx(st), kLdX, x, a.ldx, t0, kBT, a.T, k0, kKC, a.D);
    stage_bf16(sw(st), kLdW, w, a.ldw, k0, kKC, a.D, v0, kBV, a.V);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // ... for every thread; stage kt - 1 is free again
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const bf16* xs = sx(kt % kStages);
    const bf16* ws = sw(kt % kStages);
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t af[kWarpT / 16][4];
#pragma unroll
      for (int mi = 0; mi < kWarpT / 16; ++mi) load_a(af[mi], xs, kLdX, m0 + 16 * mi, kk * 16);
#pragma unroll
      for (int np = 0; np < kWarpV / 16; ++np) {
        uint32_t b[4];
        load_b_kn(b, ws, kLdW, n0 + 16 * np, kk * 16);
#pragma unroll
        for (int mi = 0; mi < kWarpT / 16; ++mi) {
          mma16816(s[mi][2 * np], af[mi], b[0], b[1]);
          mma16816(s[mi][2 * np + 1], af[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fxent_fwd_mma_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  int t0, v0;
  block_tile(&t0, &v0);
  const int warp = threadIdx.x / 32;
  const int m0 = (warp / 4) * kWarpT, n0 = (warp % 4) * kWarpV;
  float s[kWarpT / 16][kWarpV / 8][4] = {};
  mma_scores(s, smem, a, t0, v0, m0, n0);
  // Each warp writes the partials of its 64 columns: no reduction across warps.
  const int vp = v0 + n0;
  if (vp >= a.V) return;
  const int pv = vp / kPartV;
  const int64_t plane = static_cast<int64_t>(a.T) * a.nv;
#pragma unroll
  for (int mi = 0; mi < kWarpT / 16; ++mi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the thread's two rows (each spread over a quad)
      const int t = t0 + m0 + 16 * mi + acc_row(2 * i);
      const int tg = t < a.T ? a.tgt[t] : -1;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kWarpV / 8; ++j) {
#pragma unroll
        for (int c = 2 * i; c < 2 * i + 2; ++c) {
          float chain;
          const float v = capped(s[mi][j][c], a.cap, &chain);
          s[mi][j][c] = vp + acc_col(j, c) < a.V ? v : kNegInf;
          mx = fmaxf(mx, s[mi][j][c]);
        }
      }
      mx = quad_max(mx);
      float l = 0.0f, tv = 0.0f;
#pragma unroll
      for (int j = 0; j < kWarpV / 8; ++j) {
#pragma unroll
        for (int c = 2 * i; c < 2 * i + 2; ++c) {
          const int col = vp + acc_col(j, c);
          if (col < a.V) {
            l += __expf(s[mi][j][c] - mx);
            if (col == tg) tv += s[mi][j][c];
          }
        }
      }
      l = quad_sum(l);
      tv = quad_sum(tv);
      if (t < a.T && threadIdx.x % 4 == 0) {
        const int64_t o = static_cast<int64_t>(t) * a.nv + pv;
        a.part[o] = mx;
        a.part[plane + o] = l;
        a.part[2 * plane + o] = tv;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) fxent_bwd_mma_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  int t0, v0;
  block_tile(&t0, &v0);
  const int warp = threadIdx.x / 32;
  const int m0 = (warp / 4) * kWarpT, n0 = (warp % 4) * kWarpV;
  bf16* sD = reinterpret_cast<bf16*>(smem);
  {
    float s[kWarpT / 16][kWarpV / 8][4] = {};
    mma_scores(s, smem, a, t0, v0, m0, n0);
    // d, rounded to bf16, into the tile sD [t][v]: the A operand of d . w^T and the B
    // operand of x^T . d.
#pragma unroll
    for (int mi = 0; mi < kWarpT / 16; ++mi) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + 16 * mi + acc_row(2 * i), t = t0 + r;
        const bool live = t < a.T;
        const int tg = live ? a.tgt[t] : -1;
        const float ls = live ? a.lse[t] : 0.0f, gg = live ? a.g[t] : 0.0f;
#pragma unroll
        for (int j = 0; j < kWarpV / 8; ++j) {
          float d[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = v0 + n0 + acc_col(j, c);
            d[c] = dlogit(s[mi][j][2 * i + c], live && col < a.V, col == tg, ls, gg, a.cap,
                          true);
          }
          *reinterpret_cast<uint32_t*>(sD + r * kLdW + n0 + acc_col(j, 0)) =
              pack_bf16(d[0], d[1]);
        }
      }
    }
  }

  // D in chunks of kDc, two buffers of (w[chunk, v tile] as [d][v], x[t tile, chunk]
  // as [t][d]) after sD.
  auto s_w = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + kDTileBytes + buf * kChunkBytes);
  };
  auto s_x = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + kDTileBytes + buf * kChunkBytes + kDc * kLdW * 2);
  };
  auto load_chunk = [&](int ci, int buf) {
    const int c0 = ci * kDc;
    stage_bf16(s_w(buf), kLdW, w, a.ldw, c0, kDc, a.D, v0, kBV, a.V);
    stage_bf16(s_x(buf), kLdXc, x, a.ldx, t0, kBT, a.T, c0, kDc, a.D);
  };
  const int nc = (a.D + kDc - 1) / kDc;
  const int xm = (warp / 2) * 32, xn = (warp % 2) * 32;  // dx warp tile (4 x 2 warps)
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 64;  // dw warp tile (2 x 4 warps)
  load_chunk(0, 0);
  cp_async_commit();
  for (int ci = 0; ci < nc; ++ci) {
    const int buf = ci & 1, c0 = ci * kDc;
    cp_async_wait<0>();  // chunk ci has landed
    __syncthreads();     // ... for every thread (and sD is complete); chunk ci - 1's
                         // buffer is free again
    if (ci + 1 < nc) load_chunk(ci + 1, buf ^ 1);
    cp_async_commit();
    const bf16* wc = s_w(buf);
    const bf16* xc = s_x(buf);
    {  // dx[t0 + xm.., c0 + xn..] += d[xm.., :] . w[c0 + xn.., v0..]^T (K: kBV columns)
      float acc[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBV / 16; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) load_a(af[mi], sD, kLdW, xm + 16 * mi, kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          load_b_nk(b, wc, kLdW, xn + 16 * np, kk * 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816(acc[mi][2 * np], af[mi], b[0], b[1]);
            mma16816(acc[mi][2 * np + 1], af[mi], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          add_tile(a.dx32, a.D, t0 + xm + 16 * mi, c0 + xn + 8 * j, acc[mi][j], a.T, a.D,
                   a.D % 4 == 0);
      }
    }
    {  // dw[c0 + wm.., v0 + wn..] += x[t0.., c0 + wm..]^T . d[:, wn..] (K: kBT rows)
      float acc[2][8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBT / 16; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) load_a_t(af[mi], xc, kLdXc, wm + 16 * mi, kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          load_b_kn(b, sD, kLdW, wn + 16 * np, kk * 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816(acc[mi][2 * np], af[mi], b[0], b[1]);
            mma16816(acc[mi][2 * np + 1], af[mi], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          add_tile(a.dw32, a.V, c0 + wm + 16 * mi, v0 + wn + 8 * j, acc[mi][j], a.D, a.V,
                   a.V % 4 == 0);
      }
    }
  }
}

// --------------------------------------------------------------------------- dispatch
int cdiv(int a, int b) { return (a + b - 1) / b; }

int num_vtiles(int V) { return cdiv(V, kPartV); }

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

cudaError_t cast(const float* src, bf16* dst, int64_t n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fxent_cast_kernel<<<static_cast<int>(blocks < 8192 ? blocks : 8192), kThreads, 0, stream>>>(
      src, dst, n);
  return cudaGetLastError();
}

Args make_args(const void* x, const void* w, const int* tgt, int T, int D, int V, int64_t ldx,
               int64_t ldw, float softcap) {
  Args a{};
  a.x = x;
  a.w = w;
  a.tgt = tgt;
  a.T = T;
  a.D = D;
  a.V = V;
  a.nv = num_vtiles(V);
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

// Partials per row: the forward's partial buffer holds 3 * T * this floats.
int fxent_num_vtiles(int V) { return num_vtiles(V); }

// nll and lse (fp32 [T]) from x, w and targets; part is scratch of 3 * T * nv floats.
int fxent_fwd_launch(const void* x, const void* w, const int* targets, float* part,
                     float* nll, float* lse, int T, int D, int V, int64_t ldx, int64_t ldw,
                     float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = make_args(x, w, targets, T, D, V, ldx, ldw, softcap);
  a.part = part;
  cudaError_t err;
  if (dtype == kBF16)
    err = launch(fxent_fwd_mma_kernel, dim3(cdiv(T, kBT), cdiv(V, kBV)), kFwdSmem, a, st);
  else if (dtype == kF32)
    err = launch(fxent_fwd_f32_kernel, dim3(cdiv(T, kF32T), cdiv(V, kF32V)), 0, a, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || T == 0 || V == 0) return err;
  fxent_combine_kernel<<<cdiv(T, kThreads / 32), kThreads, 0, st>>>(part, nll, lse, T, a.nv);
  return cudaGetLastError();
}

// dx (x's type, [T,D] contiguous) and dw (w's type, [D,V] contiguous) from x, w,
// targets, lse and g. dx32 / dw32 are fp32 scratch of the same shapes, zeroed here;
// for fp32 inputs they are dx / dw themselves.
int fxent_bwd_launch(const void* x, const void* w, const int* targets, const float* lse,
                     const float* g, float* dx32, float* dw32, void* dx, void* dw, int T,
                     int D, int V, int64_t ldx, int64_t ldw, float softcap, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  Args a = make_args(x, w, targets, T, D, V, ldx, ldw, softcap);
  a.lse = lse;
  a.g = g;
  a.dx32 = dx32;
  a.dw32 = dw32;
  const int64_t ndx = static_cast<int64_t>(T) * D, ndw = static_cast<int64_t>(D) * V;
  cudaError_t err = cudaMemsetAsync(dx32, 0, ndx * sizeof(float), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(dw32, 0, ndw * sizeof(float), st);
  if (err != cudaSuccess) return err;
  if (dtype == kBF16)
    err = launch(fxent_bwd_mma_kernel, dim3(cdiv(T, kBT), cdiv(V, kBV)), kBwdSmem, a, st);
  else
    err = launch(fxent_bwd_f32_kernel, dim3(cdiv(T, kF32T), cdiv(V, kF32V)), 0, a, st);
  if (err != cudaSuccess || dtype == kF32) return err;
  err = cast(dx32, static_cast<bf16*>(dx), ndx, st);
  if (err != cudaSuccess) return err;
  return cast(dw32, static_cast<bf16*>(dw), ndw, st);
}

// Dynamic shared memory of one block (the wrapper checks it against the card's
// 227 KB): which = 0 forward, 1 backward; 0 for a type without dynamic memory.
int fxent_smem_bytes(int which, int dtype) {
  if (dtype != kBF16) return 0;
  return which == 0 ? kFwdSmem : kBwdSmem;
}

}  // extern "C"

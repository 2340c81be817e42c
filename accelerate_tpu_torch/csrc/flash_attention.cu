// FlashAttention-2 forward and backward for Hopper (sm_90a), CUDA C++ with plain C
// entry points.
//
// Replaces three TPU kernels of accelerate_tpu/ops/flash_attention.py (bf16 / fp32):
//   flash_fwd_ws_kernel / flash_fwd_kernel  <- _fwd_kernel (:155, pallas_call in _fwd
//                                              at :306)
//   flash_bwd_dq_ws_kernel / flash_bwd_dq_kernel <- _bwd_dq_kernel (:343, pallas_call
//                                              in _bwd_dq at :560)
//   flash_bwd_dkv_ws_kernel / flash_bwd_dkv_kernel <- _bwd_dkv_kernel (:422,
//                                              pallas_call in _bwd_dkv at :625)
// They compute the same functions. q [B,H,S,hd] attends to k/v [B,K,T,hd] with K
// dividing H: q head h reads kv head h / (H/K), and no repeated K/V exists in memory.
// Query row i sits at global position q_off + i, key column j at kv_off + j. Key j is
// visible to row i iff j < T, (causal) col <= row, (window > 0) col > row - window,
// and (with segment ids) q_seg[i] == kv_seg[j] and kv_seg[j] != 0 -- _tile_mask's
// rule. Scores are dot(q, k) in the input type with fp32 accumulation, times sm_scale,
// optionally capped as cap * tanh(s / cap). The forward keeps an online softmax in
// fp32 (masked scores take -1e30 and p = 0), rounds p to the value type before the
// P V product, and writes o = acc / l and lse = m + log(l); a row that sees no key
// writes zeros and lse = -1e30. The backward recomputes p = exp(s - lse) (masked to
// 0), ds = p (dp - delta) sm_scale, times (1 - t^2) under the cap, rounds ds to the
// input type, and accumulates dq = ds k (per q tile) and dk = ds^T q, dv = p^T do
// (per kv tile, over every q head of the kv head's group), all in fp32.
//
// Design. A TPU grid runs in order on one core and carries the softmax state and the
// gradient sums in VMEM scratch from one grid step to the next. Blocks on a GPU run in
// no order, so each block owns one output tile and loops over the other axis itself:
//   forward, dq : one block per (q tile, q head, batch), walking kv tiles;
//   dk/dv       : one block per (kv tile, kv head, batch), walking every (group head,
//                 q tile) pair -- the block owns its dk/dv rows, so no atomics are
//                 needed across blocks.
// kv tiles wholly above the causal diagonal or wholly below the window are skipped, as
// in the Pallas kernels. Two paths:
//   bf16 (the training path): warp-specialised Hopper kernels
//     (*_ws_kernel). A producer warp streams tiles by TMA into a 2-stage ring of shared
//     memory (full/empty mbarriers; 128-byte swizzle, 64 at hd 32; rows past the end
//     read as zeros, strides from the tensor, so the model's [B,S,H,hd] views are read
//     in place). Two consumer warpgroups of 64 rows each issue wgmma.mma_async: the
//     forward takes 128 q rows against 128-key tiles (S = Q·Kᵀ from shared memory,
//     O += P·V with P from registers and V through transpose-B), dq 128 q rows against
//     64-key tiles (S = Q·Kᵀ and dP = dO·Vᵀ, then dQ += dS·K from registers), dk/dv
//     128 kv rows against 64-row q tiles (Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then dV += Pᵀ·dO
//     and dK += dSᵀ·Q from registers). The softmax runs in base 2, log2(e)·scale folded
//     into one multiply; masks are a per-row range of positions, applied by select in
//     one uniform branch per tile that is not wholly visible. Under the causal mask
//     the grid starts with the blocks that walk the most tiles (last q tiles for the
//     forward and dq, first kv tiles for dk/dv), so the longest chains do not end the
//     launch.
//   fp32: shared-memory kernels with plain fp32 products (no TF32, whose ten mantissa
//     bits would not hold the fp32 tolerance), scores and accumulators in shared memory.
//
// Bound on this card (H100 SXM): at training shapes attention is bound by its matrix
// products (forward 4 B H S T hd flops, halved under the causal mask; dq three
// products, dk/dv four, counting the recomputed scores) over 989 TFLOP/s bf16 dense.
// What the bf16 design leaves out: each consumer warpgroup still waits for every
// product before its softmax (no ping-pong between the two, no overlap of one tile's
// softmax with the next tile's Q·Kᵀ), so the tensor cores idle while the exponentials
// run; no persistent grid; no fp8; hd 256.

#include "hopper.cuh"

#include <climits>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' _NEG_INF

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  // fill=false zero-fills the 16 bytes without reading global memory.
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Row pitch (elements) of a shared tile: 16 bytes of padding per row spreads the rows of
// a column over the banks; pitches stay multiples of 16 bytes (cp.async, WMMA ldm).
template <typename T>
__host__ __device__ constexpr int pitch(int cols) { return cols + 16 / static_cast<int>(sizeof(T)); }

// Copy `rows` rows of HD elements (row stride `stride` elements) into a shared tile of
// pitch `ld`; rows at or past `valid_rows` are zero-filled. The caller waits.
template <typename T, int HD, int NT = kThreads>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* src, int64_t stride,
                                                int rows, int valid_rows) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int per_row = HD / V;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row;
    const int c = (i % per_row) * V;
    const bool fill = r < valid_rows;
    cp_async16(dst + r * ld + c, fill ? src + r * stride + c : src, fill);
  }
}

// C[M][N] (+)= opA[M][K] * opB[K][N], all fp32 operands in shared memory, one output per
// thread at a time, the sum in fp32 (no TF32).
// opA[m][k] = TA ? A[k*lda + m] : A[m*lda + k]; opB[k][n] = TB ? B[n*ldb + k] : B[k*ldb + n].
template <typename T, bool TA, bool TB, int M, int N, int K>
__device__ __forceinline__ void block_mm(float* C, int ldc, const T* A, int lda, const T* B,
                                         int ldb, bool accumulate) {
  static_assert(std::is_same<T, float>::value, "the shared-memory kernels are the fp32 path");
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int m = idx / N, n = idx % N;
    float s = accumulate ? C[m * ldc + n] : 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = TA ? A[k * lda + m] : A[m * lda + k];
      const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
      s += a * b;
    }
    C[m * ldc + n] = s;
  }
}

// Everything a kernel needs besides its tiles. Strides are in elements: batch, head, row.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;        // backward only
  const float* lse;        // [B,H,S]; written by the forward
  const float* delta;      // [B,H,S]; backward only
  void* out0;              // forward: o (input type); dq: dq (fp32); dkv: dk (fp32)
  void* out1;              // dkv: dv (fp32)
  float* lse_out;          // forward: lse [B,H,S]
  const int* q_seg;        // [B,S] int32 or null
  const int* kv_seg;       // [B,T] int32 or null
  int B, H, K, S, T;
  int64_t q_s[3], k_s[3], v_s[3], do_s[3], o0_s[3], o1_s[3];
  float sm_scale, softcap;
  int window, causal, q_off, kv_off;
};

// Visibility of key column `col` (local) to query row `row` (local), tile-independent.
__device__ __forceinline__ bool visible(const Params& p, int row, int col, int qseg, int kseg,
                                        bool has_seg) {
  if (col >= p.T) return false;
  const int rg = p.q_off + row, cg = p.kv_off + col;
  if (p.causal && cg > rg) return false;
  if (p.window > 0 && cg <= rg - p.window) return false;
  if (has_seg && (qseg != kseg || kseg == 0)) return false;
  return true;
}

// A kv tile starting at global column k_glob can meet a q tile starting at global row
// q_glob (the Pallas kernels' `needed`).
__device__ __forceinline__ bool tile_needed(const Params& p, int q_glob, int bq, int k_glob,
                                            int bk) {
  if (p.causal && k_glob > q_glob + bq - 1) return false;
  if (p.window > 0 && k_glob + bk - 1 <= q_glob - p.window) return false;
  return true;
}

__device__ __forceinline__ float capped(float s, float cap, float* t) {
  if (cap > 0.0f) {
    const float th = tanhf(s / cap);
    *t = th;
    return cap * th;
  }
  *t = 0.0f;
  return s;
}

// ------------------------------------------------------------------------------ forward
template <typename T, int HD, int BQ, int BK>
struct FwdLayout {
  static constexpr int LDT = pitch<T>(HD), LDS = BK + 4, LDP = pitch<T>(BK), LDO = HD + 4;
  static constexpr int Q = 0;
  static constexpr int Kt = Q + align128(BQ * LDT * sizeof(T));
  static constexpr int Vt = Kt + align128(BK * LDT * sizeof(T));
  static constexpr int Sc = Vt + align128(BK * LDT * sizeof(T));
  static constexpr int Pr = Sc + align128(BQ * LDS * 4);
  static constexpr int O = Pr + align128(BQ * LDP * sizeof(T));
  static constexpr int Mx = O + align128(BQ * LDO * 4);
  static constexpr int Lx = Mx + align128(BQ * 4);
  static constexpr int QSeg = Lx + align128(BQ * 4);
  static constexpr int KSeg = QSeg + align128(BQ * 4);
  static constexpr int bytes = KSeg + align128(BK * 4);
};

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using L = FwdLayout<T, HD, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::Q);
  T* sK = reinterpret_cast<T*>(smem + L::Kt);
  T* sV = reinterpret_cast<T*>(smem + L::Vt);
  float* sS = reinterpret_cast<float*>(smem + L::Sc);
  T* sP = reinterpret_cast<T*>(smem + L::Pr);
  float* sO = reinterpret_cast<float*>(smem + L::O);
  float* sM = reinterpret_cast<float*>(smem + L::Mx);
  float* sL = reinterpret_cast<float*>(smem + L::Lx);
  int* sQseg = reinterpret_cast<int*>(smem + L::QSeg);
  int* sKseg = reinterpret_cast<int*>(smem + L::KSeg);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int q_rows = min(BQ, p.S - q0);
  const bool has_seg = p.q_seg != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1] + q0 * p.q_s[2];
  const T* Kb = static_cast<const T*>(p.k) + b * p.k_s[0] + kh * p.k_s[1];
  const T* Vb = static_cast<const T*>(p.v) + b * p.v_s[0] + kh * p.v_s[1];
  load_rows_async<T, HD>(sQ, L::LDT, Q, p.q_s[2], BQ, q_rows);
  for (int i = threadIdx.x; i < BQ * HD; i += kThreads) sO[(i / HD) * L::LDO + i % HD] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
    sQseg[r] = (has_seg && r < q_rows) ? p.q_seg[b * p.S + q0 + r] : 0;
  }

  const int q_glob = p.q_off + q0;
  const int nk = (p.T + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    if (!tile_needed(p, q_glob, BQ, p.kv_off + k0, BK)) continue;  // uniform in the block
    const int k_rows = min(BK, p.T - k0);
    load_rows_async<T, HD>(sK, L::LDT, Kb + k0 * p.k_s[2], p.k_s[2], BK, k_rows);
    load_rows_async<T, HD>(sV, L::LDT, Vb + k0 * p.v_s[2], p.v_s[2], BK, k_rows);
    for (int r = threadIdx.x; r < BK; r += kThreads)
      sKseg[r] = (has_seg && r < k_rows) ? p.kv_seg[b * p.T + k0 + r] : 0;
    cp_async_wait_all();
    __syncthreads();
    block_mm<T, false, true, BQ, BK, HD>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    __syncthreads();
    // Online softmax, one warp per row: state update, p rounded to the value type,
    // the accumulator row rescaled by alpha.
    for (int r = warp; r < BQ; r += kWarps) {
      float sv[BK / 32];
      bool ok[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int col = lane + 32 * c;
        float t;
        const float s = capped(sS[r * L::LDS + col] * p.sm_scale, p.softcap, &t);
        ok[c] = visible(p, q0 + r, k0 + col, sQseg[r], sKseg[col], has_seg);
        sv[c] = ok[c] ? s : kNegInf;
        mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const float pv = ok[c] ? expf(sv[c] - m_next) : 0.0f;
        sum += pv;
        sP[r * L::LDP + lane + 32 * c] = from_f<T>(pv);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_prev - m_next);
      for (int c = lane; c < HD; c += 32) sO[r * L::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_next;
      }
    }
    __syncthreads();
    block_mm<T, false, false, BQ, HD, BK>(sO, L::LDO, sP, L::LDP, sV, L::LDT, true);
    __syncthreads();
  }
  cp_async_wait_all();  // tiles all skipped: the q copy is still in flight
  __syncthreads();

  T* O = static_cast<T*>(p.out0) + b * p.o0_s[0] + h * p.o0_s[1];
  for (int r = warp; r < q_rows; r += kWarps) {
    const float l = sL[r];
    const float l_safe = l == 0.0f ? 1.0f : l;
    T* orow = O + (q0 + r) * p.o0_s[2];
    for (int c = lane; c < HD; c += 32) orow[c] = from_f<T>(sO[r * L::LDO + c] / l_safe);
    if (lane == 0) {
      p.lse_out[(static_cast<int64_t>(b) * p.H + h) * p.S + q0 + r] =
          l == 0.0f ? kNegInf : sM[r] + logf(l_safe);
    }
  }
}

// -------------------------------------------------------------------------- backward dq
template <typename T, int HD, int BQ, int BK>
struct DqLayout {
  static constexpr int LDT = pitch<T>(HD), LDS = BK + 4, LDP = pitch<T>(BK), LDO = HD + 4;
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(BQ * LDT * sizeof(T));
  static constexpr int Kt = DO + align128(BQ * LDT * sizeof(T));
  static constexpr int Vt = Kt + align128(BK * LDT * sizeof(T));
  static constexpr int Sc = Vt + align128(BK * LDT * sizeof(T));
  static constexpr int DP = Sc + align128(BQ * LDS * 4);
  static constexpr int DS = DP + align128(BQ * LDS * 4);
  static constexpr int DQ = DS + align128(BQ * LDP * sizeof(T));
  static constexpr int Lse = DQ + align128(BQ * LDO * 4);
  static constexpr int Dl = Lse + align128(BQ * 4);
  static constexpr int QSeg = Dl + align128(BQ * 4);
  static constexpr int KSeg = QSeg + align128(BQ * 4);
  static constexpr int bytes = KSeg + align128(BK * 4);
};

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  using L = DqLayout<T, HD, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::Q);
  T* sDO = reinterpret_cast<T*>(smem + L::DO);
  T* sK = reinterpret_cast<T*>(smem + L::Kt);
  T* sV = reinterpret_cast<T*>(smem + L::Vt);
  float* sS = reinterpret_cast<float*>(smem + L::Sc);
  float* sDP = reinterpret_cast<float*>(smem + L::DP);
  T* sDS = reinterpret_cast<T*>(smem + L::DS);
  float* sDQ = reinterpret_cast<float*>(smem + L::DQ);
  float* sLse = reinterpret_cast<float*>(smem + L::Lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::Dl);
  int* sQseg = reinterpret_cast<int*>(smem + L::QSeg);
  int* sKseg = reinterpret_cast<int*>(smem + L::KSeg);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int q_rows = min(BQ, p.S - q0);
  const bool has_seg = p.q_seg != nullptr;
  const int64_t row_base = (static_cast<int64_t>(b) * p.H + h) * p.S + q0;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1] + q0 * p.q_s[2];
  const T* DOp = static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[1] + q0 * p.do_s[2];
  const T* Kb = static_cast<const T*>(p.k) + b * p.k_s[0] + kh * p.k_s[1];
  const T* Vb = static_cast<const T*>(p.v) + b * p.v_s[0] + kh * p.v_s[1];
  load_rows_async<T, HD>(sQ, L::LDT, Q, p.q_s[2], BQ, q_rows);
  load_rows_async<T, HD>(sDO, L::LDT, DOp, p.do_s[2], BQ, q_rows);
  for (int i = threadIdx.x; i < BQ * HD; i += kThreads) sDQ[(i / HD) * L::LDO + i % HD] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool live = r < q_rows;
    sLse[r] = live ? p.lse[row_base + r] : 0.0f;
    sDelta[r] = live ? p.delta[row_base + r] : 0.0f;
    sQseg[r] = (has_seg && live) ? p.q_seg[b * p.S + q0 + r] : 0;
  }

  const int q_glob = p.q_off + q0;
  const int nk = (p.T + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    if (!tile_needed(p, q_glob, BQ, p.kv_off + k0, BK)) continue;
    const int k_rows = min(BK, p.T - k0);
    load_rows_async<T, HD>(sK, L::LDT, Kb + k0 * p.k_s[2], p.k_s[2], BK, k_rows);
    load_rows_async<T, HD>(sV, L::LDT, Vb + k0 * p.v_s[2], p.v_s[2], BK, k_rows);
    for (int r = threadIdx.x; r < BK; r += kThreads)
      sKseg[r] = (has_seg && r < k_rows) ? p.kv_seg[b * p.T + k0 + r] : 0;
    cp_async_wait_all();
    __syncthreads();
    block_mm<T, false, true, BQ, BK, HD>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    block_mm<T, false, true, BQ, BK, HD>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
      const int r = idx / BK, col = idx % BK;
      float t;
      const float s = capped(sS[r * L::LDS + col] * p.sm_scale, p.softcap, &t);
      const bool ok = r < q_rows && visible(p, q0 + r, k0 + col, sQseg[r], sKseg[col], has_seg);
      const float pv = ok ? expf(s - sLse[r]) : 0.0f;
      float ds = pv * (sDP[r * L::LDS + col] - sDelta[r]) * p.sm_scale;
      if (p.softcap > 0.0f) ds = ds * (1.0f - t * t);
      sDS[r * L::LDP + col] = from_f<T>(ds);
    }
    __syncthreads();
    block_mm<T, false, false, BQ, HD, BK>(sDQ, L::LDO, sDS, L::LDP, sK, L::LDT, true);
    __syncthreads();
  }
  cp_async_wait_all();
  __syncthreads();

  float* DQ = static_cast<float*>(p.out0) + b * p.o0_s[0] + h * p.o0_s[1];
  for (int i = threadIdx.x; i < q_rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    DQ[(q0 + r) * p.o0_s[2] + c] = sDQ[r * L::LDO + c];
  }
}

// ------------------------------------------------------------------------ backward dk/dv
template <typename T, int HD, int BQ, int BK>
struct DkvLayout {
  static constexpr int LDT = pitch<T>(HD), LDS = BK + 4, LDP = pitch<T>(BK), LDO = HD + 4;
  static constexpr int Kt = 0;
  static constexpr int Vt = Kt + align128(BK * LDT * sizeof(T));
  static constexpr int Q = Vt + align128(BK * LDT * sizeof(T));
  static constexpr int DO = Q + align128(BQ * LDT * sizeof(T));
  static constexpr int Sc = DO + align128(BQ * LDT * sizeof(T));
  static constexpr int DP = Sc + align128(BQ * LDS * 4);
  static constexpr int Pr = DP + align128(BQ * LDS * 4);
  static constexpr int DS = Pr + align128(BQ * LDP * sizeof(T));
  static constexpr int DK = DS + align128(BQ * LDP * sizeof(T));
  static constexpr int DV = DK + align128(BK * LDO * 4);
  static constexpr int Lse = DV + align128(BK * LDO * 4);
  static constexpr int Dl = Lse + align128(BQ * 4);
  static constexpr int QSeg = Dl + align128(BQ * 4);
  static constexpr int KSeg = QSeg + align128(BQ * 4);
  static constexpr int bytes = KSeg + align128(BK * 4);
};

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  using L = DkvLayout<T, HD, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::Kt);
  T* sV = reinterpret_cast<T*>(smem + L::Vt);
  T* sQ = reinterpret_cast<T*>(smem + L::Q);
  T* sDO = reinterpret_cast<T*>(smem + L::DO);
  float* sS = reinterpret_cast<float*>(smem + L::Sc);
  float* sDP = reinterpret_cast<float*>(smem + L::DP);
  T* sP = reinterpret_cast<T*>(smem + L::Pr);
  T* sDS = reinterpret_cast<T*>(smem + L::DS);
  float* sDK = reinterpret_cast<float*>(smem + L::DK);
  float* sDV = reinterpret_cast<float*>(smem + L::DV);
  float* sLse = reinterpret_cast<float*>(smem + L::Lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::Dl);
  int* sQseg = reinterpret_cast<int*>(smem + L::QSeg);
  int* sKseg = reinterpret_cast<int*>(smem + L::KSeg);

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K;
  const int k_rows = min(BK, p.T - k0);
  const bool has_seg = p.q_seg != nullptr;

  const T* Kb = static_cast<const T*>(p.k) + b * p.k_s[0] + kh * p.k_s[1] + k0 * p.k_s[2];
  const T* Vb = static_cast<const T*>(p.v) + b * p.v_s[0] + kh * p.v_s[1] + k0 * p.v_s[2];
  load_rows_async<T, HD>(sK, L::LDT, Kb, p.k_s[2], BK, k_rows);
  load_rows_async<T, HD>(sV, L::LDT, Vb, p.v_s[2], BK, k_rows);
  for (int i = threadIdx.x; i < BK * HD; i += kThreads) {
    sDK[(i / HD) * L::LDO + i % HD] = 0.0f;
    sDV[(i / HD) * L::LDO + i % HD] = 0.0f;
  }
  for (int r = threadIdx.x; r < BK; r += kThreads)
    sKseg[r] = (has_seg && r < k_rows) ? p.kv_seg[b * p.T + k0 + r] : 0;

  const int k_glob = p.kv_off + k0;
  const int nq = (p.S + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* Qh = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
    const T* DOh = static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[1];
    const int64_t row_base = (static_cast<int64_t>(b) * p.H + h) * p.S;
    for (int i = 0; i < nq; ++i) {
      const int q0 = i * BQ;
      if (!tile_needed(p, p.q_off + q0, BQ, k_glob, BK)) continue;  // uniform in the block
      const int q_rows = min(BQ, p.S - q0);
      load_rows_async<T, HD>(sQ, L::LDT, Qh + q0 * p.q_s[2], p.q_s[2], BQ, q_rows);
      load_rows_async<T, HD>(sDO, L::LDT, DOh + q0 * p.do_s[2], p.do_s[2], BQ, q_rows);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool live = r < q_rows;
        sLse[r] = live ? p.lse[row_base + q0 + r] : 0.0f;
        sDelta[r] = live ? p.delta[row_base + q0 + r] : 0.0f;
        sQseg[r] = (has_seg && live) ? p.q_seg[b * p.S + q0 + r] : 0;
      }
      cp_async_wait_all();
      __syncthreads();
      block_mm<T, false, true, BQ, BK, HD>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
      block_mm<T, false, true, BQ, BK, HD>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
        const int r = idx / BK, col = idx % BK;
        float t;
        const float s = capped(sS[r * L::LDS + col] * p.sm_scale, p.softcap, &t);
        // Padded q rows (r >= q_rows) must add nothing to dk/dv.
        const bool ok =
            r < q_rows && visible(p, q0 + r, k0 + col, sQseg[r], sKseg[col], has_seg);
        const float pv = ok ? expf(s - sLse[r]) : 0.0f;
        float ds = pv * (sDP[r * L::LDS + col] - sDelta[r]) * p.sm_scale;
        if (p.softcap > 0.0f) ds = ds * (1.0f - t * t);
        sP[r * L::LDP + col] = from_f<T>(pv);
        sDS[r * L::LDP + col] = from_f<T>(ds);
      }
      __syncthreads();
      block_mm<T, true, false, BK, HD, BQ>(sDV, L::LDO, sP, L::LDP, sDO, L::LDT, true);
      block_mm<T, true, false, BK, HD, BQ>(sDK, L::LDO, sDS, L::LDP, sQ, L::LDT, true);
      __syncthreads();
    }
  }
  cp_async_wait_all();
  __syncthreads();

  float* DK = static_cast<float*>(p.out0) + b * p.o0_s[0] + kh * p.o0_s[1];
  float* DV = static_cast<float*>(p.out1) + b * p.o1_s[0] + kh * p.o1_s[1];
  for (int i = threadIdx.x; i < k_rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    DK[(k0 + r) * p.o0_s[2] + c] = sDK[r * L::LDO + c];
    DV[(k0 + r) * p.o1_s[2] + c] = sDV[r * L::LDO + c];
  }
}

// ------------------------------------------------------------ register-fragment helpers
// The bf16 kernels below keep every product's result in registers. wgmma's fp32
// accumulator layout, rounded to bf16, is its register A-operand layout (the layout of
// mma.sync m16n8k16's fragments): the probabilities and ds of one product feed the next
// without leaving the registers.

// Accumulator values x (16 x N), rounded to bf16, as A fragments (16 x N, k = N).
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// The mask-free tiles of the Pallas kernels: no padding on either side, no segments,
// wholly below the causal diagonal and wholly inside the window.
__device__ __forceinline__ bool tile_interior(const Params& p, int q0, int bq, int k0, int bk,
                                              bool has_seg) {
  if (has_seg || q0 + bq > p.S || k0 + bk > p.T) return false;
  const int qg = p.q_off + q0, kg = p.kv_off + k0;
  if (p.causal && kg + bk - 1 > qg) return false;
  if (p.window > 0 && kg <= qg + bq - 1 - p.window) return false;
  return true;
}

// The tiles of the walked axis that meet the block's tile form one range [lo, hi]
// (causal and window each cut one end); hi < lo when there is none.
__device__ __forceinline__ int2 needed_range(const Params& p, int n, bool walk_kv, int fixed0,
                                             int fixed_b, int walk_b) {
  int lo = n, hi = -1;
  for (int t = 0; t < n; ++t) {
    const bool need = walk_kv
        ? tile_needed(p, p.q_off + fixed0, fixed_b, p.kv_off + t * walk_b, walk_b)
        : tile_needed(p, p.q_off + t * walk_b, walk_b, p.kv_off + fixed0, fixed_b);
    if (need) {
      lo = min(lo, t);
      hi = t;
    }
  }
  return make_int2(lo, hi);
}

// ------------------------------------------------ Hopper path (bf16 forward, dq, dk/dv)
// The bf16 kernels are warp-specialised: a block is three warpgroups.
// Warpgroups 0 and 1 (the consumers) each own 64 rows of the block's output tile; they
// run every product as wgmma.mma_async on the tiles that have landed and free a stage
// once their products have read it. Warpgroup 2 gives its registers to the consumers
// (setmaxnreg: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536), and one of its warps
// issues every copy: TMA loads (cp.async.bulk.tensor, 128-byte swizzle, zero fill past
// the tensor's end) into a ring of stages, each with a "full" and an "empty" mbarrier.
// The block enters with 168 registers a thread (65,536 / 384), so no second block fits
// on its SM and setmaxnreg.inc never waits on another block's registers. No code path
// of these kernels may trap: ptxas then keeps those 168 for the consumers too, and
// spills their accumulators.

constexpr int kWsThreads = 3 * kWgThreads;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kFwdBQ = 128, kFwdBK = 128, kFwdStages = 2;
constexpr int kDkvBQ = 64, kDkvBK = 128, kDkvStages = 2;
constexpr int kDqBQ = 128, kDqBK = 64, kDqStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// One 4-D TMA load: the box of `map` at coordinates (col, row, head, batch) into `dst`,
// completing `bytes` transactions on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the special-function unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared tiles of HD bf16 columns as TMA writes them: HD / CB column blocks, each
// `rows` rows of SW bytes in the SW-byte swizzle (128 bytes at hd 64 and 128, 64 at 32).
template <int HD> struct Swz {
  static constexpr int SW = HD >= 64 ? 128 : 64;
  static constexpr int CB = SW / 2;
  static constexpr int NCB = HD / CB;
  static constexpr uint64_t kLayout = SW == 128 ? 1 : 2;  // the descriptor's swizzle mode
};

// wgmma descriptor of a K-major operand: the tile's rows from `tile` on (a tile of R
// rows; `tile` may point at a later row group), k step 0. k step kk (16 columns) adds
// k_step<HD, R>(kk).
template <int HD>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile) {
  using Z = Swz<HD>;
  return make_desc(tile, 16, 8 * Z::SW, Z::kLayout);
}
template <int HD, int R>
__device__ __forceinline__ constexpr uint64_t k_step(int kk) {
  return ((kk * 32 / Swz<HD>::SW) * R * Swz<HD>::SW + (kk * 32) % Swz<HD>::SW) >> 4;
}

// wgmma descriptor of an MN-major operand: a tile of R rows (the product's K) by HD
// columns (its N), column blocks R * SW bytes apart, k step 0. k step kk (16 rows) adds
// mn_step<HD>(kk).
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile) {
  using Z = Swz<HD>;
  return make_desc(tile, R * Z::SW, 8 * Z::SW, Z::kLayout);
}
template <int HD>
__device__ __forceinline__ constexpr uint64_t mn_step(int kk) {
  return (kk * 16 * Swz<HD>::SW) >> 4;
}

// TMA loads of one tile (all its column blocks) of a [B, heads, rows, HD] tensor.
template <int HD, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head, int batch) {
  using Z = Swz<HD>;
#pragma unroll
  for (int cb = 0; cb < Z::NCB; ++cb)
    tma_load(dst + cb * R * Z::SW, map, bar, cb * Z::CB, row, head, batch);
}

// The thread's accumulator columns 8 j + 2 t + e (t = lane % 4, e = 0, 1) that fall in
// [lo, hi] (tile-local, any int64 bounds) are those with 8 j + e in the returned range:
// a tile's mask then costs two compares per element.
__device__ __forceinline__ int2 col_range(long long lo, long long hi) {
  const long long t2 = 2 * (threadIdx.x % 4);
  const auto clamp = [](long long x) { return static_cast<int>(x < -1 ? -1 : x > 256 ? 256 : x); };
  return make_int2(clamp(lo - t2), clamp(hi - t2));
}

// d (+)= A · B for one warpgroup, m64nNk16, bf16 in, fp32 accumulate. wgmma_ss: A and B
// from shared memory, both K-major; the first k step passes accumulate = 0. wgmma_rs_tb:
// A from registers (the mma.sync A-fragment layout), B from shared memory MN-major
// (transpose-B), always accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[4][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory of the warp-specialised kernels (offsets from a 1024-byte aligned base;
// `bytes` adds the slack for that alignment).
template <int HD> struct FwdSmem {
  static constexpr int QB = kFwdBQ * HD * 2, KB = kFwdBK * HD * 2;
  static constexpr int Q = 0;
  static constexpr int Kt = Q + QB;                       // kFwdStages tiles of k
  static constexpr int Vt = Kt + kFwdStages * KB;         // kFwdStages tiles of v
  static constexpr int KSeg = Vt + kFwdStages * KB;       // kFwdStages x BK kv_seg
  static constexpr int Bar = KSeg + kFwdStages * kFwdBK * 4;  // q, full[], empty[]
  static constexpr int used = Bar + (1 + 2 * kFwdStages) * 8;
  static constexpr int bytes = used + 1024;
};

template <int HD> struct DkvSmem {
  static constexpr int KB = kDkvBK * HD * 2, QB = kDkvBQ * HD * 2;
  static constexpr int Kt = 0, Vt = KB;
  static constexpr int Qt = 2 * KB;                       // kDkvStages tiles of q
  static constexpr int DOt = Qt + kDkvStages * QB;        // kDkvStages tiles of do
  static constexpr int Rows = DOt + kDkvStages * QB;      // per stage: lse·log2(e), delta, q_seg
  static constexpr int Bar = Rows + kDkvStages * 3 * kDkvBQ * 4;  // kv, full[], empty[]
  static constexpr int used = Bar + (1 + 2 * kDkvStages) * 8;
  static constexpr int bytes = used + 1024;
};

template <int HD> struct DqSmem {
  static constexpr int QB = kDqBQ * HD * 2, KB = kDqBK * HD * 2;
  static constexpr int Q = 0, DOt = QB;
  static constexpr int Kt = 2 * QB;                      // kDqStages tiles of k
  static constexpr int Vt = Kt + kDqStages * KB;         // kDqStages tiles of v
  static constexpr int KSeg = Vt + kDqStages * KB;       // kDqStages x BK kv_seg
  static constexpr int Bar = KSeg + kDqStages * kDqBK * 4;  // q and do, full[], empty[]
  static constexpr int used = Bar + (1 + 2 * kDqStages) * 8;
  static constexpr int bytes = used + 1024;
};

// Forward. One block per (q tile of 128 rows, head, batch), 1-D grid, the q tile the
// slowest index and taken from the last one down: under the causal mask the blocks with
// the most kv tiles start first. Each consumer warpgroup keeps its 64 rows' scores,
// probabilities and output accumulator in registers: S = Q·Kᵀ (wgmma, both operands in
// shared memory), the online softmax in base 2, then O += P·V with P from registers
// (rounded to bf16) and V read through transpose-B.
template <int HD, bool CAP>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_ws_kernel(const __grid_constant__ Params p,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK, NS = kFwdStages;
  using L = FwdSmem<HD>;
  using Z = Swz<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::Bar);
  uint64_t* q_bar = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + NS;

  const int hb = p.H * p.B;
  const int q0 = ((p.S + BQ - 1) / BQ - 1 - static_cast<int>(blockIdx.x) / hb) * BQ;
  const int h = blockIdx.x % hb % p.H, b = blockIdx.x % hb / p.H;
  const int kh = h / (p.H / p.K);
  const bool has_seg = p.q_seg != nullptr;
  const int2 range = needed_range(p, (p.T + BK - 1) / BK, true, q0, BQ, BK);
  const int n_tiles = max(0, range.y - range.x + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);                 // the producer warp's lanes
      mbar_init(&empty[s], 2 * kWgThreads);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 2) {
    // ------------------------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 2 * kWgThreads + 32) return;  // one warp issues the copies
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(q_bar, L::QB);
      tma_tile<HD, BQ>(smem + L::Q, &tm_q, q_bar, q0, h, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS, k0 = (range.x + it) * BK;
      mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
      if (has_seg) {
        int* kseg = reinterpret_cast<int*>(smem + L::KSeg) + s * BK;
        for (int r = lane; r < BK; r += 32)
          kseg[r] = k0 + r < p.T ? p.kv_seg[static_cast<int64_t>(b) * p.T + k0 + r] : 0;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * L::KB);
        tma_tile<HD, BK>(smem + L::Kt + s * L::KB, &tm_k, &full[s], k0, kh, b);
        tma_tile<HD, BK>(smem + L::Vt + s * L::KB, &tm_v, &full[s], k0, kh, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ------------------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWgThreads;  // rows 64 cw .. 64 cw + 63 of the tile
    const int row0 = 64 * cw + 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4;
    // The thread's two rows are row0 and row0 + 8; acc element (j, c) sits in row
    // row0 + 8 (c / 2), column acc_col(j, c).
    // Each row sees the keys at global positions lo..hi (causal, window), below T, and
    // (with segments) of its segment.
    int qseg[2] = {0, 0}, lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i, rg = p.q_off + row;
      if (has_seg && row < p.S) qseg[i] = p.q_seg[static_cast<int64_t>(b) * p.S + row];
      lo[i] = p.window > 0 ? rg - p.window + 1 : INT_MIN;
      hi[i] = p.causal ? rg : INT_MAX;
    }
    // Scores x = s (or cap·tanh(s·scale/cap)) enter the base-2 softmax as x·scale2.
    const float scale2 = (CAP ? 1.0f : p.sm_scale) * kLog2e;
    const unsigned char* sQ = smem + L::Q + 64 * cw * Z::SW;

    float o[HD / 8][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS, k0 = (range.x + it) * BK;
      mbar_wait(&full[s], (it / NS) & 1);
      const unsigned char* sK = smem + L::Kt + s * L::KB;
      const unsigned char* sV = smem + L::Vt + s * L::KB;

      float sc[BK / 8][4];
      const uint64_t dQ = desc_k<HD>(sQ), dK = desc_k<HD>(sK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, dQ + k_step<HD, BQ>(kk), dK + k_step<HD, BK>(kk), kk > 0);
      wgmma_commit_wait();
      fence_regs(sc);

      const bool interior = tile_interior(p, q0 + 64 * cw, 64, k0, BK, has_seg);
      const int* kseg = reinterpret_cast<const int*>(smem + L::KSeg) + s * BK;
      // Visible columns of each row: the tile-local range of its key positions, below T.
      int2 vis[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long cg0 = static_cast<long long>(p.kv_off) + k0;
        vis[i] = col_range(lo[i] - cg0, min(hi[i] - cg0, static_cast<long long>(p.T - k0 - 1)));
      }
      // One uniform branch per tile, selects inside: a branch per element would cost
      // every tile its convergence barriers.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (CAP) sc[j][c] = p.softcap * tanhf(sc[j][c] * p.sm_scale / p.softcap);
        }
      }
      if (!interior) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c >> 1, e = 8 * j + (c & 1);
            sc[j][c] = e >= vis[i].x && e <= vis[i].y ? sc[j][c] : -INFINITY;
          }
        }
        if (has_seg) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int ks = kseg[acc_col(j, c)];
              sc[j][c] = ks == qseg[c >> 1] && ks != 0 ? sc[j][c] : -INFINITY;
            }
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], sc[j][c]);
      }
      // A row that has seen no key keeps m = -inf; its offset is then 0, so that every
      // exp2 of a masked score is exactly 0 (never inf - inf).
      float alpha[2], off[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_next = fmaxf(m[i], quad_max(mx[i]));
        off[i] = m_next == -INFINITY ? 0.0f : m_next * scale2;
        alpha[i] = ex2(m[i] * scale2 - off[i]);
        m[i] = m_next;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pv = ex2(fmaf(sc[j][c], scale2, -off[c >> 1]));
          sc[j][c] = pv;
          sum[c >> 1] += pv;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[j][c] *= alpha[c >> 1];
      }
      uint32_t pf[BK / 16][4];
      to_a<BK>(pf, sc);
      const uint64_t dV = desc_mn<HD, BK>(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_tb(o, pf[kk], dV + mn_step<HD>(kk));
      wgmma_commit_wait();
      fence_regs(o);
      fence_regs(pf);
      mbar_arrive(&empty[s]);
    }

    bf16* O = static_cast<bf16*>(p.out0) + b * p.o0_s[0] + h * p.o0_s[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      if (row >= p.S) continue;
      const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
      bf16* orow = O + row * p.o0_s[2];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + acc_col(j, 0)) =
            pack_bf16(o[j][2 * i] / l_safe, o[j][2 * i + 1] / l_safe);
      }
      if (threadIdx.x % 4 == 0) {
        p.lse_out[(static_cast<int64_t>(b) * p.H + h) * p.S + row] =
            l[i] == 0.0f ? kNegInf : (CAP ? m[i] : m[i] * p.sm_scale) + logf(l_safe);
      }
    }
  }
}

// dk/dv. One block per (kv tile of 128 rows, kv head, batch), 1-D grid, the kv tile the
// slowest index and taken from the first one up: under the causal mask the blocks with
// the most q tiles start first. The block walks every (group head, q tile of 64 rows)
// pair; the producer warp streams q and do (TMA) and each q tile's lse·log2(e), delta
// and q_seg (its lanes' stores) through the ring. Each consumer warpgroup owns 64 kv
// rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (wgmma, K and V resident in shared memory), then
// dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ from registers (rounded to bf16) and dO, Q
// read through transpose-B. dk and dv stay in registers until the block's end.
template <int HD, bool CAP>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_ws_kernel(const __grid_constant__ Params p,
                            const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do) {
  constexpr int BQ = kDkvBQ, BK = kDkvBK, NS = kDkvStages;
  using L = DkvSmem<HD>;
  using Z = Swz<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::Bar);
  uint64_t* kv_bar = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + NS;
  auto rows = [&](int s, int which) {  // lse·log2(e), delta (float) or q_seg (int)
    return reinterpret_cast<float*>(smem + L::Rows) + (s * 3 + which) * BQ;
  };

  const int kb = p.K * p.B;
  const int k0 = static_cast<int>(blockIdx.x) / kb * BK;
  const int kh = blockIdx.x % kb % p.K, b = blockIdx.x % kb / p.K;
  const int G = p.H / p.K;
  const bool has_seg = p.q_seg != nullptr;
  const int2 range = needed_range(p, (p.S + BQ - 1) / BQ, false, k0, BK, BQ);
  const int n_i = range.y - range.x + 1;  // q tiles per group head (<= 0: none)
  const int n_iter = n_i > 0 ? G * n_i : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 2) {
    // ------------------------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 2 * kWgThreads + 32) return;  // one warp issues the copies
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(kv_bar, 2 * L::KB);
      tma_tile<HD, BK>(smem + L::Kt, &tm_k, kv_bar, k0, kh, b);
      tma_tile<HD, BK>(smem + L::Vt, &tm_v, kv_bar, k0, kh, b);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % NS, h = kh * G + it / n_i, q0 = (range.x + it % n_i) * BQ;
      mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
      const int64_t row_base = (static_cast<int64_t>(b) * p.H + h) * p.S + q0;
      for (int r = lane; r < BQ; r += 32) {
        const bool live = q0 + r < p.S;
        rows(s, 0)[r] = live ? p.lse[row_base + r] * kLog2e : 0.0f;
        rows(s, 1)[r] = live ? p.delta[row_base + r] : 0.0f;
        reinterpret_cast<int*>(rows(s, 2))[r] =
            has_seg && live ? p.q_seg[static_cast<int64_t>(b) * p.S + q0 + r] : 0;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * L::QB);
        tma_tile<HD, BQ>(smem + L::Qt + s * L::QB, &tm_q, &full[s], q0, h, b);
        tma_tile<HD, BQ>(smem + L::DOt + s * L::QB, &tm_do, &full[s], q0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ------------------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWgThreads;  // kv rows 64 cw .. 64 cw + 63
    const int row0 = 64 * cw + 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4;
    // Sᵀ element (j, c) sits in kv row row0 + 8 (c / 2) and q column acc_col(j, c).
    // Each kv row is seen by the query rows at global positions lo..hi (causal, window;
    // none past T), below S, and (with segments) of its segment.
    int kseg[2] = {0, 0}, lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + row0 + 8 * i, cg = p.kv_off + row;
      if (has_seg && row < p.T) kseg[i] = p.kv_seg[static_cast<int64_t>(b) * p.T + row];
      lo[i] = row >= p.T ? INT_MAX : p.causal ? cg : INT_MIN;
      hi[i] = p.window > 0 ? cg + p.window - 1 : INT_MAX;
    }
    const float sm_scale = p.sm_scale, scale2 = (CAP ? 1.0f : sm_scale) * kLog2e;
    const unsigned char* sK = smem + L::Kt + 64 * cw * Z::SW;
    const unsigned char* sV = smem + L::Vt + 64 * cw * Z::SW;

    float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
    mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % NS, q0 = (range.x + it % n_i) * BQ;
      mbar_wait(&full[s], (it / NS) & 1);
      const unsigned char* sQ = smem + L::Qt + s * L::QB;
      const unsigned char* sDO = smem + L::DOt + s * L::QB;
      const float* lse2 = rows(s, 0);
      const float* delta = rows(s, 1);
      const int* qseg = reinterpret_cast<const int*>(rows(s, 2));

      float st[BQ / 8][4], dpt[BQ / 8][4];
      const uint64_t dK = desc_k<HD>(sK), dV = desc_k<HD>(sV);
      const uint64_t dQ = desc_k<HD>(sQ), dDO = desc_k<HD>(sDO);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss(st, dK + k_step<HD, BK>(kk), dQ + k_step<HD, BQ>(kk), kk > 0);
        wgmma_ss(dpt, dV + k_step<HD, BK>(kk), dDO + k_step<HD, BQ>(kk), kk > 0);
      }
      wgmma_commit_wait();
      fence_regs(st);
      fence_regs(dpt);

      const bool interior = tile_interior(p, q0, BQ, k0 + 64 * cw, 64, has_seg);
      // q columns that see each kv row: the tile-local range of their positions, below
      // S (padded q columns must add nothing to dk/dv).
      int2 seen[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long rg0 = static_cast<long long>(p.q_off) + q0;
        seen[i] = col_range(lo[i] - rg0, min(hi[i] - rg0, static_cast<long long>(p.S - q0 - 1)));
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = acc_col(j, c);
          float x = st[j][c], t = 0.0f;
          if (CAP) {
            t = tanhf(x * sm_scale / p.softcap);
            x = p.softcap * t;
          }
          const float pv = ex2(fmaf(x, scale2, -lse2[qc]));
          float ds = pv * (dpt[j][c] - delta[qc]) * sm_scale;
          if (CAP) ds = ds * (1.0f - t * t);
          st[j][c] = pv;
          dpt[j][c] = ds;
        }
      }
      // Masked elements become 0 by select (their p may be inf: a row that sees no key
      // has lse = -1e30), in one uniform branch per tile.
      if (!interior) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c >> 1, e = 8 * j + (c & 1);
            const bool vis = e >= seen[i].x && e <= seen[i].y;
            st[j][c] = vis ? st[j][c] : 0.0f;
            dpt[j][c] = vis ? dpt[j][c] : 0.0f;
          }
        }
        if (has_seg) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int qs = qseg[acc_col(j, c)], ks = kseg[c >> 1];
              const bool vis = qs == ks && ks != 0;
              st[j][c] = vis ? st[j][c] : 0.0f;
              dpt[j][c] = vis ? dpt[j][c] : 0.0f;
            }
          }
        }
      }
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
      to_a<BQ>(pf, st);
      to_a<BQ>(dsf, dpt);
      const uint64_t tDO = desc_mn<HD, BQ>(sDO), tQ = desc_mn<HD, BQ>(sQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs_tb(dv, pf[kk], tDO + mn_step<HD>(kk));   // dv += pᵀ · do
        wgmma_rs_tb(dk, dsf[kk], tQ + mn_step<HD>(kk));   // dk += dsᵀ · q
      }
      wgmma_commit_wait();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      mbar_arrive(&empty[s]);
    }

    float* DK = static_cast<float*>(p.out0) + b * p.o0_s[0] + kh * p.o0_s[1];
    float* DV = static_cast<float*>(p.out1) + b * p.o1_s[0] + kh * p.o1_s[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + row0 + 8 * i;
      if (row >= p.T) continue;
      float* krow = DK + row * p.o0_s[2];
      float* vrow = DV + row * p.o1_s[2];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(krow + acc_col(j, 0)) =
            make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
        *reinterpret_cast<float2*>(vrow + acc_col(j, 0)) =
            make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
      }
    }
  }
}

// dq. One block per (q tile of 128 rows, head, batch), 1-D grid ordered as the
// forward's (under the causal mask the blocks with the most kv tiles start first). Q and
// dO stay in shared memory for the block's life; the producer warp streams 64-row k and
// v tiles (TMA) and their kv_seg through the ring. Each consumer warpgroup owns 64 q
// rows and keeps their lse·log2(e) and delta in registers: S = Q·Kᵀ and dP = dO·Vᵀ
// (wgmma, both operands in shared memory), dS in registers, then dQ += dS·K with dS
// from registers (rounded to bf16) and K read through transpose-B. dq stays in
// registers (64 a thread at hd 128) until the block's end; the 64-key tile keeps S and
// dP at 32 registers each beside it.
template <int HD, bool CAP>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_ws_kernel(const __grid_constant__ Params p,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do) {
  constexpr int BQ = kDqBQ, BK = kDqBK, NS = kDqStages;
  using L = DqSmem<HD>;
  using Z = Swz<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::Bar);
  uint64_t* q_bar = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + NS;

  const int hb = p.H * p.B;
  const int q0 = ((p.S + BQ - 1) / BQ - 1 - static_cast<int>(blockIdx.x) / hb) * BQ;
  const int h = blockIdx.x % hb % p.H, b = blockIdx.x % hb / p.H;
  const int kh = h / (p.H / p.K);
  const bool has_seg = p.q_seg != nullptr;
  const int2 range = needed_range(p, (p.T + BK - 1) / BK, true, q0, BQ, BK);
  const int n_tiles = max(0, range.y - range.x + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 2) {
    // ------------------------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 2 * kWgThreads + 32) return;  // one warp issues the copies
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(q_bar, 2 * L::QB);
      tma_tile<HD, BQ>(smem + L::Q, &tm_q, q_bar, q0, h, b);
      tma_tile<HD, BQ>(smem + L::DOt, &tm_do, q_bar, q0, h, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS, k0 = (range.x + it) * BK;
      mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
      if (has_seg) {
        int* kseg = reinterpret_cast<int*>(smem + L::KSeg) + s * BK;
        for (int r = lane; r < BK; r += 32)
          kseg[r] = k0 + r < p.T ? p.kv_seg[static_cast<int64_t>(b) * p.T + k0 + r] : 0;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * L::KB);
        tma_tile<HD, BK>(smem + L::Kt + s * L::KB, &tm_k, &full[s], k0, kh, b);
        tma_tile<HD, BK>(smem + L::Vt + s * L::KB, &tm_v, &full[s], k0, kh, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ------------------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWgThreads;  // rows 64 cw .. 64 cw + 63 of the tile
    const int row0 = 64 * cw + 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4;
    // The thread's two rows are row0 and row0 + 8, as in the forward; each sees the keys
    // at global positions lo..hi (causal, window), below T, and (with segments) of its
    // segment.
    int qseg[2] = {0, 0}, lo[2], hi[2];
    float lse2[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i, rg = p.q_off + row;
      const bool live = row < p.S;
      const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.S + row;
      if (has_seg && live) qseg[i] = p.q_seg[static_cast<int64_t>(b) * p.S + row];
      lse2[i] = live ? p.lse[at] * kLog2e : 0.0f;
      delta[i] = live ? p.delta[at] : 0.0f;
      lo[i] = p.window > 0 ? rg - p.window + 1 : INT_MIN;
      hi[i] = p.causal ? rg : INT_MAX;
    }
    const float sm_scale = p.sm_scale, scale2 = (CAP ? 1.0f : sm_scale) * kLog2e;
    const unsigned char* sQ = smem + L::Q + 64 * cw * Z::SW;
    const unsigned char* sDO = smem + L::DOt + 64 * cw * Z::SW;

    float dq[HD / 8][4] = {};
    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS, k0 = (range.x + it) * BK;
      mbar_wait(&full[s], (it / NS) & 1);
      const unsigned char* sK = smem + L::Kt + s * L::KB;
      const unsigned char* sV = smem + L::Vt + s * L::KB;

      float sc[BK / 8][4], dp[BK / 8][4];
      const uint64_t dQ = desc_k<HD>(sQ), dDO = desc_k<HD>(sDO);
      const uint64_t dK = desc_k<HD>(sK), dV = desc_k<HD>(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss(sc, dQ + k_step<HD, BQ>(kk), dK + k_step<HD, BK>(kk), kk > 0);
        wgmma_ss(dp, dDO + k_step<HD, BQ>(kk), dV + k_step<HD, BK>(kk), kk > 0);
      }
      wgmma_commit_wait();
      fence_regs(sc);
      fence_regs(dp);

      const bool interior = tile_interior(p, q0 + 64 * cw, 64, k0, BK, has_seg);
      const int* kseg = reinterpret_cast<const int*>(smem + L::KSeg) + s * BK;
      int2 vis[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long cg0 = static_cast<long long>(p.kv_off) + k0;
        vis[i] = col_range(lo[i] - cg0, min(hi[i] - cg0, static_cast<long long>(p.T - k0 - 1)));
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = sc[j][c], t = 0.0f;
          if (CAP) {
            t = tanhf(x * sm_scale / p.softcap);
            x = p.softcap * t;
          }
          const float pv = ex2(fmaf(x, scale2, -lse2[c >> 1]));
          float ds = pv * (dp[j][c] - delta[c >> 1]) * sm_scale;
          if (CAP) ds = ds * (1.0f - t * t);
          sc[j][c] = ds;
        }
      }
      // Masked elements become 0 by select (their p may be inf: a row that sees no key
      // has lse = -1e30), in one uniform branch per tile.
      if (!interior) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c >> 1, e = 8 * j + (c & 1);
            sc[j][c] = e >= vis[i].x && e <= vis[i].y ? sc[j][c] : 0.0f;
          }
        }
        if (has_seg) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int ks = kseg[acc_col(j, c)];
              sc[j][c] = ks == qseg[c >> 1] && ks != 0 ? sc[j][c] : 0.0f;
            }
          }
        }
      }
      uint32_t dsf[BK / 16][4];
      to_a<BK>(dsf, sc);
      const uint64_t tK = desc_mn<HD, BK>(sK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_tb(dq, dsf[kk], tK + mn_step<HD>(kk));
      wgmma_commit_wait();
      fence_regs(dq);
      fence_regs(dsf);
      mbar_arrive(&empty[s]);
    }

    float* DQ = static_cast<float*>(p.out0) + b * p.o0_s[0] + h * p.o0_s[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      if (row >= p.S) continue;
      float* drow = DQ + row * p.o0_s[2];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(drow + acc_col(j, 0)) =
            make_float2(dq[j][2 * i], dq[j][2 * i + 1]);
      }
    }
  }
}


// --------------------------------------------------------------------------- dispatch
// fp32: the shared-memory kernels, 64 x 64 tiles except where fp32 operands would pass
// the 227 KB of shared memory a block may use. bf16: the warp-specialised wgmma kernels.
constexpr int kF32FwdQ = 64, kF32FwdK = 64, kF32DqQ = 64, kF32DqK = 32, kF32DkvQ = 32,
              kF32DkvK = 64;

template <int D> struct HeadDim { static constexpr int value = D; };

template <typename F>
cudaError_t with_head_dim(int hd, F&& f) {
  switch (hd) {
    case 32: return f(HeadDim<32>{});
    case 64: return f(HeadDim<64>{});
    case 128: return f(HeadDim<128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
                   void* stream) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, dim3(threads), smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// A 4-D TMA map over the bf16 tensor [B, heads, rows, HD] at `base` (strides `s` in
// elements: batch, head, row; any order, e.g. the model's [B,S,H,hd] viewed as
// [B,H,S,hd]), read in boxes of one column block by `box_rows` rows, swizzled as the
// wgmma descriptors expect; rows past the end read as zeros. A dimension of size 1
// takes a canonical stride (its own may be anything).
template <int HD>
bool tensor_map(CUtensorMap* map, const void* base, int B, int heads, int rows,
                const int64_t* s, int box_rows) {
  using Z = Swz<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  rows = rows > 0 ? rows : 1;  // no tile of an empty tensor is ever loaded
  const int64_t row_s = rows > 1 ? s[2] : HD;
  const int64_t head_s = heads > 1 ? s[1] : row_s * rows;
  const int64_t batch_s = B > 1 ? s[0] : head_s * heads;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_s * 2),
                                 static_cast<cuuint64_t>(head_s * 2),
                                 static_cast<cuuint64_t>(batch_s * 2)};
  const cuuint32_t box[4] = {Z::CB, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                Z::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch a warp-specialised kernel on a 1-D grid of `blocks` with its tensor maps.
template <typename Kernel, typename... Maps>
cudaError_t launch_ws(Kernel kernel, int blocks, int smem, const Params& p, void* stream,
                      const Maps&... maps) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWsThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, maps...);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, int B, int H, int K, int S,
                   int T, const int64_t* q_s, const int64_t* k_s, const int64_t* v_s,
                   const int* q_seg, const int* kv_seg, float sm_scale, float softcap,
                   int window, int causal, int q_off, int kv_off) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.B = B;
  p.H = H;
  p.K = K;
  p.S = S;
  p.T = T;
  for (int i = 0; i < 3; ++i) {
    p.q_s[i] = q_s[i];
    p.k_s[i] = k_s[i];
    p.v_s[i] = v_s[i];
  }
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window = window;
  p.causal = causal;
  p.q_off = q_off;
  p.kv_off = kv_off;
  return p;
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` and returns cudaGetLastError() (0 on success);
// a head dim other than 32/64/128 or a type other than fp32/bf16 (dtype 0/1) returns
// cudaErrorInvalidValue. Strides are in elements, three per tensor (batch, head, row);
// the last dim of every tensor is contiguous and rows start on 16-byte boundaries.
// q_seg/kv_seg are null or int32 [B,S] / [B,T]; lse and delta are fp32 [B,H,S].

// o (q's type, strides o_s) and lse from q [B,H,S,hd], k/v [B,K,T,hd].
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                     const int* q_seg, const int* kv_seg, int B, int H, int K, int S, int T,
                     int hd, const int64_t* q_s, const int64_t* k_s, const int64_t* v_s,
                     const int64_t* o_s, float sm_scale, float softcap, int window,
                     int causal, int q_off, int kv_off, int dtype, void* stream) {
  Params p = make_params(q, k, v, B, H, K, S, T, q_s, k_s, v_s, q_seg, kv_seg, sm_scale,
                         softcap, window, causal, q_off, kv_off);
  p.out0 = o;
  p.lse_out = lse;
  for (int i = 0; i < 3; ++i) p.o0_s[i] = o_s[i];
  return with_head_dim(hd, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == kBF16) {
      const int blocks = cdiv(S, kFwdBQ) * H * B;
      if (blocks == 0) return cudaSuccess;
      CUtensorMap tq, tk, tv;
      if (!tensor_map<D>(&tq, q, B, H, S, q_s, kFwdBQ) ||
          !tensor_map<D>(&tk, k, B, K, T, k_s, kFwdBK) ||
          !tensor_map<D>(&tv, v, B, K, T, v_s, kFwdBK))
        return cudaErrorInvalidValue;
      return softcap > 0.0f ? launch_ws(flash_fwd_ws_kernel<D, true>, blocks, FwdSmem<D>::bytes,
                                        p, stream, tq, tk, tv)
                            : launch_ws(flash_fwd_ws_kernel<D, false>, blocks,
                                        FwdSmem<D>::bytes, p, stream, tq, tk, tv);
    }
    const dim3 grid(cdiv(S, kF32FwdQ), H, B);
    if (dtype == kF32)
      return launch(flash_fwd_kernel<float, D, kF32FwdQ, kF32FwdK>, grid, kThreads,
                    FwdLayout<float, D, kF32FwdQ, kF32FwdK>::bytes, p, stream);
    return cudaErrorInvalidValue;
  });
}


// dq (fp32, strides dq_s) from q, k, v, do (strides do_s), lse and delta.
int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, float* dq, const int* q_seg,
                        const int* kv_seg, int B, int H, int K, int S, int T, int hd,
                        const int64_t* q_s, const int64_t* k_s, const int64_t* v_s,
                        const int64_t* do_s, const int64_t* dq_s, float sm_scale,
                        float softcap, int window, int causal, int q_off, int kv_off,
                        int dtype, void* stream) {
  Params p = make_params(q, k, v, B, H, K, S, T, q_s, k_s, v_s, q_seg, kv_seg, sm_scale,
                         softcap, window, causal, q_off, kv_off);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out0 = dq;
  for (int i = 0; i < 3; ++i) {
    p.do_s[i] = do_s[i];
    p.o0_s[i] = dq_s[i];
  }
  return with_head_dim(hd, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == kBF16) {
      const int blocks = cdiv(S, kDqBQ) * H * B;
      if (blocks == 0) return cudaSuccess;
      CUtensorMap tq, tk, tv, tdo;
      if (!tensor_map<D>(&tq, q, B, H, S, q_s, kDqBQ) ||
          !tensor_map<D>(&tk, k, B, K, T, k_s, kDqBK) ||
          !tensor_map<D>(&tv, v, B, K, T, v_s, kDqBK) ||
          !tensor_map<D>(&tdo, dout, B, H, S, do_s, kDqBQ))
        return cudaErrorInvalidValue;
      return softcap > 0.0f
                 ? launch_ws(flash_bwd_dq_ws_kernel<D, true>, blocks, DqSmem<D>::bytes, p,
                             stream, tq, tk, tv, tdo)
                 : launch_ws(flash_bwd_dq_ws_kernel<D, false>, blocks, DqSmem<D>::bytes, p,
                             stream, tq, tk, tv, tdo);
    }
    const dim3 grid(cdiv(S, kF32DqQ), H, B);
    if (dtype == kF32)
      return launch(flash_bwd_dq_kernel<float, D, kF32DqQ, kF32DqK>, grid, kThreads,
                    DqLayout<float, D, kF32DqQ, kF32DqK>::bytes, p, stream);
    return cudaErrorInvalidValue;
  });
}


// dk, dv (fp32 [B,K,T,hd], strides dk_s/dv_s) from q, k, v, do, lse and delta.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, float* dk, float* dv,
                         const int* q_seg, const int* kv_seg, int B, int H, int K, int S,
                         int T, int hd, const int64_t* q_s, const int64_t* k_s,
                         const int64_t* v_s, const int64_t* do_s, const int64_t* dk_s,
                         const int64_t* dv_s, float sm_scale, float softcap, int window,
                         int causal, int q_off, int kv_off, int dtype, void* stream) {
  Params p = make_params(q, k, v, B, H, K, S, T, q_s, k_s, v_s, q_seg, kv_seg, sm_scale,
                         softcap, window, causal, q_off, kv_off);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out0 = dk;
  p.out1 = dv;
  for (int i = 0; i < 3; ++i) {
    p.do_s[i] = do_s[i];
    p.o0_s[i] = dk_s[i];
    p.o1_s[i] = dv_s[i];
  }
  return with_head_dim(hd, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == kBF16) {
      const int blocks = cdiv(T, kDkvBK) * K * B;
      if (blocks == 0) return cudaSuccess;
      CUtensorMap tq, tk, tv, tdo;
      if (!tensor_map<D>(&tq, q, B, H, S, q_s, kDkvBQ) ||
          !tensor_map<D>(&tk, k, B, K, T, k_s, kDkvBK) ||
          !tensor_map<D>(&tv, v, B, K, T, v_s, kDkvBK) ||
          !tensor_map<D>(&tdo, dout, B, H, S, do_s, kDkvBQ))
        return cudaErrorInvalidValue;
      return softcap > 0.0f
                 ? launch_ws(flash_bwd_dkv_ws_kernel<D, true>, blocks, DkvSmem<D>::bytes, p,
                             stream, tq, tk, tv, tdo)
                 : launch_ws(flash_bwd_dkv_ws_kernel<D, false>, blocks, DkvSmem<D>::bytes, p,
                             stream, tq, tk, tv, tdo);
    }
    const dim3 grid(cdiv(T, kF32DkvK), K, B);
    if (dtype == kF32)
      return launch(flash_bwd_dkv_kernel<float, D, kF32DkvQ, kF32DkvK>, grid, kThreads,
                    DkvLayout<float, D, kF32DkvQ, kF32DkvK>::bytes, p, stream);
    return cudaErrorInvalidValue;
  });
}


// Dynamic shared memory of one block of each kernel (the wrapper checks it against the
// card's 227 KB): which = 0 forward, 1 dq, 2 dk/dv; 0 for an unsupported head dim/type.
int flash_smem_bytes(int which, int hd, int dtype) {
  int bytes = 0;
  with_head_dim(hd, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == kBF16) {
      bytes = which == 0   ? FwdSmem<D>::bytes
              : which == 1 ? DqSmem<D>::bytes
                           : DkvSmem<D>::bytes;
    } else if (dtype == kF32) {
      bytes = which == 0   ? FwdLayout<float, D, kF32FwdQ, kF32FwdK>::bytes
              : which == 1 ? DqLayout<float, D, kF32DqQ, kF32DqK>::bytes
                           : DkvLayout<float, D, kF32DkvQ, kF32DkvK>::bytes;
    }
    return cudaSuccess;
  });
  return bytes;
}


}  // extern "C"

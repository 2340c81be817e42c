// FlashAttention-2 forward and backward for Hopper (sm_90a), CUDA C++ with plain C
// entry points.
//
// Replaces three TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel     (:155, pallas_call in _fwd at :306)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (:343, pallas_call in _bwd_dq at :560)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (:422, pallas_call in _bwd_dkv at :625)
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
// in the Pallas kernels. Tiles reach shared memory by cp.async. Two paths:
//   bf16 (the training path): tensor-core kernels (*_mma_kernel), FlashAttention-2
//     style -- each warp owns 16 rows and keeps its scores, probabilities and fp32
//     accumulators in registers, issuing mma.sync m16n8k16 on ldmatrix operands;
//   fp32: shared-memory kernels with plain fp32 products (no TF32, whose ten mantissa
//     bits would not hold the fp32 tolerance), scores and accumulators in shared memory.
//
// Bound on this card (H100 SXM): at training shapes attention is bound by its matrix
// products (forward 4 B H S T hd flops, halved under the causal mask; dq three
// products, dk/dv four, counting the recomputed scores) over 989 TFLOP/s bf16 dense.
// What the bf16 design does about it: every product runs on the tensor cores with its
// operands in registers; it still issues mma.sync rather than wgmma, loads without TMA
// and overlaps no copy with compute -- later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// ------------------------------------------------------------ tensor-core path (bf16)
// bf16 inputs take these three kernels instead of the shared-memory ones above. They
// keep every product in registers, FlashAttention-2 style: 4 warps per block, each warp
// owning 16 rows of the block's output tile (q rows for the forward and dq, kv rows for
// dk/dv) and issuing mma.sync m16n8k16 (bf16 in, fp32 accumulate) with operands read
// from shared memory by ldmatrix. The scores, probabilities and ds of a warp never
// leave its registers: the fp32 accumulator layout of one product, rounded to bf16, is
// the A-operand layout of the next (p for p·v, ds for ds·k). dk/dv works on the
// transposed scores sᵀ = k·qᵀ so that the kv rows it owns are the rows of every product.
// Roundings are those of the kernels above: p and ds rounded to bf16 before their
// products, row sums taken over the fp32 p.

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;
// Tiles (rows of q, rows of kv): dk/dv walks q in tiles of 32 to keep its two
// accumulators, sᵀ and dpᵀ within the registers of one thread.
constexpr int kMmaFwdQ = 64, kMmaFwdK = 64, kMmaDqQ = 64, kMmaDqK = 64, kMmaDkvQ = 32,
              kMmaDkvK = 64;

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

// A fragment (16 x 16) at rows r0.., cols k0.. of a row-major tile with pitch ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, tile + (r0 + (l % 8) + ((l / 8) % 2) * 8) * ld + k0 + (l / 16) * 8);
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

// acc[N/8] += A (the warp's 16 rows r0.. of row-major tile sA, K wide) · B, where B (K x N)
// is a tile stored [n][k].
template <int N, int K>
__device__ __forceinline__ void mm_smem_nk(float (&acc)[N / 8][4], const bf16* sA, int lda,
                                           int r0, const bf16* sB, int ldb) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    load_a(a, sA, lda, r0, kk * 16);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      load_b_nk(b, sB, ldb, np * 16, kk * 16);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[N/8] += A (register fragments, 16 x K) · B, where B (K x N) is a tile stored [k][n].
template <int N, int K>
__device__ __forceinline__ void mm_reg_kn(float (&acc)[N / 8][4], const uint32_t (&a)[K / 16][4],
                                          const bf16* sB, int ldb) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      load_b_kn(b, sB, ldb, np * 16, kk * 16);
      mma16816(acc[2 * np], a[kk], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator element (j, c) of a thread sits at row gid + 8 * (c / 2) of the warp's 16
// and column 8 * j + 2 * tig + (c % 2).
__device__ __forceinline__ int acc_row(int c) { return (threadIdx.x % 32) / 4 + 8 * (c >> 1); }
__device__ __forceinline__ int acc_col(int j, int c) {
  return 8 * j + 2 * (threadIdx.x % 4) + (c & 1);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_group0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// exp on the special-function unit (ex2.approx): within a few fp32 ulps, far inside
// the bf16 path's tolerance.
__device__ __forceinline__ float fexp(float x) { return __expf(x); }

// Shared memory of a tensor-core kernel: NQ tiles of BQ q-side rows (q; q and do; or two
// buffers of both), NK tiles of BK kv-side rows (two buffers of k and v; or k and v),
// then the per-row lse, delta and q_seg (two buffers) and kv_seg (two buffers).
template <int HD, int BQ, int BK, int NQ, int NK>
struct MmaLayout {
  static constexpr int LD = HD + 8;
  static constexpr int QB = BQ * LD * 2, KB = BK * LD * 2;
  static constexpr int Q = 0;
  static constexpr int Kt = Q + align128(NQ * QB);
  static constexpr int Lse = Kt + align128(NK * KB);
  static constexpr int KSeg = Lse + align128(2 * 3 * BQ * 4);
  static constexpr int bytes = KSeg + align128(2 * BK * 4);
};
template <int HD> using FwdMma = MmaLayout<HD, kMmaFwdQ, kMmaFwdK, 1, 4>;
template <int HD> using DqMma = MmaLayout<HD, kMmaDqQ, kMmaDqK, 2, 4>;
template <int HD> using DkvMma = MmaLayout<HD, kMmaDkvQ, kMmaDkvK, 4, 2>;

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(const Params p) {
  constexpr int BQ = kMmaFwdQ, BK = kMmaFwdK;
  using L = FwdMma<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  int* sQseg = reinterpret_cast<int*>(smem + L::Lse);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int q_rows = min(BQ, p.S - q0);
  const bool has_seg = p.q_seg != nullptr;
  const int r0 = (threadIdx.x / 32) * 16;
  const bf16* Kb = static_cast<const bf16*>(p.k) + b * p.k_s[0] + kh * p.k_s[1];
  const bf16* Vb = static_cast<const bf16*>(p.v) + b * p.v_s[0] + kh * p.v_s[1];
  auto sK = [&](int buf) { return reinterpret_cast<bf16*>(smem + L::Kt + buf * 2 * L::KB); };
  auto sV = [&](int buf) { return reinterpret_cast<bf16*>(smem + L::Kt + (buf * 2 + 1) * L::KB); };
  auto sKseg = [&](int buf) { return reinterpret_cast<int*>(smem + L::KSeg) + buf * BK; };
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * BK, k_rows = min(BK, p.T - k0);
    load_rows_async<bf16, HD, kMmaThreads>(sK(buf), L::LD, Kb + k0 * p.k_s[2], p.k_s[2], BK, k_rows);
    load_rows_async<bf16, HD, kMmaThreads>(sV(buf), L::LD, Vb + k0 * p.v_s[2], p.v_s[2], BK, k_rows);
    for (int r = threadIdx.x; r < BK; r += kMmaThreads)
      sKseg(buf)[r] = (has_seg && r < k_rows) ? p.kv_seg[b * p.T + k0 + r] : 0;
  };

  const int2 range = needed_range(p, (p.T + BK - 1) / BK, true, q0, BQ, BK);
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[1] + q0 * p.q_s[2];
  load_rows_async<bf16, HD, kMmaThreads>(sQ, L::LD, Q, p.q_s[2], BQ, q_rows);
  for (int r = threadIdx.x; r < BQ; r += kMmaThreads)
    sQseg[r] = (has_seg && r < q_rows) ? p.q_seg[b * p.S + q0 + r] : 0;
  if (range.x <= range.y) load_kv(range.x, 0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) load_a(qf[kk], sQ, L::LD, r0, kk * 16);
  const int qseg[2] = {sQseg[r0 + acc_row(0)], sQseg[r0 + acc_row(2)]};

  float o[HD / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  for (int j = range.x; j <= range.y; ++j) {
    const int buf = (j - range.x) & 1, k0 = j * BK;
    if (j < range.y) load_kv(j + 1, buf ^ 1);  // in flight while this tile computes
    cp_async_commit();
    const bf16* k_tile = sK(buf);
    const int* kseg = sKseg(buf);
    const bool interior = tile_interior(p, q0, BQ, k0, BK, has_seg);

    float s[BK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bfr[4];
        load_b_nk(bfr, k_tile, L::LD, np * 16, kk * 16);
        mma16816(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mma16816(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }
    // Online softmax over the thread's two rows (each row spread over a quad of lanes).
    uint32_t ok = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = acc_col(jj, c), i = c >> 1;
        float t;
        const float v = capped(s[jj][c] * p.sm_scale, p.softcap, &t);
        const bool vis = interior ||
            visible(p, q0 + r0 + acc_row(c), k0 + col, qseg[i], kseg[col], has_seg);
        ok |= static_cast<uint32_t>(vis) << (4 * jj + c);
        s[jj][c] = vis ? v : kNegInf;
        mx[i] = fmaxf(mx[i], s[jj][c]);
      }
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_next = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = fexp(m[i] - m_next);
      m[i] = m_next;
    }
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = (ok >> (4 * jj + c)) & 1u ? fexp(s[jj][c] - m[c >> 1]) : 0.0f;
        s[jj][c] = pv;
        sum[c >> 1] += pv;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[jj][c] *= alpha[c >> 1];
    }
    uint32_t pf[BK / 16][4];
    to_a<BK>(pf, s);
    mm_reg_kn<HD, BK>(o, pf, sV(buf), L::LD);
    cp_async_wait_group0();
    __syncthreads();  // the next tile has landed and every warp is done with this one
  }

  bf16* O = static_cast<bf16*>(p.out0) + b * p.o0_s[0] + h * p.o0_s[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + acc_row(2 * i);
    if (row >= q_rows) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
    bf16* orow = O + (q0 + row) * p.o0_s[2];
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(orow + acc_col(jj, 0)) =
          pack_bf16(o[jj][2 * i] / l_safe, o[jj][2 * i + 1] / l_safe);
    }
    if (threadIdx.x % 4 == 0) {
      p.lse_out[(static_cast<int64_t>(b) * p.H + h) * p.S + q0 + row] =
          l[i] == 0.0f ? kNegInf : m[i] + logf(l_safe);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma_kernel(const Params p) {
  constexpr int BQ = kMmaDqQ, BK = kMmaDqK;
  using L = DqMma<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::Q + L::QB);
  int* sQseg = reinterpret_cast<int*>(smem + L::Lse);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int q_rows = min(BQ, p.S - q0);
  const bool has_seg = p.q_seg != nullptr;
  const int r0 = (threadIdx.x / 32) * 16;
  const int64_t row_base = (static_cast<int64_t>(b) * p.H + h) * p.S + q0;
  const bf16* Kb = static_cast<const bf16*>(p.k) + b * p.k_s[0] + kh * p.k_s[1];
  const bf16* Vb = static_cast<const bf16*>(p.v) + b * p.v_s[0] + kh * p.v_s[1];
  auto sK = [&](int buf) { return reinterpret_cast<bf16*>(smem + L::Kt + buf * 2 * L::KB); };
  auto sV = [&](int buf) { return reinterpret_cast<bf16*>(smem + L::Kt + (buf * 2 + 1) * L::KB); };
  auto sKseg = [&](int buf) { return reinterpret_cast<int*>(smem + L::KSeg) + buf * BK; };
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * BK, k_rows = min(BK, p.T - k0);
    load_rows_async<bf16, HD, kMmaThreads>(sK(buf), L::LD, Kb + k0 * p.k_s[2], p.k_s[2], BK, k_rows);
    load_rows_async<bf16, HD, kMmaThreads>(sV(buf), L::LD, Vb + k0 * p.v_s[2], p.v_s[2], BK, k_rows);
    for (int r = threadIdx.x; r < BK; r += kMmaThreads)
      sKseg(buf)[r] = (has_seg && r < k_rows) ? p.kv_seg[b * p.T + k0 + r] : 0;
  };

  const int2 range = needed_range(p, (p.T + BK - 1) / BK, true, q0, BQ, BK);
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[1] + q0 * p.q_s[2];
  const bf16* DOp =
      static_cast<const bf16*>(p.dout) + b * p.do_s[0] + h * p.do_s[1] + q0 * p.do_s[2];
  load_rows_async<bf16, HD, kMmaThreads>(sQ, L::LD, Q, p.q_s[2], BQ, q_rows);
  load_rows_async<bf16, HD, kMmaThreads>(sDO, L::LD, DOp, p.do_s[2], BQ, q_rows);
  for (int r = threadIdx.x; r < BQ; r += kMmaThreads)
    sQseg[r] = (has_seg && r < q_rows) ? p.q_seg[b * p.S + q0 + r] : 0;
  if (range.x <= range.y) load_kv(range.x, 0);
  float lse[2], delta[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + acc_row(2 * i);
    live[i] = row < q_rows;
    lse[i] = live[i] ? p.lse[row_base + row] : 0.0f;
    delta[i] = live[i] ? p.delta[row_base + row] : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();
  const int qseg[2] = {sQseg[r0 + acc_row(0)], sQseg[r0 + acc_row(2)]};

  float dq[HD / 8][4] = {};
  for (int j = range.x; j <= range.y; ++j) {
    const int buf = (j - range.x) & 1, k0 = j * BK;
    if (j < range.y) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    const int* kseg = sKseg(buf);
    const bool interior = tile_interior(p, q0, BQ, k0, BK, has_seg);

    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
    mm_smem_nk<BK, HD>(s, sQ, L::LD, r0, sK(buf), L::LD);
    mm_smem_nk<BK, HD>(dp, sDO, L::LD, r0, sV(buf), L::LD);
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = acc_col(jj, c), i = c >> 1;
        float t;
        const float v = capped(s[jj][c] * p.sm_scale, p.softcap, &t);
        const bool vis = interior || (live[i] &&
            visible(p, q0 + r0 + acc_row(c), k0 + col, qseg[i], kseg[col], has_seg));
        const float pv = vis ? fexp(v - lse[i]) : 0.0f;
        float ds = pv * (dp[jj][c] - delta[i]) * p.sm_scale;
        if (p.softcap > 0.0f) ds = ds * (1.0f - t * t);
        s[jj][c] = ds;
      }
    }
    uint32_t dsf[BK / 16][4];
    to_a<BK>(dsf, s);
    mm_reg_kn<HD, BK>(dq, dsf, sK(buf), L::LD);
    cp_async_wait_group0();
    __syncthreads();
  }

  float* DQ = static_cast<float*>(p.out0) + b * p.o0_s[0] + h * p.o0_s[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    float* drow = DQ + (q0 + r0 + acc_row(2 * i)) * p.o0_s[2];
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<float2*>(drow + acc_col(jj, 0)) =
          make_float2(dq[jj][2 * i], dq[jj][2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkv_mma_kernel(const Params p) {
  constexpr int BQ = kMmaDkvQ, BK = kMmaDkvK;
  using L = DkvMma<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::Kt);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::Kt + L::KB);
  int* sKseg = reinterpret_cast<int*>(smem + L::KSeg);

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K;
  const int k_rows = min(BK, p.T - k0);
  const bool has_seg = p.q_seg != nullptr;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first kv row
  auto sQ = [&](int buf) { return reinterpret_cast<bf16*>(smem + L::Q + buf * 2 * L::QB); };
  auto sDO = [&](int buf) { return reinterpret_cast<bf16*>(smem + L::Q + (buf * 2 + 1) * L::QB); };
  auto sRow = [&](int buf, int which) {  // lse, delta (float) or q_seg (int) of a q tile
    return reinterpret_cast<float*>(smem + L::Lse) + (buf * 3 + which) * BQ;
  };
  // Load q tile i of group head g into buffer buf: q and do rows (async), lse, delta, q_seg.
  auto load_q = [&](int g, int i, int buf) {
    const int h = kh * G + g, q0 = i * BQ, q_rows = min(BQ, p.S - q0);
    const int64_t row_base = (static_cast<int64_t>(b) * p.H + h) * p.S + q0;
    const bf16* Qh = static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
    const bf16* DOh = static_cast<const bf16*>(p.dout) + b * p.do_s[0] + h * p.do_s[1];
    load_rows_async<bf16, HD, kMmaThreads>(sQ(buf), L::LD, Qh + q0 * p.q_s[2], p.q_s[2], BQ, q_rows);
    load_rows_async<bf16, HD, kMmaThreads>(sDO(buf), L::LD, DOh + q0 * p.do_s[2], p.do_s[2], BQ,
                                           q_rows);
    for (int r = threadIdx.x; r < BQ; r += kMmaThreads) {
      const bool live = r < q_rows;
      sRow(buf, 0)[r] = live ? p.lse[row_base + r] : 0.0f;
      sRow(buf, 1)[r] = live ? p.delta[row_base + r] : 0.0f;
      reinterpret_cast<int*>(sRow(buf, 2))[r] = (has_seg && live) ? p.q_seg[b * p.S + q0 + r] : 0;
    }
  };

  const int2 range = needed_range(p, (p.S + BQ - 1) / BQ, false, k0, BK, BQ);
  const int n_i = range.y - range.x + 1;  // q tiles per group head (<= 0: none)
  const bf16* Kb = static_cast<const bf16*>(p.k) + b * p.k_s[0] + kh * p.k_s[1] + k0 * p.k_s[2];
  const bf16* Vb = static_cast<const bf16*>(p.v) + b * p.v_s[0] + kh * p.v_s[1] + k0 * p.v_s[2];
  load_rows_async<bf16, HD, kMmaThreads>(sK, L::LD, Kb, p.k_s[2], BK, k_rows);
  load_rows_async<bf16, HD, kMmaThreads>(sV, L::LD, Vb, p.v_s[2], BK, k_rows);
  for (int r = threadIdx.x; r < BK; r += kMmaThreads)
    sKseg[r] = (has_seg && r < k_rows) ? p.kv_seg[b * p.T + k0 + r] : 0;
  if (n_i > 0) load_q(0, range.x, 0);
  cp_async_wait_all();
  __syncthreads();
  const int kseg[2] = {sKseg[r0 + acc_row(0)], sKseg[r0 + acc_row(2)]};

  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  const int n_iter = n_i > 0 ? G * n_i : 0;
  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1, i = range.x + it % n_i, q0 = i * BQ;
    if (it + 1 < n_iter) load_q((it + 1) / n_i, range.x + (it + 1) % n_i, buf ^ 1);
    cp_async_commit();
    const bf16* q_tile = sQ(buf);
    const bf16* do_tile = sDO(buf);
    const float* lse = sRow(buf, 0);
    const float* delta = sRow(buf, 1);
    const int* qseg = reinterpret_cast<const int*>(sRow(buf, 2));
    const int q_rows = min(BQ, p.S - q0);
    const bool interior = tile_interior(p, q0, BQ, k0, BK, has_seg);

    float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
    mm_smem_nk<BQ, HD>(st, sK, L::LD, r0, q_tile, L::LD);    // sᵀ = k · qᵀ
    mm_smem_nk<BQ, HD>(dpt, sV, L::LD, r0, do_tile, L::LD);  // dpᵀ = v · doᵀ
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = acc_col(jj, c), kr = r0 + acc_row(c);
        float t;
        const float v = capped(st[jj][c] * p.sm_scale, p.softcap, &t);
        // Padded q columns (qc >= q_rows) must add nothing to dk/dv.
        const bool vis = interior || (qc < q_rows &&
            visible(p, q0 + qc, k0 + kr, qseg[qc], kseg[c >> 1], has_seg));
        const float pv = vis ? fexp(v - lse[qc]) : 0.0f;
        float ds = pv * (dpt[jj][c] - delta[qc]) * p.sm_scale;
        if (p.softcap > 0.0f) ds = ds * (1.0f - t * t);
        st[jj][c] = pv;
        dpt[jj][c] = ds;
      }
    }
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
    to_a<BQ>(pf, st);
    to_a<BQ>(dsf, dpt);
    mm_reg_kn<HD, BQ>(dv, pf, do_tile, L::LD);  // dv += pᵀ · do
    mm_reg_kn<HD, BQ>(dk, dsf, q_tile, L::LD);  // dk += dsᵀ · q
    cp_async_wait_group0();
    __syncthreads();
  }

  float* DK = static_cast<float*>(p.out0) + b * p.o0_s[0] + kh * p.o0_s[1];
  float* DV = static_cast<float*>(p.out1) + b * p.o1_s[0] + kh * p.o1_s[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + acc_row(2 * i);
    if (row >= k_rows) continue;
    float* krow = DK + (k0 + row) * p.o0_s[2];
    float* vrow = DV + (k0 + row) * p.o1_s[2];
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<float2*>(krow + acc_col(jj, 0)) =
          make_float2(dk[jj][2 * i], dk[jj][2 * i + 1]);
      *reinterpret_cast<float2*>(vrow + acc_col(jj, 0)) =
          make_float2(dv[jj][2 * i], dv[jj][2 * i + 1]);
    }
  }
}

// --------------------------------------------------------------------------- dispatch
// fp32: the shared-memory kernels, 64 x 64 tiles except where fp32 operands would pass
// the 227 KB of shared memory a block may use. bf16: the tensor-core kernels.
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
    const dim3 grid(cdiv(S, dtype == kBF16 ? kMmaFwdQ : kF32FwdQ), H, B);
    if (dtype == kBF16)
      return launch(flash_fwd_mma_kernel<D>, grid, kMmaThreads,
                    FwdMma<D>::bytes, p, stream);
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
    const dim3 grid(cdiv(S, dtype == kBF16 ? kMmaDqQ : kF32DqQ), H, B);
    if (dtype == kBF16)
      return launch(flash_bwd_dq_mma_kernel<D>, grid, kMmaThreads,
                    DqMma<D>::bytes, p, stream);
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
    const dim3 grid(cdiv(T, dtype == kBF16 ? kMmaDkvK : kF32DkvK), K, B);
    if (dtype == kBF16)
      return launch(flash_bwd_dkv_mma_kernel<D>, grid, kMmaThreads,
                    DkvMma<D>::bytes, p, stream);
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
      bytes = which == 0   ? FwdMma<D>::bytes
              : which == 1 ? DqMma<D>::bytes
                           : DkvMma<D>::bytes;
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

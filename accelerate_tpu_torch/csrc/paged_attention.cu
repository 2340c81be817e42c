// Paged-attention decode for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_attention.py::_kernel (reached
// through paged_attention, pallas_call at :250). It computes the same function:
// q [B,T,H,hd] attends to a shared KV pool [P,ps,K,hd] through int32 block tables
// [B,MP]; key slot j is visible to the query at position pos[b]+t iff j <= pos[b]+t,
// j lies inside the sliding window (when window > 0) and valid[b,j] is set (valid is
// [B,C], and slots at or past C count as invalid — the "padded to MP*ps" rule).
// Scores are scaled, optionally tanh-capped, and reduced with an online softmax in
// fp32; p is rounded to the V operand's type before the PV product (p.astype(v.dtype)
// in the Pallas kernel); a fully masked row outputs zeros (l == 0 -> divide by 1).
// Sentinel table entries (== P) clamp to page P-1 for the read; the valid mask hides
// them, exactly as in the Pallas kernel. int8 pools dequantize in the kernel from
// their fp32 scale pages [P,ps,K,1], so no full-precision copy of the cache exists.
//
// Design. The TPU kernel walks a sequential grid axis over logical pages and carries
// the softmax state in VMEM scratch between grid steps. Blocks on a GPU run in no
// order, so the work is split the flash-decoding way, in two kernels:
//
// 1. paged_attention_partial, grid (B, K, S): block (b, h, z) takes chunk z of lane
//    b's key slots — kChunk slots, as many as fill 64 KB of K and V in shared memory
//    (128 slots for bf16 at hd=128), whatever the page size. It resolves each slot's
//    physical page once, then copies the whole chunk of K and V into shared memory
//    with 16-byte cp.async copies, all in flight together. All T*G query rows of kv
//    head h (T positions x G = H/K grouped heads) are held together, so each K/V
//    element is read from device memory once per kv head. Each thread scores one
//    slot against every row, one warp per row takes the chunk's max and sum, and
//    the block writes its unnormalized p @ V with the chunk's (max, sum) to scratch.
// 2. paged_attention_combine, grid (B, K): rescales the chunks' partial sums to the
//    common max and divides by the total sum.
//
// Chunks wholly past pos[b]+T-1, or wholly before the window of the first query, are
// never loaded: every slot there is masked for every row, so the output is identical.
//
// Bound on this card (H100 SXM, 3.35 TB/s): decode attention does ~2 flops per byte,
// so it is bound by the bytes of the live K/V slots it must read once:
// sum_b (pos[b]+T) * K * hd * 2 planes * itemsize, divided by 3.35 TB/s. What the
// design does about it: it reads only live chunks, each K/V element once per (lane,
// kv head), with coalesced 16-byte copies, and splits each lane over several blocks
// so that B*K = 64 (lane, kv head) pairs still put hundreds of blocks on 132 SMs.
// Left for later work: TMA page loads, wgmma for the T*G x hd products, and a
// persistent schedule that balances lanes of different lengths.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF; marks masked scores
constexpr int kRowGroup = 8;       // query rows scored together (registers per thread)

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// Key slots per block: enough to fill 64 KB with the chunk's K and V rows.
template <typename KV, int HD>
__host__ __device__ constexpr int chunk_slots() {
  constexpr int n = 65536 / (2 * HD * static_cast<int>(sizeof(KV)));
  return n > 256 ? 256 : (n < 16 ? 16 : n);
}

// Shared-memory row of one slot: hd elements plus 16 bytes of padding, so that the
// 16-byte reads of consecutive slots by consecutive threads spread over all banks.
template <typename KV, int HD>
__host__ __device__ constexpr int row_bytes() { return HD * static_cast<int>(sizeof(KV)) + 16; }

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename KV, int HD>
__host__ __device__ size_t partial_smem_bytes(int rows) {
  constexpr int C = chunk_slots<KV, HD>();
  const int rows8 = round_up(rows, kRowGroup);
  return 2 * static_cast<size_t>(C) * row_bytes<KV, HD>()  // K, V rows
         + sizeof(unsigned long long) * C                  // pool row per slot
         + sizeof(float) * (static_cast<size_t>(rows8) * HD  // q rows (fp32)
                            + static_cast<size_t>(rows) * C  // scores, then p
                            + 2 * C)                          // k/v scales per slot
         + C;                                                // live-and-valid flag
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// p as the PV product sees it: rounded to bf16 for bf16 pages; fp32 pages and
// dequantized int8 pages (fp32 after the scale) keep it in fp32.
template <typename KV> __device__ __forceinline__ float round_p(float p) { return p; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// 16 bytes of KV elements → floats.
template <typename KV> struct Vec16 {
  static constexpr int N = 16 / static_cast<int>(sizeof(KV));
  __device__ __forceinline__ static void load(const unsigned char* p, float (&f)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  }
};

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

// Key slots [first, end) of lane b can be visible to some query row; chunks are
// aligned to kChunk from 0, so chunk z covers [(first/kChunk + z) * kChunk, +kChunk).
struct LaneRange {
  int first_chunk, n_chunks;
};

__device__ __forceinline__ LaneRange lane_range(int pos0, int T, int MP, int ps, int window,
                                                int chunk) {
  long long end = static_cast<long long>(pos0) + T;
  const long long cap = static_cast<long long>(MP) * ps;
  end = end < 0 ? 0 : (end > cap ? cap : end);
  long long first = 0;
  if (window > 0 && pos0 - window + 1 > 0) first = pos0 - window + 1;
  const int fc = static_cast<int>(first / chunk);
  const long long span = end - static_cast<long long>(fc) * chunk;
  return {fc, span > 0 ? static_cast<int>((span + chunk - 1) / chunk) : 0};
}

template <typename QT, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_partial(
    const QT* __restrict__ q,               // [B, T, H, HD]
    const KVT* __restrict__ k_pool,         // [P, ps, K, HD]
    const KVT* __restrict__ v_pool,         // [P, ps, K, HD]
    const float* __restrict__ k_scale,      // [P, ps, K] (int8 pools) or null
    const float* __restrict__ v_scale,
    const int32_t* __restrict__ tables,     // [B, MP]
    const int32_t* __restrict__ positions,  // [B]
    const uint8_t* __restrict__ valid,      // [B, C] bool
    float* __restrict__ part_acc,           // [B, K, S, R, HD] unnormalized p @ V
    float* __restrict__ part_ml,            // [B, K, S, R, 2] chunk (max, sum)
    int T, int H, int K, int P, int ps, int MP, int C, int S,
    float sm_scale, int window, float softcap) {
  constexpr int kChunk = chunk_slots<KVT, HD>();
  constexpr int kRow = row_bytes<KVT, HD>();
  constexpr int kVecs = HD * static_cast<int>(sizeof(KVT)) / 16;  // 16-byte copies per row
  constexpr int kN = Vec16<KVT>::N;
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int G = H / K;
  const int R = T * G;  // query rows of this kv head: r = t*G + g
  const int R8 = round_up(R, kRowGroup);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos0 = positions[b];
  const LaneRange range = lane_range(pos0, T, MP, ps, window, kChunk);
  if (z >= range.n_chunks) return;  // nothing visible here; the combine skips it
  const int base = (range.first_chunk + z) * kChunk;
  const int end = min(pos0 + T, MP * ps);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;                          // [kChunk][kRow]
  unsigned char* v_s = k_s + kChunk * kRow;           // [kChunk][kRow]
  unsigned long long* row_s =
      reinterpret_cast<unsigned long long*>(v_s + kChunk * kRow);  // [kChunk]
  float* q_s = reinterpret_cast<float*>(row_s + kChunk);  // [R8][HD]
  float* s_s = q_s + R8 * HD;                         // [R][kChunk]
  float* ks_s = s_s + R * kChunk;                     // [kChunk]
  float* vs_s = ks_s + kChunk;                        // [kChunk]
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(vs_s + kChunk);  // [kChunk]

  // Each slot's physical K/V row, and whether it is live (inside the lane's range)
  // and valid.
  for (int j = tid; j < kChunk; j += kThreads) {
    const int slot = base + j;
    const bool live = slot < end;
    unsigned long long row = 0;
    if (live) {
      int page = tables[static_cast<size_t>(b) * MP + slot / ps];
      page = page < P - 1 ? page : P - 1;  // sentinel (== P) clamps; valid masks it
      row = (static_cast<unsigned long long>(page) * ps + slot % ps) * K + h;
    }
    row_s[j] = row;
    ok_s[j] = live && slot < C && valid[static_cast<size_t>(b) * C + slot] != 0;
    ks_s[j] = (k_scale != nullptr && live) ? k_scale[row] : 1.f;
    vs_s[j] = (v_scale != nullptr && live) ? v_scale[row] : 1.f;
  }
  __syncthreads();
  // The whole chunk's K and V rows, in flight together: consecutive threads copy
  // consecutive 16 bytes of a row. Rows past the lane's range are zero-filled.
  const unsigned char* k_bytes = reinterpret_cast<const unsigned char*>(k_pool);
  const unsigned char* v_bytes = reinterpret_cast<const unsigned char*>(v_pool);
  for (int i = tid; i < kChunk * kVecs; i += kThreads) {
    const int j = i / kVecs, c = i % kVecs;
    const size_t src = row_s[j] * (HD * sizeof(KVT)) + c * 16;
    const bool live = base + j < end;
    cp_async16(k_s + j * kRow + c * 16, k_bytes + src, live);
    cp_async16(v_s + j * kRow + c * 16, v_bytes + src, live);
  }
  for (int i = tid; i < R8 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int t = r / G, g = r % G;
    q_s[i] = r < R ? to_f(q[((static_cast<size_t>(b) * T + t) * H + h * G + g) * HD + d])
                   : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // Scores: thread j scores slot j against every query row, kRowGroup rows at a time.
  for (int j = tid; j < kChunk; j += kThreads) {
    const int slot = base + j;
    const unsigned char* krow = k_s + j * kRow;
    const bool ok = ok_s[j];
    const float kscale = ks_s[j];
    for (int r0 = 0; r0 < R; r0 += kRowGroup) {
      float dot[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) dot[i] = 0.f;
      for (int c = 0; c < kVecs; ++c) {
        float kf[kN];
        Vec16<KVT>::load(krow + c * 16, kf);
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
          const float* qr = q_s + (r0 + i) * HD + c * kN;
#pragma unroll
          for (int e = 0; e < kN; ++e) dot[i] += qr[e] * kf[e];
        }
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const int r = r0 + i;
        if (r >= R) break;
        const int qpos = pos0 + r / G;
        bool vis = ok && slot <= qpos;
        if (window > 0) vis = vis && slot > qpos - window;
        float s = kNegInf;
        if (vis) {
          s = dot[i] * kscale * sm_scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        }
        s_s[r * kChunk + j] = s;
      }
    }
  }
  __syncthreads();

  // Per row (one warp each): the chunk's max and sum; p overwrites the scores, rounded
  // as the PV product sees it (and times the V scale for int8 pages).
  const size_t part = ((static_cast<size_t>(b) * K + h) * S + z) * R;
  for (int r = warp; r < R; r += kWarps) {
    float* sr = s_s + r * kChunk;
    float m = kNegInf;
    for (int j = lane; j < kChunk; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < kChunk; j += 32) {
      const float p = sr[j] > kNegInf ? expf(sr[j] - m) : 0.f;
      sum += p;
      sr[j] = round_p<KVT>(p) * vs_s[j];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_ml[(part + r) * 2] = m;
      part_ml[(part + r) * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // p @ V for this chunk: thread i owns output element (r, d) = (i / HD, i % HD).
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const float* pr = s_s + r * kChunk;
    const KVT* vcol = reinterpret_cast<const KVT*>(v_s) + d;
    constexpr int kStride = kRow / static_cast<int>(sizeof(KVT));
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) acc += pr[j] * to_f(vcol[j * kStride]);
    part_acc[(part + r) * HD + d] = acc;
  }
}

template <typename QT, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ positions, QT* __restrict__ out,
    int T, int H, int K, int ps, int MP, int S, int window) {
  constexpr int kChunk = chunk_slots<KVT, HD>();
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / K;
  const int R = T * G;
  const LaneRange range = lane_range(positions[b], T, MP, ps, window, kChunk);
  const size_t part = (static_cast<size_t>(b) * K + h) * S * R;
  for (int i = threadIdx.x; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float m = kNegInf;
    for (int z = 0; z < range.n_chunks; ++z) m = fmaxf(m, part_ml[(part + z * R + r) * 2]);
    float l = 0.f, acc = 0.f;
    for (int z = 0; z < range.n_chunks; ++z) {
      const size_t zr = part + z * R + r;
      const float w = expf(part_ml[zr * 2] - m);
      l += part_ml[zr * 2 + 1] * w;
      acc += part_acc[zr * HD + d] * w;
    }
    const int t = r / G, g = r % G;
    out[((static_cast<size_t>(b) * T + t) * H + h * G + g) * HD + d] =
        from_f<QT>(acc / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KVT, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* positions, const void* valid, void* part_acc,
                   void* part_ml, void* out, int B, int T, int H, int K, int P, int ps,
                   int MP, int C, float sm_scale, int window, float softcap,
                   cudaStream_t stream) {
  constexpr int kChunk = chunk_slots<KVT, HD>();
  const int S = (MP * ps + kChunk - 1) / kChunk;
  auto partial = paged_attention_partial<QT, KVT, HD>;
  const size_t smem = partial_smem_bytes<KVT, HD>(T * (H / K));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  partial<<<dim3(B, K, S), dim3(kThreads), smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(positions), static_cast<const uint8_t*>(valid),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), T, H, K, P, ps, MP, C,
      S, sm_scale, window, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attention_combine<QT, KVT, HD><<<dim3(B, K), dim3(kThreads), 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int32_t*>(positions), static_cast<QT*>(out), T, H, K, ps, MP, S,
      window);
  return cudaGetLastError();
}

// Dispatch on the head dim: f(std::integral_constant-like tag) for 32/64/128/256.
template <int HD> struct HeadDim { static constexpr int value = HD; };

template <typename F>
cudaError_t with_head_dim(int hd, F&& f) {
  switch (hd) {
    case 32: return f(HeadDim<32>{});
    case 64: return f(HeadDim<64>{});
    case 128: return f(HeadDim<128>{});
    case 256: return f(HeadDim<256>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_types(int q_dtype, int kv_dtype, F&& f) {
  if (q_dtype == kF32 && kv_dtype == kF32) return f(float{}, float{});
  if (q_dtype == kBF16 && kv_dtype == kBF16) return f(__nv_bfloat16{}, __nv_bfloat16{});
  if (q_dtype == kF32 && kv_dtype == kI8) return f(float{}, int8_t{});
  if (q_dtype == kBF16 && kv_dtype == kI8) return f(__nv_bfloat16{}, int8_t{});
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Key slots one partial block takes for this head dim and pool type (0 if unsupported);
// the wrapper sizes the scratch with S = ceil(MP*ps / chunk) chunks per lane.
int paged_attention_chunk(int hd, int kv_dtype) {
  int chunk = 0;
  with_types(kv_dtype == kI8 ? kF32 : kv_dtype, kv_dtype, [&](auto, auto kv) {
    return with_head_dim(hd, [&](auto d) {
      chunk = chunk_slots<decltype(kv), decltype(d)::value>();
      return cudaSuccess;
    });
  });
  return chunk;
}

// Dynamic shared memory of one partial block (the wrapper checks it against the card).
size_t paged_attention_smem_bytes(int rows, int hd, int kv_dtype) {
  size_t bytes = 0;
  with_types(kv_dtype == kI8 ? kF32 : kv_dtype, kv_dtype, [&](auto, auto kv) {
    return with_head_dim(hd, [&](auto d) {
      bytes = partial_smem_bytes<decltype(kv), decltype(d)::value>(rows);
      return cudaSuccess;
    });
  });
  return bytes;
}

// Launch both kernels on `stream`; returns cudaGetLastError() (0 on success). q_dtype
// is kF32 or kBF16; kv_dtype is q_dtype or kI8 (then k_scale/v_scale are fp32 scale
// pages). part_acc holds B*K*S*R*hd floats and part_ml B*K*S*R*2, R = T*H/K.
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale, const void* tables,
                           const void* positions, const void* valid, void* part_acc,
                           void* part_ml, void* out, int B, int T, int H, int K, int hd,
                           int P, int ps, int MP, int C, float sm_scale, int window,
                           float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(q_dtype, kv_dtype, [&](auto qt, auto kvt) {
    return with_head_dim(hd, [&](auto d) {
      return launch<decltype(qt), decltype(kvt), decltype(d)::value>(
          q, k_pool, v_pool, k_scale, v_scale, tables, positions, valid, part_acc,
          part_ml, out, B, T, H, K, P, ps, MP, C, sm_scale, window, softcap, s);
    });
  });
}

}  // extern "C"

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
// in the Pallas kernel: bf16 for bf16 pools, fp32 for int8 pools dequantized to fp32);
// a fully masked row outputs zeros (l == 0 -> divide by 1). Sentinel table entries
// (== P) clamp to page P-1 for the read; the valid mask hides them, exactly as in the
// Pallas kernel. int8 pools dequantize in the kernel from their fp32 scale pages
// [P,ps,K,1], so no full-precision copy of the cache exists.
//
// Bound on this card (H100 SXM, 3.35 TB/s): decode attention does ~2 flops per byte,
// so it is bound by the bytes of the live K/V slots it must read once:
// sum_b (pos[b]+T) * K * hd * 2 planes * itemsize, divided by 3.35 TB/s.
//
// bf16 q (bf16 or int8 pools), on the shapes it takes (the serving path's among them: page
// sizes a power of two >= 8, at most 64 query rows T·H/K, 32 at hd 256, tensors on
// 16-byte boundaries): paged_attention_cluster_kernel, one launch. The TPU kernel
// walks a sequential grid axis over pages and carries the softmax state in VMEM between
// grid steps; here the blocks of one (lane, kv head) form a thread block cluster (at most
// 8 blocks, one per 64-slot tile of a full lane, fewer where the B·K clusters would not
// fit the card at about two blocks an SM) and each takes a contiguous share of the
// lane's live tiles, walking several when the lane has more tiles than the cluster has
// blocks. A producer warp reads each page id from the table and issues one TMA copy per
// page (3-D map over the pool [P·ps, K, hd], swizzled) for K and V, with the valid flags
// (and int8 scales) beside them, into a 2-stage mbarrier ring, so the loads of one tile
// overlap the math of the last. Four consumer warps run both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate), swapped so that the query rows sit on
// the mma's n = 8 side: Sᵀ = K·Qᵀ with the slots on the 16 rows (R = T·G rows padded to
// a multiple of 8 with zero q rows, whose outputs are never written), the softmax in fp32
// registers, then Oᵀ = Vᵀ·Pᵀ with the head dims on the rows, V read through ldmatrix's
// transpose and p (rounded to bf16; for int8 pools p·v_scale split into two bf16 parts,
// so it keeps fp32's precision) from shared memory. The blocks then merge their (m, l,
// output) through distributed shared memory in rank order, every peer's load in flight
// at once; blocks without a live tile only meet the cluster's barriers. Nothing goes
// through device memory between the two halves, and the wrapper allocates only the
// output. (Pushing the partials to their owners instead, as int8_matmul.cu does, made
// this kernel slower and spilled.)
//
// fp32 q (the fp32 parity path), and bf16 q on the shapes the cluster kernel does not take
// (page sizes such as 4 or 24, chosen by shape before the launch): the flash-decoding
// split in two kernels on the CUDA cores. paged_attention_partial, grid (B, K, S), takes
// chunk z of lane b's key slots (as many as fill 64 KB of K and V in shared memory),
// copies it with 16-byte cp.async,
// scores every query row of kv head h against it, and writes its unnormalized p @ V with
// the chunk's (max, sum) to the caller's scratch; paged_attention_combine, grid (B, K),
// rescales the chunks' partial sums to the common max and divides by the total sum.
//
// Chunks (tiles) wholly past pos[b]+T-1, or wholly before the window of the first query,
// are never loaded: every slot there is masked for every row.

#include "hopper.cuh"

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

// ---- bf16 q: one launch, a thread block cluster per (lane, kv head) -------------------
constexpr int kTS = 64;                        // key slots per tile
constexpr int kPStages = 2;                    // tiles in flight per block
constexpr int kCWarps = 4;                     // consumer warps
constexpr int kCThreads = 32 * kCWarps;
constexpr int kPBlock = kCThreads + 32;        // + the producer warp
constexpr int kMaxCluster = 8;                 // portable cluster size

struct PagedParams {
  const bf16* q;              // [B, T, H, HD]
  const float* k_scale;       // [P, ps, K] (int8 pools) or null
  const float* v_scale;
  const int32_t* tables;      // [B, MP]
  const int32_t* positions;   // [B]
  const uint8_t* valid;       // [B, C]
  bf16* out;                  // [B, T, H, HD]
  int T, H, K, P, ps, MP, C;
  float sm_scale, softcap;
  int window;
};

// Shared memory of one block, offsets from a 1024-byte aligned base. A plane's tile is
// NCB column blocks of kTS rows × CBB bytes, each as TMA's CBB-byte swizzle writes it.
template <typename KV, int HD, int NR> struct PagedSmem {
  static constexpr int RB = HD * static_cast<int>(sizeof(KV));  // bytes of one slot's row
  static constexpr int CBB = RB < 128 ? RB : 128;              // column block bytes
  static constexpr int NCB = RB / CBB;
  static constexpr int TB = kTS * RB;                           // one plane's tile
  static constexpr bool kI8 = sizeof(KV) == 1;
  static constexpr int RP = 8 * NR;                             // query rows, padded
  static constexpr int QLD = HD + 8;                            // q row (bf16 elements)
  static constexpr int PLD = kTS + 8;                           // p row (bf16 elements)
  static constexpr int Kt = 0;                                  // kPStages K tiles
  static constexpr int Vt = Kt + kPStages * TB;                 // kPStages V tiles
  static constexpr int Ok = Vt + kPStages * TB;                 // kPStages x kTS valid flags
  static constexpr int Ks = Ok + kPStages * kTS;                // int8: k, v scales per slot
  static constexpr int Vs = Ks + (kI8 ? kPStages * kTS * 4 : 0);
  static constexpr int Q = Vs + (kI8 ? kPStages * kTS * 4 : 0); // [RP][QLD] bf16
  static constexpr int Ph = Q + RP * QLD * 2;                   // [RP][PLD] bf16: p
  static constexpr int Pl = Ph + RP * PLD * 2;                  // int8: p's low part
  static constexpr int Red = Pl + (kI8 ? RP * PLD * 2 : 0);     // [2][kCWarps][RP] fp32
  static constexpr int Ml = Red + 2 * kCWarps * RP * 4;         // [RP] (m, l) of the block
  static constexpr int Bar = Ml + RP * 8;                       // full[], empty[]
  static constexpr int used = Bar + 2 * kPStages * 8;
  static constexpr int bytes = used + 1024;
  static constexpr int Acc = 0;            // [RP][HD] fp32 partial output, over the ring
  static_assert(RP * HD * 4 <= Ok, "the partial output overlays the ring");
  static_assert(Q % 16 == 0 && Ph % 16 == 0 && Red % 16 == 0, "aligned regions");
};

// Byte offset of (slot j, byte c of its row) in a plane's tile.
template <typename L>
__device__ __forceinline__ int tile_off(int j, int c) {
  return swizzled<L::CBB>((c / L::CBB) * kTS * L::CBB + j * L::CBB + c % L::CBB);
}

// Two int8 codes (lo in the low byte) as a bf16 pair (exact).
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t v) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                   static_cast<float>(static_cast<int8_t>((v >> 8) & 0xff)));
}

// A fragment (m16 × k16) of Kᵀ's product Sᵀ = K·Qᵀ: rows = slots j0 .. j0 + 15, k = the
// head dims d0 .. d0 + 15.
template <typename KV, typename L>
__device__ __forceinline__ void k_frag(uint32_t (&a)[4], const unsigned char* tile, int j0,
                                       int d0) {
  const int lane = threadIdx.x % 32;
  if constexpr (L::kI8) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (slot g + 8 (i & 1), dims 2t + 8 (i >> 1) .. + 1)
      const int j = j0 + g + 8 * (i & 1), d = d0 + 2 * t + 8 * (i >> 1);
      a[i] = i8x2_bf16(*reinterpret_cast<const uint16_t*>(tile + tile_off<L>(j, d)));
    }
  } else {
    const int mi = lane / 8;  // matrix mi: slots + 8 (mi & 1), dims + 8 (mi >> 1)
    const int j = j0 + lane % 8 + 8 * (mi & 1), d = d0 + 8 * (mi >> 1);
    ldsm_x4(a, reinterpret_cast<const bf16*>(tile + tile_off<L>(j, 2 * d)));
  }
}

// A fragment of Vᵀ for Oᵀ = Vᵀ·Pᵀ: rows = head dims d0 .. d0 + 15, k = slots j0 .. j0 + 15.
template <typename KV, typename L>
__device__ __forceinline__ void vt_frag(uint32_t (&a)[4], const unsigned char* tile, int d0,
                                        int j0) {
  const int lane = threadIdx.x % 32;
  if constexpr (L::kI8) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (dim g + 8 (i & 1), slots 2t + 8 (i >> 1) .. + 1)
      const int d = d0 + g + 8 * (i & 1), j = j0 + 2 * t + 8 * (i >> 1);
      const uint32_t lo = tile[tile_off<L>(j, d)], hi = tile[tile_off<L>(j + 1, d)];
      a[i] = i8x2_bf16(lo | (hi << 8));
    }
  } else {
    const int mi = lane / 8;  // matrix mi: dims + 8 (mi & 1), slots + 8 (mi >> 1)
    const int j = j0 + lane % 8 + 8 * (mi >> 1), d = d0 + 8 * (mi & 1);
    ldsm_x4_t(a, reinterpret_cast<const bf16*>(tile + tile_off<L>(j, 2 * d)));
  }
}

// Block (z, h, b) of the cluster of (lane b, kv head h): tiles of kTS key slots
// [first + z·per, first + (z + 1)·per) of the lane's live range. Warps 0-3 compute; warp
// 4 streams the tiles. Sᵀ = K·Qᵀ puts the tile's slots on the mma's 16 rows (warp w: slots
// 16w .. 16w + 15) and the query rows (r = t·G + g) on its n = 8; each row's running max
// m and sum l are kept by every thread that holds the row; Oᵀ = Vᵀ·Pᵀ puts the head dims
// on the rows (warp w: dims 16 (w·MT + i)) with p from shared memory.
template <typename KV, int HD, int NR>
__global__ void __launch_bounds__(kPBlock)
paged_attention_cluster_kernel(const __grid_constant__ PagedParams p,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v) {
  using L = PagedSmem<KV, HD, NR>;
  constexpr int MT = HD / 16 >= kCWarps ? HD / 16 / kCWarps : 1;  // Oᵀ row tiles a warp
  constexpr int kUnits = 8;  // at most kTS / 8 page copies a tile (page_size >= 8)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::Bar);
  uint64_t* empty = full + kPStages;
  float* red = reinterpret_cast<float*>(smem + L::Red);
  float* ml = reinterpret_cast<float*>(smem + L::Ml);

  const int z = cluster_rank(), cs = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K, R = p.T * G;
  const int pos0 = p.positions[b];
  const LaneRange range = lane_range(pos0, p.T, p.MP, p.ps, p.window, kTS);
  const int per = (range.n_chunks + cs - 1) / cs;
  const int n_active = per > 0 ? (range.n_chunks + per - 1) / per : 0;
  const int my_n = max(0, min(per, range.n_chunks - z * per));
  const int tile_base = range.first_chunk + z * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == kCThreads) {  // the producer: fetch the maps' descriptors early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_v)) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kPStages; ++i) {
      mbar_init(&full[i], 32);          // the producer warp's lanes
      mbar_init(&empty[i], kCThreads);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCWarps) {
    // ------------------------------------------------------------------- producer
    // Page copies of u = min(ps, kTS) slots; lane i < kTS / u resolves copy i's pool row.
    const int u = min(p.ps, kTS), units = kTS / u;
    auto unit_row = [&](int tile) {
      if (lane >= units || tile >= my_n) return 0;
      const int slot = (tile_base + tile) * kTS + lane * u;
      const int lp = slot / p.ps;
      int page = lp < p.MP ? p.tables[static_cast<size_t>(b) * p.MP + lp] : p.P - 1;
      page = page < p.P - 1 ? page : p.P - 1;  // sentinel (== P) clamps; valid masks it
      return page * p.ps + slot % p.ps;
    };
    int row = unit_row(0);
    for (int it = 0; it < my_n; ++it) {
      const int st = it % kPStages, tile0 = (tile_base + it) * kTS;
      mbar_wait(&empty[st], ((it / kPStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[st], 2 * L::TB);
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int r = __shfl_sync(0xffffffffu, row, i);
        if (lane == 0 && i < units) {
#pragma unroll
          for (int cb = 0; cb < L::NCB; ++cb) {
            const int dst = cb * kTS * L::CBB + i * u * L::CBB;
            const int c0 = cb * L::CBB / static_cast<int>(sizeof(KV));
            tma_load3d(smem + L::Kt + st * L::TB + dst, &tm_k, &full[st], c0, h, r);
            tma_load3d(smem + L::Vt + st * L::TB + dst, &tm_v, &full[st], c0, h, r);
          }
        }
      }
      // Each slot's valid flag (and int8 scales) beside the copies.
      uint8_t* ok = smem + L::Ok + st * kTS;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = lane + 32 * half, slot = tile0 + j;
        ok[j] = slot < p.C ? p.valid[static_cast<size_t>(b) * p.C + slot] : 0;
        if constexpr (L::kI8) {
          const int prow = __shfl_sync(0xffffffffu, row, j / u) + j % u;
          const size_t si = static_cast<size_t>(prow) * p.K + h;
          reinterpret_cast<float*>(smem + L::Ks)[st * kTS + j] = p.k_scale[si];
          reinterpret_cast<float*>(smem + L::Vs)[st * kTS + j] = p.v_scale[si];
        }
      }
      row = unit_row(it + 1);  // the next tile's pool rows, loading meanwhile
      mbar_arrive(&full[st]);
    }
  } else {
    // ------------------------------------------------------------------- consumers
    const int g = lane / 4, t = lane % 4;
    bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
    bf16* ph = reinterpret_cast<bf16*>(smem + L::Ph);
    bf16* pl = reinterpret_cast<bf16*>(smem + L::Pl);
    // q rows r = t·G + g of this kv head (zero past R), 8 elements a copy.
    for (int i = threadIdx.x; i < L::RP * (HD / 8); i += kCThreads) {
      const int r = i / (HD / 8), d = 8 * (i % (HD / 8));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < R) {
        const int tq = r / G, gq = r % G;
        v = *reinterpret_cast<const uint4*>(
            p.q + ((static_cast<size_t>(b) * p.T + tq) * p.H + h * G + gq) * HD + d);
      }
      *reinterpret_cast<uint4*>(qs + r * L::QLD + d) = v;
    }
    // The thread's query rows: r = 8n + 2t + e of its n-tiles.
    int qpos[NR][2];
    bool live[NR][2];
    float m[NR][2], l[NR][2];
#pragma unroll
    for (int n = 0; n < NR; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * n + 2 * t + e;
        live[n][e] = r < R;
        qpos[n][e] = pos0 + r / G;
        m[n][e] = kNegInf;
        l[n][e] = 0.f;
      }
    }
    float o[MT][NR][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][n][c] = 0.f;
    named_sync(1, kCThreads);  // q is in place

    for (int it = 0; it < my_n; ++it) {
      const int st = it % kPStages, tile0 = (tile_base + it) * kTS;
      mbar_wait(&full[st], (it / kPStages) & 1);
      const unsigned char* kt = smem + L::Kt + st * L::TB;
      const unsigned char* vt = smem + L::Vt + st * L::TB;
      const uint8_t* ok = smem + L::Ok + st * kTS;

      // Sᵀ for slots 16w .. 16w + 15: element (n, c) is slot 16w + g + 8 (c >> 1), row
      // 8n + 2t + (c & 1).
      float s[NR][4];
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        k_frag<KV, L>(a, kt, 16 * warp, 16 * kk);
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          const bf16* qr = qs + (8 * n + g) * L::QLD + 16 * kk + 2 * t;
          mma16816(s[n], a, *reinterpret_cast<const uint32_t*>(qr),
                   *reinterpret_cast<const uint32_t*>(qr + 8));
        }
      }
      // Scale, cap and mask; the tile's max of each row over this warp's slots.
      float mx[NR][2];
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        mx[n][0] = mx[n][1] = kNegInf;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 16 * warp + g + 8 * (c >> 1), slot = tile0 + j, e = c & 1;
          bool vis = live[n][e] && ok[j] != 0 && slot <= qpos[n][e];
          if (p.window > 0) vis = vis && slot > qpos[n][e] - p.window;
          float v = s[n][c] * p.sm_scale;
          if constexpr (L::kI8) v *= reinterpret_cast<const float*>(smem + L::Ks)[st * kTS + j];
          if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
          s[n][c] = vis ? v : kNegInf;
          mx[n][e] = fmaxf(mx[n][e], s[n][c]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o2 = 4; o2 < 32; o2 <<= 1)
            mx[n][e] = fmaxf(mx[n][e], __shfl_xor_sync(0xffffffffu, mx[n][e], o2));
          if (g == 0) red[warp * L::RP + 8 * n + 2 * t + e] = mx[n][e];
        }
      }
      named_sync(1, kCThreads);
      // The new max of each row, p (zero where masked) and its sum over this warp's slots;
      // p goes to shared memory as the PV product's B: rounded to bf16 for bf16 pools
      // (p.astype(v.dtype)), or times the slot's V scale as a bf16 pair hi + lo for int8
      // pools (the reference keeps p and the dequantized V in fp32).
      float alpha[NR][2];
#pragma unroll
      for (int n = 0; n < NR; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m_new = m[n][e];
#pragma unroll
          for (int w = 0; w < kCWarps; ++w)
            m_new = fmaxf(m_new, red[w * L::RP + 8 * n + 2 * t + e]);
          alpha[n][e] = expf(m[n][e] - m_new);
          m[n][e] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 16 * warp + g + 8 * (c >> 1), e = c & 1, r = 8 * n + 2 * t + e;
          const float pv = s[n][c] > kNegInf ? expf(s[n][c] - m[n][e]) : 0.f;
          sum[e] += pv;
          if constexpr (L::kI8) {
            const float pw = pv * reinterpret_cast<const float*>(smem + L::Vs)[st * kTS + j];
            const bf16 hi = __float2bfloat16(pw);
            ph[r * L::PLD + j] = hi;
            pl[r * L::PLD + j] = __float2bfloat16(pw - __bfloat162float(hi));
          } else {
            ph[r * L::PLD + j] = __float2bfloat16(pv);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o2 = 4; o2 < 32; o2 <<= 1)
            sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], o2);
          if (g == 0) red[(kCWarps + warp) * L::RP + 8 * n + 2 * t + e] = sum[e];
        }
      }
      named_sync(1, kCThreads);
#pragma unroll
      for (int n = 0; n < NR; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kCWarps; ++w) sum += red[(kCWarps + w) * L::RP + 8 * n + 2 * t + e];
          l[n][e] = l[n][e] * alpha[n][e] + sum;
        }
      }
      // Oᵀ += Vᵀ·Pᵀ for this warp's head dims.
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int d0 = 16 * (warp * MT + i);
        if (d0 >= HD) break;
#pragma unroll
        for (int n = 0; n < NR; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][n][c] *= alpha[n][c & 1];
#pragma unroll
        for (int kk = 0; kk < kTS / 16; ++kk) {
          uint32_t a[4];
          vt_frag<KV, L>(a, vt, d0, 16 * kk);
#pragma unroll
          for (int n = 0; n < NR; ++n) {
            const int pi = (8 * n + g) * L::PLD + 16 * kk + 2 * t;
            mma16816(o[i][n], a, *reinterpret_cast<const uint32_t*>(ph + pi),
                     *reinterpret_cast<const uint32_t*>(ph + pi + 8));
            if constexpr (L::kI8) {
              mma16816(o[i][n], a, *reinterpret_cast<const uint32_t*>(pl + pi),
                       *reinterpret_cast<const uint32_t*>(pl + pi + 8));
            }
          }
        }
      }
      mbar_arrive(&empty[st]);
    }

    // The block's (m, l) and unnormalised output go over the ring once every consumer
    // is done with it (and every copy has landed).
    named_sync(1, kCThreads);
    float* acc = reinterpret_cast<float*>(smem + L::Acc);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int d0 = 16 * (warp * MT + i);
      if (d0 >= HD) break;
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[(8 * n + 2 * t + (c & 1)) * HD + d0 + g + 8 * (c >> 1)] = o[i][n][c];
    }
    if (warp == 0 && g == 0) {
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ml[2 * (8 * n + 2 * t + e)] = m[n][e];
          ml[2 * (8 * n + 2 * t + e) + 1] = l[n][e];
        }
    }
  }

  // Merge: block z owns every cs-th pair of output elements and sums them over the
  // blocks that had tiles, in rank order, each rescaled to the common max; every block's
  // loads are in flight at once.
  cluster_sync();
  const float* acc = reinterpret_cast<const float*>(smem + L::Acc);
  for (int i = z + cs * static_cast<int>(threadIdx.x); i < R * (HD / 2); i += cs * kPBlock) {
    const int r = i / (HD / 2), d = 2 * (i % (HD / 2));
    float2 mlv[kMaxCluster], ov[kMaxCluster];
#pragma unroll
    for (int y = 0; y < kMaxCluster; ++y) {
      if (y < n_active) {
        mlv[y] = ld_peer_f2(peer_addr(ml + 2 * r, y));
        ov[y] = ld_peer_f2(peer_addr(acc + r * HD + d, y));
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int y = 0; y < kMaxCluster; ++y)
      if (y < n_active) mm = fmaxf(mm, mlv[y].x);
    float lsum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int y = 0; y < kMaxCluster; ++y) {
      if (y < n_active) {
        const float w = expf(mlv[y].x - mm);
        lsum += mlv[y].y * w;
        o0 += ov[y].x * w;
        o1 += ov[y].y * w;
      }
    }
    const float l_safe = lsum == 0.f ? 1.f : lsum;  // a row that sees no key gives zeros
    const int tq = r / G, gq = r % G;
    *reinterpret_cast<uint32_t*>(
        p.out + ((static_cast<size_t>(b) * p.T + tq) * p.H + h * G + gq) * HD + d) =
        pack_bf16(o0 / l_safe, o1 / l_safe);
  }
  cluster_sync();  // no block leaves while a peer may still read its partials
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

// A 3-D TMA map over one pool plane [P·ps rows, K heads, HD] in boxes of one head × u
// rows (u = min(ps, kTS), one page or a kTS-slot part of one) × one column block, in the
// CBB-byte swizzle.
template <typename KV, int HD>
bool pool_map(CUtensorMap* map, const void* pool, int P, int ps, int K) {
  using L = PagedSmem<KV, HD, 1>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr int elem = static_cast<int>(sizeof(KV));
  const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(P) * static_cast<cuuint64_t>(ps)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * elem,
                                 static_cast<cuuint64_t>(K) * HD * elem};
  const cuuint32_t box[3] = {L::CBB / elem, 1, static_cast<cuuint32_t>(ps < kTS ? ps : kTS)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = L::CBB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::CBB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(pool), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KV, int HD, int NR>
cudaError_t launch_cluster(const PagedParams& p, const void* k_pool, const void* v_pool,
                           int B, int cs, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  auto kernel = paged_attention_cluster_kernel<KV, HD, NR>;
  constexpr int smem = PagedSmem<KV, HD, NR>::bytes;
  static bool attr_set[kMaxDevices] = {};  // the attribute is per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  CUtensorMap tk, tv;
  if (!pool_map<KV, HD>(&tk, k_pool, p.P, p.ps, p.K) ||
      !pool_map<KV, HD>(&tv, v_pool, p.P, p.ps, p.K))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, p.K, B);
  cfg.blockDim = dim3(kPBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p, tk, tv);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Query rows R = T·H/K in n-tiles of 8: at most 64 rows (32 at hd 256, where 64 rows'
// output accumulators would pass the registers a thread has).
__host__ __device__ constexpr int max_rows(int hd) { return hd == 256 ? 32 : 64; }

template <typename KV, int HD>
cudaError_t launch_cluster_rows(int R, const PagedParams& p, const void* k_pool,
                                const void* v_pool, int B, int cs, cudaStream_t stream) {
  if (R <= 8) return launch_cluster<KV, HD, 1>(p, k_pool, v_pool, B, cs, stream);
  if (R <= 16) return launch_cluster<KV, HD, 2>(p, k_pool, v_pool, B, cs, stream);
  if (R <= 32) return launch_cluster<KV, HD, 4>(p, k_pool, v_pool, B, cs, stream);
  if constexpr (max_rows(HD) >= 64) {
    if (R <= 64) return launch_cluster<KV, HD, 8>(p, k_pool, v_pool, B, cs, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The partial + combine pair: key slots one partial block takes for this head dim and
// pool type (0 if unsupported); the wrapper sizes the scratch with S = ceil(MP*ps / chunk)
// chunks per lane.
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

// The pair: dynamic shared memory of one partial block (the wrapper checks it against
// the card).
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

// Launch on `stream`; returns cudaGetLastError() (0 on success). q_dtype is kF32 or
// kBF16; kv_dtype is q_dtype or kI8 (then k_scale/v_scale are fp32 scale pages).
// - cluster > 0 (bf16 q): one launch of paged_attention_cluster_kernel in clusters of
//   `cluster` blocks (at most 8; the plan is ops/paged_attention.py::paged_plan's); needs
//   R = T*H/K <= 64 (<= 32 at hd 256), ps a power of two >= 8 and pools and q 16-byte
//   aligned; part_acc and part_ml are unused (null).
// - cluster == 0: the partial and combine kernels (fp32 q, and bf16 q on the shapes the
//   cluster kernel does not take); needs the pools 16-byte aligned (16-byte cp.async
//   copies); part_acc holds B*K*S*R*hd floats and part_ml B*K*S*R*2,
//   S = ceil(MP*ps / paged_attention_chunk(hd, kv_dtype)).
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale, const void* tables,
                           const void* positions, const void* valid, void* part_acc,
                           void* part_ml, void* out, int B, int T, int H, int K, int hd,
                           int P, int ps, int MP, int C, float sm_scale, int window,
                           float softcap, int q_dtype, int kv_dtype, int cluster,
                           void* stream) {
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    const int R = T * (K > 0 ? H / K : 0);
    if (q_dtype != kBF16 || cluster > kMaxCluster || K <= 0 || H % K != 0 || R <= 0 ||
        ps < 8 || (ps & (ps - 1)) != 0 || P <= 0 ||
        (kv_dtype != kBF16 && kv_dtype != kI8) ||
        (kv_dtype == kI8 && (k_scale == nullptr || v_scale == nullptr))) {
      return cudaErrorInvalidValue;
    }
    PagedParams p{};
    p.q = static_cast<const bf16*>(q);
    p.k_scale = static_cast<const float*>(k_scale);
    p.v_scale = static_cast<const float*>(v_scale);
    p.tables = static_cast<const int32_t*>(tables);
    p.positions = static_cast<const int32_t*>(positions);
    p.valid = static_cast<const uint8_t*>(valid);
    p.out = static_cast<bf16*>(out);
    p.T = T;
    p.H = H;
    p.K = K;
    p.P = P;
    p.ps = ps;
    p.MP = MP;
    p.C = C;
    p.sm_scale = sm_scale;
    p.softcap = softcap;
    p.window = window;
    return with_head_dim(hd, [&](auto d) {
      constexpr int D = decltype(d)::value;
      return kv_dtype == kI8
                 ? launch_cluster_rows<int8_t, D>(R, p, k_pool, v_pool, B, cluster, s)
                 : launch_cluster_rows<bf16, D>(R, p, k_pool, v_pool, B, cluster, s);
    });
  }
  if (part_acc == nullptr || part_ml == nullptr) return cudaErrorInvalidValue;
  return with_types(q_dtype, kv_dtype, [&](auto qt, auto kvt) {
    return with_head_dim(hd, [&](auto d) {
      return launch<decltype(qt), decltype(kvt), decltype(d)::value>(
          q, k_pool, v_pool, k_scale, v_scale, tables, positions, valid, part_acc,
          part_ml, out, B, T, H, K, P, ps, MP, C, sm_scale, window, softcap, s);
    });
  });
}

}  // extern "C"

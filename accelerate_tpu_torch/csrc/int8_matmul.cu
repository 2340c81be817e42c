// int8 weight-only matmul for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel accelerate_tpu/ops/quantization.py::_int8_matmul_kernel (:153,
// pallas_call in _quant_matmul_pallas_int8 at :188). It computes the same function,
//   y[M, N] = ((x_fp32 @ q_fp32) * s).to(out)      x [M, K] bf16 or fp32,
//                                                  q [K, N] int8 codes, s [N] fp32,
// in the same order: the products summed in fp32 over the whole of K, the column scale
// applied once after the sum, one rounding to the output type (bf16 or fp32).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at the serving path's
// M = 8 (decode) and M = 64 (prefill) a weight byte feeds 2·M flops, below the ~295
// flop/byte ridge, so the kernel is bound by reading the int8 weight once. Three kernels:
//
// - int8_mm_cluster_kernel (bf16 x, N % 16 == 0, K % 8 == 0, 16-byte aligned tensors:
//   every serving shape). One launch per call. Swap-AB: the block computes yᵀ = qᵀ·xᵀ for
//   128 weight columns, so the columns fill wgmma's 64-row side (two m64 tiles) and the
//   tokens are wgmma's n (8, 16, 32 or 64): no tensor-core row is padding at M = 8. One
//   producer thread streams the weight in its [K, N] layout in place and x, both through
//   2-D TMA maps (128-byte swizzle, zero fill past the ends), into a 6- or 8-stage
//   mbarrier ring (about 64 KB of weight in flight per block); the consumer warpgroup
//   turns each int8 tile into bf16 A fragments in registers (exact, |q| <= 127: each
//   byte is placed into the mantissa of 2^23 + 128 + q and the bias subtracted) and
//   issues wgmma.mma_async with x as B from shared memory. A
//   thread's 32-bit shared-memory word holds one k row of four adjacent columns: rows
//   16w + g and 16w + g + 8 of tiles 0 and 1 are columns 32w + 4g + {0, 1, 2, 3}, so four
//   words give all eight of its A values per k step, and the swizzle keeps the reads
//   free of bank conflicts. K is split over the blocks of a thread block cluster (the
//   plan in ops/quantization.py::split_plan: at most 7 blocks, or up to 16, past the
//   portable size, where the weight has so few column tiles that 7 would leave SMs idle,
//   as at N = 1024): block z owns every splits-th group of four outputs of the tile,
//   each block stores its fp32 partial sums
//   of a group straight into the owner's shared memory (distributed shared memory, not
//   waited for), and after one cluster barrier each owner sums its groups in rank order
//   from its own shared memory, scales and rounds once. No workspace, no second kernel,
//   and a fixed sum order: a second call gives the same bits. A call with one K range
//   stores from registers.
// - int8_mm_bf16_kernel (bf16 x, other shapes, e.g. 130×200 @ 200×72): mma.sync with
//   bounds-checked element loads, K unsplit, one launch.
// - int8_mm_f32_kernel (fp32 x): plain fp32 fused multiply-adds on the CUDA cores (never
//   TF32); K split across blocks, each split's fp32 partials summed in split order by
//   int8_mm_combine_kernel in the same call.
// Nothing is allocated here and nothing syncs with the host: the caller passes the
// output (and, for the fp32 split, the partials' workspace), so a CUDA graph can capture
// every path.

#include <type_traits>

#include "hopper.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void store_out(void* y, size_t i, float v, int out_code) {
  if (out_code == kBF16) {
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(y)[i] = v;
  }
}

// Four outputs [col, col + 4) of `row` (when inside y: N % 16 == 0, so a group is whole or
// out): the sums v times the scales sc, rounded once.
__device__ __forceinline__ void store4(void* y, int row, int col, int M, int N, float4 v,
                                       float4 sc, int out_code) {
  if (row >= M || col >= N) return;
  const size_t o = static_cast<size_t>(row) * N + col;
  if (out_code == kBF16) {
    uint2 raw;
    raw.x = pack_bf16(v.x * sc.x, v.y * sc.y);
    raw.y = pack_bf16(v.z * sc.z, v.w * sc.w);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + o) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(y) + o) =
        make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
  }
}

// ---- bf16 cluster kernel (TMA + wgmma, split-K merged in the cluster) ----------------
constexpr int kCBN = 128;               // weight columns per block: two m64 wgmma tiles
constexpr int kCBK = 64;                // K rows per stage (x: 64 bf16, one 128-byte row)
constexpr int kCThreads = kWgThreads + 32;  // the consumer warpgroup + the producer warp
constexpr int kWTile = kCBK * kCBN;     // bytes of one weight stage
constexpr int kMaxCluster = 16;         // the non-portable cluster size (8 is portable)

template <int BM> struct ClusterSmem {  // offsets from a 1024-byte aligned base
  // Stages: 64 KB of weight in flight at 8-16 tokens; 32 KB at 32-64, where x's stages
  // and the receive buffer are larger, so that two blocks still fit an SM.
  static constexpr int NS = BM <= 16 ? 8 : 4;
  static constexpr int XB = BM * kCBK * 2;         // bytes of one x stage
  static constexpr int G = BM * (kCBN / 4);        // groups of four outputs of the tile
  static constexpr int W = 0;                       // NS weight tiles
  static constexpr int X = W + NS * kWTile;         // NS x tiles
  static constexpr int Rcv = X + NS * XB;           // the peers' partial sums (below)
  static constexpr int Bar = Rcv + (G + kMaxCluster) * 16;  // full[], empty[], scales'
  static constexpr int Sc = Bar + (2 * NS + 2) * 8; // the block's kCBN column scales
  static constexpr int used = Sc + kCBN * 4;
  static constexpr int bytes = used + 1024;
};

// d += A · B for the warpgroup, m64nNk16 (N = 8 · NJ), A (bf16) from registers in the
// mma.sync A-fragment layout, B (bf16) from shared memory K-major (no transpose).
template <int NJ> struct Wgmma;
template <> struct Wgmma<1> {
  __device__ __forceinline__ static void rs(float (&d)[1][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<2> {
  __device__ __forceinline__ static void rs(float (&d)[2][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<4> {
  __device__ __forceinline__ static void rs(float (&d)[4][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<8> {
  __device__ __forceinline__ static void rs(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
};

// Byte i of the int8 word w (q_i) as an exact fp32 value: 2^23 + 128 + q_i, less the bias.
__device__ __forceinline__ float code_f32(uint32_t w_biased, int i) {
  return __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7650 | i)) - 8388736.f;
}
// Two exact integers as a bf16 pair (lo in the low half): each is its fp32's high half.
__device__ __forceinline__ uint32_t pack_int_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Block (z, nt, mt) of cluster (·, nt, mt): weight columns [128 nt, +128), tokens
// [BM mt, +BM), K rows [z k_chunk, min(K, (z + 1) k_chunk)); z is the block's rank in its
// cluster of gridDim.x blocks.
template <int BM>
__global__ void __launch_bounds__(kCThreads)
int8_mm_cluster_kernel(const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_x, const float* __restrict__ s,
                       void* __restrict__ y, int M, int N, int K, int k_chunk, int out_code) {
  using L = ClusterSmem<BM>;
  constexpr int NJ = BM / 8, NS = L::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::Bar);
  uint64_t* empty = full + NS;
  uint64_t* scale_bar = empty + NS;
  float* scale = reinterpret_cast<float*>(smem + L::Sc);
  // Block z owns the groups of four outputs g ≡ z (mod splits); every block of the
  // cluster stores its partial sums of them in the owner's rcv[rank][g / splits].
  float4* rcv = reinterpret_cast<float4*>(smem + L::Rcv);

  const int z = cluster_rank(), splits = gridDim.x;
  const int n0 = blockIdx.y * kCBN, m0 = blockIdx.z * BM;
  const int k_begin = z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + kCBK - 1) / kCBK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == kWgThreads) {  // the producer: fetch the maps' descriptors early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgThreads);
    }
    mbar_init(scale_bar, 31);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per = (L::G + splits - 1) / splits;  // groups a block owns, at most
  if (warp == 4) {
    // ------------------------------------------------------------------- producer
    if (lane == 0) {
      // Launched as a programmatic dependent, the block may start before the kernels
      // ahead of it end, and any of them may have written the weight, x or the scales.
      // So before waiting for them it only asks L2 for its first weight stages (a hint,
      // which no read of this block can see stale); every load into the block follows
      // the wait.
      const int pre = min(nk, NS);
      for (int it = 0; it < pre; ++it) tma_prefetch2d(&tm_w, n0, k_begin + it * kCBK);
      griddep_wait();
      for (int it = 0; it < nk; ++it) {
        const int st = it % NS, k0 = k_begin + it * kCBK;
        mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
        mbar_arrive_tx(&full[st], kWTile + L::XB);
        tma_load2d(smem + L::W + st * kWTile, &tm_w, &full[st], n0, k0);
        tma_load2d(smem + L::X + st * L::XB, &tm_x, &full[st], k0, m0);
      }
    } else {  // the other lanes bring the block's scales in (N % 16 == 0)
      griddep_wait();
      for (int i = lane - 1; i < kCBN / 4; i += 31) {
        const int cg = n0 + 4 * i;
        *reinterpret_cast<float4*>(scale + 4 * i) =
            cg < N ? *reinterpret_cast<const float4*>(s + cg) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      mbar_arrive(scale_bar);
    }
    // Every load of this block is requested: the next kernel may start its own.
    griddep_launch_dependents();
  } else {
    // ------------------------------------------------------------------- consumers
    griddep_launch_dependents();  // the block's trigger waits for the producer's too
    const int g = lane / 4, t = lane % 4;
    const int col = 32 * warp + 4 * g;  // the thread's four weight columns (block-local)
    float acc[2][NJ][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][n][c] = 0.f;

    for (int it = 0; it < nk; ++it) {
      const int st = it % NS;
      mbar_wait(&full[st], (it / NS) & 1);
      const unsigned char* sw = smem + L::W + st * kWTile;
      const uint64_t dx = make_desc(smem + L::X + st * L::XB, 16, 1024, 1);
      uint32_t a[kCBK / 16][2][4];
#pragma unroll
      for (int ks = 0; ks < kCBK / 16; ++ks) {
        // k rows 2t, 2t + 1, 2t + 8, 2t + 9 of this 16-row step, four columns each.
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * ks + 2 * t + (i & 1) + 8 * (i >> 1);
          w[i] = *reinterpret_cast<const uint32_t*>(sw + swizzled<128>(r * kCBN + col)) ^
                 0x80808080u;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // row g + 8h of tile j: column col + 2j + h
            const int b = 2 * j + h;
            a[ks][j][h] = pack_int_bf16(code_f32(w[0], b), code_f32(w[1], b));
            a[ks][j][2 + h] = pack_int_bf16(code_f32(w[2], b), code_f32(w[3], b));
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kCBK / 16; ++ks) {
        Wgmma<NJ>::rs(acc[0], a[ks][0], dx + 2 * ks);
        Wgmma<NJ>::rs(acc[1], a[ks][1], dx + 2 * ks);
      }
      wgmma_commit_wait();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
#pragma unroll
      for (int ks = 0; ks < kCBK / 16; ++ks) fence_regs(a[ks]);
      mbar_arrive(&empty[st]);
    }

    // Accumulator (j, n, c) is token 8n + 2t + (c & 1), column col + 2j + (c >> 1).
    mbar_wait(scale_bar, 0);
    if (splits == 1) {  // K is whole here: scale and round straight from the registers
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          store4(y, m0 + 8 * n + 2 * t + e, n0 + col, M, N,
                 make_float4(acc[0][n][e], acc[0][n][2 + e], acc[1][n][e], acc[1][n][2 + e]),
                 *reinterpret_cast<const float4*>(scale + col), out_code);
        }
      }
      return;
    }
    // Each group of four goes to its owner's receive buffer (a store to a peer's shared
    // memory, not waited for).
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = (8 * n + 2 * t + e) * (kCBN / 4) + col / 4;
        st_peer_f4(peer_addr(rcv + z * per + g / splits, g % splits),
                   make_float4(acc[0][n][e], acc[0][n][2 + e], acc[1][n][e], acc[1][n][2 + e]));
      }
    }
  }
  if (splits == 1) return;

  // Every block's partials are in their owners' buffers; block z sums its groups over
  // the cluster's blocks in rank order, from its own shared memory, scales and rounds
  // once. No block touches a peer's shared memory after this barrier.
  cluster_sync();
  for (int i = threadIdx.x; i < per; i += kCThreads) {
    const int g = z + splits * i;
    const int m = g / (kCBN / 4), c = 4 * (g % (kCBN / 4));
    if (g >= L::G || m0 + m >= M || n0 + c >= N) continue;
    float4 v = rcv[i];
    for (int r = 1; r < splits; ++r) {
      const float4 p = rcv[r * per + i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    store4(y, m0 + m, n0 + c, M, N, v, *reinterpret_cast<const float4*>(scale + c), out_code);
  }
}

// ---- bf16 kernel for other shapes (mma.sync, bounds-checked loads) -------------------
constexpr int kThreads = 128;                   // 4 warps, 32 columns each
constexpr int kBN = 128;                        // block columns (bytes of a weight row)
constexpr int kBK = 64;                         // K rows per step
constexpr int kWStage = kBK * kBN;              // bytes of one step's weight rows

__host__ __device__ constexpr int x_stage_bytes(int bm) { return bm * kBK * 2; }
__host__ __device__ constexpr int bf16_smem_bytes(int bm) { return kWStage + x_stage_bytes(bm); }

// Byte offset of weight byte (row r, column c) in a stage: 16-byte chunk c/16 of row r
// sits at chunk (c/16) ^ (2 * ((r / 4) % 4)).
__device__ __forceinline__ int w_off(int r, int c) {
  return r * kBN + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15);
}
// Byte offset of x element (row r, k) in a stage (rows of kBK bf16 = 128 bytes): chunk
// c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ int x_off(int r, int k) {
  const int b = k * 2;
  return r * (kBK * 2) + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}

// One block: rows [m0, m0 + 16·MT), columns [n0, n0 + 128), all of K, element loads with
// bounds checks. The tensor-core mapping: within each 16-row step of K the mma's k slots
// {2t, 2t+1, 2t+8, 2t+9} take rows {4t .. 4t+3} (x takes the same permutation, so the
// sum is unchanged), and the mma's column g of n-tile j is column 4g + j of the warp's
// 32, so one word holds a thread's bytes for four n-tiles.
template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ s, void* __restrict__ y, int M, int N, int K,
                    int out_code) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sw = smem;
  unsigned char* sx = smem + kWStage;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int nk = (K + kBK - 1) / kBK;

  auto load_step = [&](int k0) {
    for (int i = tid; i < kWStage; i += kThreads) {
      const int r = i / kBN, c = i % kBN, k = k0 + r, col = n0 + c;
      sw[w_off(r, c)] = (k < K && col < N)
                            ? static_cast<unsigned char>(q[static_cast<size_t>(k) * N + col])
                            : 0;
    }
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK, row = m0 + r, k = k0 + kk;
      *reinterpret_cast<__nv_bfloat16*>(sx + x_off(r, kk)) =
          (row < M && k < K) ? x[static_cast<size_t>(row) * K + k] : __float2bfloat16(0.f);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  for (int it = 0; it < nk; ++it) {
    __syncthreads();  // every warp is done with the previous step's rows
    load_step(it * kBK);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // Weight: rows ks·16 + 4t + i (i = 0..3) of columns warp·32 + 4g .. + 3; byte j
      // of word i is k slot {2t, 2t+1, 2t+8, 2t+9}[i] of n-tile j's column g.
      uint32_t b[4][2];
      float f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            sw + w_off(ks * 16 + 4 * t + i, warp * 32 + 4 * g));
        const uint32_t u = w ^ 0x80808080u;  // byte j = q_j + 128
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] = code_f32(u, j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // exact integers: bf16 = the fp32's high half
        b[j][0] = pack_int_bf16(f[0][j], f[1][j]);
        b[j][1] = pack_int_bf16(f[2][j], f[3][j]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // x: elements ks·16 + 4t .. + 3 of rows g and g + 8 (the same k permutation).
        const uint2 lo = *reinterpret_cast<const uint2*>(sx + x_off(mt * 16 + g, ks * 16 + 4 * t));
        const uint2 hi =
            *reinterpret_cast<const uint2*>(sx + x_off(mt * 16 + g + 8, ks * 16 + 4 * t));
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
  }

  // Accumulator (n-tile j, element e) of row g (+8) is column warp·32 + 8t + 4e + j.
  const int col = n0 + warp * 32 + 8 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mt * 16 + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col + 4 * e + j;
          if (c < N) {
            store_out(y, static_cast<size_t>(row) * N + c, acc[mt][j][2 * half + e] * s[c],
                      out_code);
          }
        }
      }
    }
  }
}

// ---- fp32 kernel (CUDA cores) --------------------------------------------------------
constexpr int kFThreads = 256;
constexpr int kFBM = 32, kFBN = 64, kFBK = 32;  // each thread: 2 rows × 4 columns

__global__ void __launch_bounds__(kFThreads)
int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, void* __restrict__ y, float* __restrict__ part,
                   int M, int N, int K, int k_chunk, int out_code) {
  __shared__ float xs[kFBK][kFBM + 1];
  __shared__ __align__(16) float wsm[kFBK][kFBN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * kFBN, m0 = blockIdx.y * kFBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  if (part != nullptr) part += static_cast<size_t>(blockIdx.z) * M * N;
  float acc[2][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kFBK) {
    for (int i = tid; i < kFBM * kFBK; i += kFThreads) {
      const int r = i / kFBK, kk = i % kFBK, row = m0 + r, k = k0 + kk;
      xs[kk][r] = (row < M && k < k_end) ? x[static_cast<size_t>(row) * K + k] : 0.f;
    }
    for (int i = tid; i < kFBK * kFBN; i += kFThreads) {
      const int r = i / kFBN, c = i % kFBN, k = k0 + r, col = n0 + c;
      wsm[r][c] = (k < k_end && col < N) ? static_cast<float>(q[static_cast<size_t>(k) * N + col])
                                         : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFBK; ++kk) {
      const float a0 = xs[kk][2 * ty], a1 = xs[kk][2 * ty + 1];
      const float4 w = *reinterpret_cast<const float4*>(&wsm[kk][4 * tx]);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[0][c] = fmaf(a0, wv[c], acc[0][c]);
        acc[1][c] = fmaf(a1, wv[c], acc[1][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 2 * ty + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + 4 * tx + c;
      if (col >= N) continue;
      const size_t i = static_cast<size_t>(row) * N + col;
      if (part != nullptr) {
        part[i] = acc[r][c];
      } else {
        store_out(y, i, acc[r][c] * s[col], out_code);
      }
    }
  }
}

// ---- split-K combine (fp32 x) --------------------------------------------------------
// y = (sum over splits z = 0, 1, ... of part[z]) * s, rounded once.
__global__ void int8_mm_combine_kernel(const float* __restrict__ part, const float* __restrict__ s,
                                       void* __restrict__ y, int M, int N, int splits,
                                       int out_code) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += part[static_cast<size_t>(z) * total + i];
    store_out(y, i, acc * s[i % N], out_code);
  }
}

// ---- launches --------------------------------------------------------------------------
// Set a kernel's dynamic shared memory limit once per device (the attributes are per
// device), and with `non_portable` allow clusters past the portable 8 blocks.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int smem, bool (&done)[kMaxDevices],
                          bool non_portable = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && non_portable)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// The 2-D TMA maps of the cluster kernel: the int8 weight [K, N] in boxes of 64 rows ×
// 128 columns, and x [M, K] bf16 in boxes of BM rows × 64 columns, both in the 128-byte
// swizzle; reads past the ends give zeros. The weight's L2 promotion is its row of 128
// bytes (256 read more than the box needs and measured slower).
bool cluster_maps(CUtensorMap* tw, CUtensorMap* tx, const void* x, const void* q, int M, int N,
                  int K, int bm) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t w_box[2] = {kCBN, kCBK};
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t x_box[2] = {kCBK, static_cast<cuuint32_t>(bm)};
  return encode(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), w_dims, w_strides,
                w_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS &&
         encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dims, x_strides,
                x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

// The cluster kernel's launch: a cluster of `splits` blocks along x, launched as a
// programmatic dependent of the kernel before it, so that its set-up and the L2 prefetch
// of its first weight stages may overlap that kernel's end (every load into the block
// waits for it).
cudaLaunchConfig_t cluster_config(int bm, int splits, int M, int N, cudaStream_t stream,
                                  cudaLaunchAttribute (&attr)[2], int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kCBN - 1) / kCBN, (M + bm - 1) / bm);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

template <int BM>
cudaError_t launch_cluster(const void* x, const void* q, const float* s, void* y, int M, int N,
                           int K, int k_chunk, int splits, int out_code, cudaStream_t stream) {
  auto kernel = int8_mm_cluster_kernel<BM>;
  constexpr int smem = ClusterSmem<BM>::bytes;
  static bool done[kMaxDevices] = {};
  cudaError_t err = set_smem_once(kernel, smem, done, true);
  if (err != cudaSuccess) return err;
  CUtensorMap tw, tx;
  if (!cluster_maps(&tw, &tx, x, q, M, N, K, BM)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = cluster_config(BM, splits, M, N, stream, attr, smem);
  err = cudaLaunchKernelEx(&cfg, kernel, tw, tx, s, y, M, N, K, k_chunk, out_code);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BM>
int max_active_clusters(int splits) {
  auto kernel = int8_mm_cluster_kernel<BM>;
  constexpr int smem = ClusterSmem<BM>::bytes;
  static bool done[kMaxDevices] = {};
  if (set_smem_once(kernel, smem, done, true) != cudaSuccess) return -1;
  cudaLaunchAttribute attr[2];
  // The grid's size does not enter the count: one cluster's worth of columns will do.
  const cudaLaunchConfig_t cfg = cluster_config(BM, splits, BM, kCBN, nullptr, attr, smem);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

template <typename F>
auto with_bm(int bm, F&& f) -> decltype(f(std::integral_constant<int, 8>{})) {
  switch (bm) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return decltype(f(std::integral_constant<int, 8>{}))(-1);
  }
}

template <int MT>
cudaError_t launch_bf16(const void* x, const void* q, const float* s, void* y, int M, int N,
                        int K, int out_code, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes(16 * MT);
  static bool done[kMaxDevices] = {};
  cudaError_t err = set_smem_once(int8_mm_bf16_kernel<MT>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * MT - 1) / (16 * MT));
  int8_mm_bf16_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), s, y, M, N, K,
      out_code);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [M, N] (out_code: 0 fp32, 1 bf16) = ((x [M, K] @ q [K, N] int8) * s [N]) on `stream`;
// the caller's plan (ops/quantization.py::split_plan) picks the kernel:
// - x_code 1 (bf16), vec = 1: the cluster kernel, `bm` tokens per block (8, 16, 32 or
//   64), K cut into `splits` ranges of `k_chunk` rows (a multiple of 64), one cluster of
//   `splits` blocks (at most 16) per output tile; `part` is unused. Needs N % 16 == 0,
//   K % 8 == 0 and x, q, s 16-byte aligned.
// - x_code 1, vec = 0: the bounds-checked bf16 kernel, `bm` rows per block (16, 32 or
//   64), splits = 1.
// - x_code 0 (fp32), bm = 32: the CUDA-core kernel; with splits > 1, `part` is an fp32
//   workspace [splits, M, N] and a combine kernel follows (k_chunk a multiple of 32).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a plan the kernels do not take).
int int8_matmul_launch(const void* x, const void* q, const float* s, void* y, float* part,
                       int M, int N, int K, int x_code, int out_code, int bm, int splits,
                       int k_chunk, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cluster = x_code == kBF16 && vec;
  const int tile_k = x_code == kBF16 ? kBK : kFBK;
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || k_chunk <= 0 || k_chunk % tile_k != 0 ||
      static_cast<long long>(splits) * k_chunk < K ||
      (splits > 1 && static_cast<long long>(splits - 1) * k_chunk >= K) ||
      (out_code != kF32 && out_code != kBF16)) {
    return cudaErrorInvalidValue;
  }
  if (cluster) {
    if (splits > kMaxCluster || K == 0 || N % 16 != 0 || K % 8 != 0) return cudaErrorInvalidValue;
    const int err = with_bm(bm, [&](auto b) {
      return static_cast<int>(
          launch_cluster<decltype(b)::value>(x, q, s, y, M, N, K, k_chunk, splits, out_code, st));
    });
    return err < 0 ? cudaErrorInvalidValue : err;
  }
  if (x_code == kBF16) {
    if (splits != 1) return cudaErrorInvalidValue;
    switch (bm) {
      case 16: return launch_bf16<1>(x, q, s, y, M, N, K, out_code, st);
      case 32: return launch_bf16<2>(x, q, s, y, M, N, K, out_code, st);
      case 64: return launch_bf16<4>(x, q, s, y, M, N, K, out_code, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (x_code != kF32 || bm != kFBM || (splits > 1 && part == nullptr)) return cudaErrorInvalidValue;
  float* p = splits > 1 ? part : nullptr;
  const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, splits);
  int8_mm_f32_kernel<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(x),
                                                 static_cast<const int8_t*>(q), s, y, p, M, N,
                                                 K, k_chunk, out_code);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  int8_mm_combine_kernel<<<blocks, 256, 0, st>>>(part, s, y, M, N, splits, out_code);
  return cudaGetLastError();
}

// How many clusters of `splits` blocks of the cluster kernel (`bm` tokens a block) the
// card holds at once (cudaOccupancyMaxActiveClusters); -1 on error.
int int8_matmul_max_active_clusters(int bm, int splits) {
  return with_bm(bm, [&](auto b) { return max_active_clusters<decltype(b)::value>(splits); });
}

}  // extern "C"

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
// flop/byte ridge, so the kernel is bound by reading the int8 weight once. What the
// design does about it:
// - The weight is read in its [K, N] layout in place, with 16-byte cp.async into a
//   4-stage shared-memory ring (N % 16 == 0; a bounds-checked path takes ragged shapes).
// - bf16 x: the int8 codes become bf16 in registers (exact, |q| <= 127: each byte is
//   placed into the mantissa of 2^23 + 128 + q and the bias subtracted) and the
//   products run on the tensor cores (mma.sync m16n8k16, fp32 accumulate). Mapping
//   tricks keep each thread's shared-memory reads to 32-bit words: within each 16-row
//   step of K the mma's k slots {2t, 2t+1, 2t+8, 2t+9} take rows {4t .. 4t+3} (x takes
//   the same permutation, so the sum is unchanged), and the mma's column g of n-tile j
//   is column 4g + j of the warp's 32, so one word holds a thread's bytes for four
//   n-tiles. An XOR swizzle of the 16-byte chunks keeps those reads free of bank
//   conflicts. x's rows past M are zero (M = 8 fills half of an m16 tile).
// - fp32 x: plain fp32 fused multiply-adds on the CUDA cores (never TF32).
// - 132 SMs at M <= 64: N = 1024 gives only 8 column tiles of 128, so K is split across
//   blocks (the caller's plan, ops/quantization.py::split_plan, about two blocks per
//   SM); each split writes fp32 partials and a second kernel in the same call sums them
//   in split order, then scales and rounds.
// Nothing is allocated here and nothing syncs with the host: the caller passes the
// output and the partials' workspace (torch's allocator), so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

// ---- bf16 tensor-core kernel ---------------------------------------------------------
constexpr int kThreads = 128;                   // 4 warps, 32 columns each
constexpr int kBN = 128;                        // block columns (bytes of a weight row)
constexpr int kBK = 64;                         // K rows per stage
constexpr int kStages = 4;
constexpr int kWStage = kBK * kBN;              // bytes of one weight stage
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int x_stage_bytes(int bm) { return bm * kBK * 2; }
__host__ __device__ constexpr int bf16_smem_bytes(int bm) {
  return kStages * (kWStage + x_stage_bytes(bm));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, zero-filled when !valid (src then only needs to be a pointer).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ void store_out(void* y, size_t i, float v, int out_code) {
  if (out_code == kBF16) {
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(y)[i] = v;
  }
}

// Eight consecutive columns [col, col + 8) of one row: scaled and rounded into y, or
// (part != nullptr) written unscaled as fp32 partials. VEC (N % 16 == 0, s 16-byte
// aligned): 16-byte accesses where the row holds all eight.
template <bool VEC>
__device__ __forceinline__ void store_row8(const float (&v)[8], int row, int col, int M, int N,
                                           const float* __restrict__ s, void* y, float* part,
                                           int out_code) {
  if (row >= M) return;
  const size_t base = static_cast<size_t>(row) * N + col;
  if (VEC && col + 8 <= N) {
    if (part != nullptr) {
      float4* p = reinterpret_cast<float4*>(part + base);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
      return;
    }
    const float4 s0 = *reinterpret_cast<const float4*>(s + col);
    const float4 s1 = *reinterpret_cast<const float4*>(s + col + 4);
    const float o[8] = {v[0] * s0.x, v[1] * s0.y, v[2] * s0.z, v[3] * s0.w,
                        v[4] * s1.x, v[5] * s1.y, v[6] * s1.z, v[7] * s1.w};
    if (out_code == kBF16) {
      uint4 raw;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(o[i]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(y) + base) = raw;
    } else {
      float4* p = reinterpret_cast<float4*>(static_cast<float*>(y) + base);
      p[0] = make_float4(o[0], o[1], o[2], o[3]);
      p[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (col + i >= N) break;
    if (part != nullptr) {
      part[base + i] = v[i];
    } else {
      store_out(y, base + i, v[i] * s[col + i], out_code);
    }
  }
}

// One block: rows [m0, m0 + 16·MT), columns [n0, n0 + 128), K rows [z·k_chunk,
// min(K, (z+1)·k_chunk)). VEC: 16-byte cp.async loads and 16-byte stores (N % 16 == 0,
// K % 8 == 0, x, q and s 16-byte aligned); otherwise element accesses with bounds checks.
template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ s, void* __restrict__ y, float* __restrict__ part,
                    int M, int N, int K, int k_chunk, int out_code) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sw_all = smem;
  unsigned char* sx_all = smem + kStages * kWStage;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (part != nullptr) part += static_cast<size_t>(blockIdx.z) * M * N;

  auto load_stage = [&](int stage, int k0) {
    unsigned char* sw = sw_all + stage * kWStage;
    unsigned char* sx = sx_all + stage * x_stage_bytes(BM);
    if constexpr (VEC) {
#pragma unroll
      for (int p = 0; p < kWStage / 16 / kThreads; ++p) {
        const int i = tid + p * kThreads, r = i >> 3, c = i & 7;
        const int k = k0 + r, col = n0 + c * 16;
        const bool ok = k < k_end && col < N;
        cp_async16(sw + w_off(r, c * 16), ok ? q + static_cast<size_t>(k) * N + col : q, ok);
      }
#pragma unroll
      for (int p = 0; p < MT; ++p) {  // BM rows × 8 chunks = 128·MT chunks
        const int i = tid + p * kThreads, r = i >> 3, c = i & 7;
        const int row = m0 + r, k = k0 + c * 8;
        const bool ok = row < M && k < k_end;
        cp_async16(sx + x_off(r, c * 8), ok ? x + static_cast<size_t>(row) * K + k : x, ok);
      }
    } else {
      for (int i = tid; i < kWStage; i += kThreads) {
        const int r = i / kBN, c = i % kBN, k = k0 + r, col = n0 + c;
        sw[w_off(r, c)] = (k < k_end && col < N)
                              ? static_cast<unsigned char>(q[static_cast<size_t>(k) * N + col])
                              : 0;
      }
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK, row = m0 + r, k = k0 + kk;
        *reinterpret_cast<__nv_bfloat16*>(sx + x_off(r, kk)) =
            (row < M && k < k_end) ? x[static_cast<size_t>(row) * K + k] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, k_begin + st * kBK);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it is in; every warp is done with stage it - 1
    const int nxt = it + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, k_begin + nxt * kBK);
    cp_async_commit();

    const unsigned char* sw = sw_all + (it % kStages) * kWStage;
    const unsigned char* sx = sx_all + (it % kStages) * x_stage_bytes(BM);
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
        for (int j = 0; j < 4; ++j) {
          f[i][j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | j)) - 8388736.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // exact integers: bf16 = the fp32's high half
        b[j][0] = __byte_perm(__float_as_uint(f[0][j]), __float_as_uint(f[1][j]), 0x7632);
        b[j][1] = __byte_perm(__float_as_uint(f[2][j]), __float_as_uint(f[3][j]), 0x7632);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // x: elements ks·16 + 4t .. + 3 of rows g and g + 8 (the same k permutation).
        const uint2 lo = *reinterpret_cast<const uint2*>(sx + x_off(mt * 16 + g, ks * 16 + 4 * t));
        const uint2 hi =
            *reinterpret_cast<const uint2*>(sx + x_off(mt * 16 + g + 8, ks * 16 + 4 * t));
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator (n-tile j, element e) of row g (+8) is column warp·32 + 8t + 4e + j:
  // a thread holds eight consecutive columns of each of its rows.
  const int col = n0 + warp * 32 + 8 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * half];
        v[4 + j] = acc[mt][j][2 * half + 1];
      }
      store_row8<VEC>(v, m0 + mt * 16 + g + 8 * half, col, M, N, s, y, part, out_code);
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

// ---- split-K combine -----------------------------------------------------------------
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

template <int MT, bool VEC>
cudaError_t launch_bf16(const void* x, const void* q, const float* s, void* y, float* part,
                        int M, int N, int K, int k_chunk, int splits, int out_code,
                        cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes(16 * MT);
  static bool attr_set[kMaxDevices] = {};  // the attribute is per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(int8_mm_bf16_kernel<MT, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * MT - 1) / (16 * MT), splits);
  int8_mm_bf16_kernel<MT, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), s, y, part, M, N, K,
      k_chunk, out_code);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_bf16_rows(int bm, const void* x, const void* q, const float* s, void* y,
                             float* part, int M, int N, int K, int k_chunk, int splits,
                             int out_code, cudaStream_t stream) {
  switch (bm) {
    case 16: return launch_bf16<1, VEC>(x, q, s, y, part, M, N, K, k_chunk, splits, out_code, stream);
    case 32: return launch_bf16<2, VEC>(x, q, s, y, part, M, N, K, k_chunk, splits, out_code, stream);
    case 64: return launch_bf16<4, VEC>(x, q, s, y, part, M, N, K, k_chunk, splits, out_code, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y [M, N] (out_code: 0 fp32, 1 bf16) = ((x [M, K] @ q [K, N] int8) * s [N]) on `stream`.
// x_code 1 (bf16) takes the tensor-core kernel with `bm` rows per block (16, 32 or 64)
// and `vec` = 1 for 16-byte loads; x_code 0 (fp32) the CUDA-core kernel (bm = 32). K is
// cut into `splits` ranges of `k_chunk` rows (a multiple of the kernel's K tile: 64
// bf16, 32 fp32); with splits > 1, `part` is an fp32 workspace [splits, M, N] and a
// combine kernel follows. Returns cudaGetLastError() (or cudaErrorInvalidValue for a
// plan the kernels do not take).
int int8_matmul_launch(const void* x, const void* q, const float* s, void* y, float* part,
                       int M, int N, int K, int x_code, int out_code, int bm, int splits,
                       int k_chunk, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile_k = x_code == kBF16 ? kBK : kFBK;
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || k_chunk <= 0 || k_chunk % tile_k != 0 ||
      static_cast<long long>(splits) * k_chunk < K ||
      (splits > 1 && static_cast<long long>(splits - 1) * k_chunk >= K) ||
      (splits > 1 && part == nullptr) || (out_code != kF32 && out_code != kBF16)) {
    return cudaErrorInvalidValue;
  }
  float* p = splits > 1 ? part : nullptr;
  cudaError_t err;
  if (x_code == kBF16) {
    err = vec ? launch_bf16_rows<true>(bm, x, q, s, y, p, M, N, K, k_chunk, splits, out_code, st)
              : launch_bf16_rows<false>(bm, x, q, s, y, p, M, N, K, k_chunk, splits, out_code, st);
  } else if (x_code == kF32 && bm == kFBM) {
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, splits);
    int8_mm_f32_kernel<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(x),
                                                   static_cast<const int8_t*>(q), s, y, p, M, N,
                                                   K, k_chunk, out_code);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  int8_mm_combine_kernel<<<blocks, 256, 0, st>>>(part, s, y, M, N, splits, out_code);
  return cudaGetLastError();
}

}  // extern "C"

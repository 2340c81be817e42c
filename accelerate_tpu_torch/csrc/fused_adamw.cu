// Fused AdamW for Hopper (sm_90a), CUDA C++ with a plain C entry point. Built with
// --fmad=false (ops/_build.py): every multiply and add rounds on its own, in the order
// written, as the plain PyTorch version's separate operations do.
//
// Replaces the TPU kernel accelerate_tpu/ops/fused_optim.py::_adamw_kernel (:101,
// pallas_call in _leaf_fused at :179). It computes the same function, one element at a
// time, with the expression order of optax.adamw:
//   g  = g * grad_scale
//   m' = (1 - b1) * g + b1 * m          (b1 * m rounded to bf16 first for bf16 moments,
//                                        as the product of a bf16 array is in JAX)
//   v' = (1 - b2) * (g * g) + b2 * v
//   p' = p - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p)
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t. grad_scale, lr, bc1 and bc2 are read from a
// device array [4] written by the caller each step, so neither a clip factor computed
// on the card nor a changed learning rate needs a host sync or a rebuild.
//
// Design. The TPU kernel runs one pallas_call per leaf, a grid over [rows, 1024]
// blocks. Here one launch covers every leaf (multi-tensor): the caller passes a device
// table of (p, m, v, g, n, first block) per leaf, each block takes 4096 elements of one
// leaf (found by a binary search over the first-block column), and each thread moves
// 16-byte vectors. Leaves are multiples of 1024 elements, as the JAX layout requires.
//
// Bound on this card (H100 SXM, 3.35 TB/s): AdamW does ~15 flops per 28 bytes
// (p, m, v, g read in fp32; p, m, v written), so it is bound by those bytes: 28 B per
// parameter with fp32 moments, 26 B with a bf16 first moment. What the design does
// about it: each byte is read and written once, with coalesced 16-byte accesses, in
// one launch for the whole tree.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                              // fp32 elements per 16 bytes
constexpr int kIters = 4;
constexpr int kPerBlock = kThreads * kVec * kIters;  // 4096 elements
constexpr int kCols = 6;                             // table columns per leaf

enum DType { kF32 = 0, kBF16 = 1 };

struct Consts {
  float b1_m;          // b1 in the first moment's type (bf16-rounded for bf16 moments)
  float one_minus_b1;  // fp32(1 - b1)
  float b2, one_minus_b2, eps, wd;
};

template <typename M> struct Moment;
template <> struct Moment<float> {
  __device__ __forceinline__ static void load(const float* m, float (&f)[kVec]) {
    const float4 x = *reinterpret_cast<const float4*>(m);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* m, const float (&f)[kVec]) {
    *reinterpret_cast<float4*>(m) = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ __forceinline__ static float decay(float b1_m, float m) { return b1_m * m; }
};
template <> struct Moment<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* m, float (&f)[kVec]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(m);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) f[i] = __bfloat162float(e[i]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* m, const float (&f)[kVec]) {
    uint2 raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) e[i] = __float2bfloat16(f[i]);
    *reinterpret_cast<uint2*>(m) = raw;
  }
  __device__ __forceinline__ static float decay(float b1_m, float m) {
    return __bfloat162float(__float2bfloat16(b1_m * m));
  }
};

template <typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const int64_t* __restrict__ table, int n_leaves,
                 const float* __restrict__ scalars, Consts c) {
  const int64_t blk = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {  // last leaf whose first block is <= blk
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * kCols + 5] <= blk) lo = mid; else hi = mid - 1;
  }
  const int64_t* e = table + lo * kCols;
  float* p = reinterpret_cast<float*>(e[0]);
  M* m = reinterpret_cast<M*>(e[1]);
  float* v = reinterpret_cast<float*>(e[2]);
  const float* g = reinterpret_cast<const float*>(e[3]);
  const int64_t n = e[4];
  const float gscale = scalars[0], lr = scalars[1], bc1 = scalars[2], bc2 = scalars[3];
  const int64_t start = (blk - e[5]) * kPerBlock;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int64_t i = start + (static_cast<int64_t>(it) * kThreads + threadIdx.x) * kVec;
    if (i >= n) break;  // n is a multiple of 1024, so i + 3 < n here
    const float4 p4 = *reinterpret_cast<const float4*>(p + i);
    const float4 v4 = *reinterpret_cast<const float4*>(v + i);
    const float4 g4 = *reinterpret_cast<const float4*>(g + i);
    float pf[kVec] = {p4.x, p4.y, p4.z, p4.w};
    float vf[kVec] = {v4.x, v4.y, v4.z, v4.w};
    const float gf[kVec] = {g4.x, g4.y, g4.z, g4.w};
    float mf[kVec];
    Moment<M>::load(m + i, mf);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float gk = gf[k] * gscale;
      const float m_new = c.one_minus_b1 * gk + Moment<M>::decay(c.b1_m, mf[k]);
      const float v_new = c.one_minus_b2 * (gk * gk) + c.b2 * vf[k];
      const float mhat = m_new / bc1;
      const float vhat = v_new / bc2;
      const float update = mhat / (sqrtf(vhat) + c.eps) + c.wd * pf[k];
      pf[k] = pf[k] - lr * update;
      mf[k] = m_new;
      vf[k] = v_new;
    }
    *reinterpret_cast<float4*>(p + i) = make_float4(pf[0], pf[1], pf[2], pf[3]);
    *reinterpret_cast<float4*>(v + i) = make_float4(vf[0], vf[1], vf[2], vf[3]);
    Moment<M>::store(m + i, mf);
  }
}

}  // namespace

extern "C" {

// Elements one block updates; the caller numbers each leaf's first block with it.
int fused_adamw_block_elems() { return kPerBlock; }

// Update every leaf of `table` (int64 [n_leaves, 6] on the device: p, m, v, g pointers,
// element count n, first block) in place, on `stream`; n_blocks is the table's total.
// p, v and g are fp32; m is fp32 (m_dtype 0) or bf16 (1). scalars: fp32 [4] on the
// device = [grad_scale, lr, 1 - b1^t, 1 - b2^t]. Returns cudaGetLastError().
int fused_adamw_launch(const int64_t* table, int n_leaves, int64_t n_blocks,
                       const float* scalars, float b1_m, float one_minus_b1, float b2,
                       float one_minus_b2, float eps, float wd, int m_dtype, void* stream) {
  if (n_leaves == 0 || n_blocks == 0) return cudaSuccess;
  const Consts c{b1_m, one_minus_b1, b2, one_minus_b2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_dtype == kF32) {
    adamw_kernel<float><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
        table, n_leaves, scalars, c);
  } else if (m_dtype == kBF16) {
    adamw_kernel<__nv_bfloat16><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
        table, n_leaves, scalars, c);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"

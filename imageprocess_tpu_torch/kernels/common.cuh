// Device helpers shared by the per-ROI statistics kernels
// (tilestats_u16.cu, roistats_f32.cu): the int32 np.percentile position
// arithmetic and the block-wide reductions of a 512-thread CTA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ip {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 6;  // (p_lo, median, p_hi) x (k, k+1)

// exact_quantile_pos of ops/percentile.py: k = floor((n-1)*p1000/100000)
// and g = rem / 100000.0f, every intermediate below 2^31.
__device__ __forceinline__ void quantile_pos(int n, int p1000, int* k,
                                             float* g) {
  const int nm1 = n - 1 > 0 ? n - 1 : 0;
  const int q = nm1 / 100000;
  const int r = nm1 % 100000;
  const int r1 = r / 1000;
  const int r0 = r % 1000;
  const int b = r0 * p1000;
  const int c = r1 * p1000 + b / 1000;
  *k = q * p1000 + c / 100;
  const int rem = (c % 100) * 1000 + b % 1000;
  *g = __fdiv_rn(static_cast<float>(rem), 100000.0f);
}

// The six clipped order-statistic positions of (p_lo, median, p_hi):
// ks[0..2] = k, ks[3..5] = k + 1, all in [0, n - 1]; gs = the weights.
__device__ __forceinline__ void quantile_positions(int n, int p_lo1000,
                                                   int p_hi1000, int (&ks)[kQ],
                                                   float (&gs)[3]) {
  const int nm1 = n - 1 > 0 ? n - 1 : 0;
  const int ps[3] = {p_lo1000, 50000, p_hi1000};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int k;
    quantile_pos(n, ps[q], &k, &gs[q]);
    ks[q] = min(max(k, 0), nm1);
    ks[q + 3] = min(max(min(k + 1, nm1), 0), nm1);
  }
}

// Block-wide reductions: warp shuffles, then one partial per warp in shared
// memory that every thread combines itself (so all threads hold the same
// result).  The trailing barrier lets the scratch be reused at once.
template <int K>
__device__ __forceinline__ void block_sum_int(int (&v)[K], int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) scratch[warp * K + q] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * K + q];
    v[q] = s;
  }
  __syncthreads();
}

enum class Op { kSum, kMin, kMax };

template <Op op>
__device__ __forceinline__ float combine(float a, float b) {
  if (op == Op::kSum) return __fadd_rn(a, b);
  if (op == Op::kMin) return fminf(a, b);
  return fmaxf(a, b);
}

template <Op op>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = combine<op>(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = combine<op>(r, scratch[w]);
  __syncthreads();
  return r;
}

// The card's opt-in limit of shared memory per block, or -1 on error.
inline long long smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

}  // namespace ip

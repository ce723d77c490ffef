// Per-ROI statistics of raw u16 tiles, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel imageprocess_tpu/ops/pallas_tilestats.py::_kernel
// (wrapper batched_order_stats_pallas) and the XLA moments around it
// (ops/tilestats_u16.py::tile_stats_u16): one launch produces the whole
// packed (B, 10, C, N) result of the batched intensity step, rows
// mean, median, std, p5, p95, vmin, vmax, vsum, npx, area.
//
// Design.  One CTA per (frame b, ROI i).  The CTA stages its C x t x t u16
// tile and its t x t mask (u8) in shared memory once; the count, the
// moments (two passes, as the plain version) and the six order statistics
// per channel then read only shared memory.  The order statistics are the
// plain version's 16-step bisection on [0, 65535]: per step every thread
// counts its masked pixels <= mid for all six searches of the channel at
// once, the counts are summed by warp shuffles plus shared memory, and
// every thread updates identical copies of the six (lo, hi) bounds.
//
// What bounds it on this card: each tile is read from device memory once
// (t = 128, C = 2: 64 KB of pixels), and the 16 bisection passes run out of
// shared memory, so the kernel is bound by shared-memory bandwidth and the
// per-step block reductions, not by HBM.  Tiles above 48 KB need the
// opt-in dynamic shared memory (cudaFuncSetAttribute); a tile above the
// opt-in limit (227 KB) runs the second instantiation, which reads the
// tile from device memory on every pass instead.
//
// Numerics.  Built with --fmad=false, and the arithmetic that must match
// the plain PyTorch version uses explicit round-to-nearest intrinsics, so
// no product is fused into an add: masks, counts, order statistics, vmin
// and vmax are exact; sums differ from the plain version only by their
// summation order.  exact_quantile_pos is the int32 arithmetic of
// ops/percentile.py, with g = (float)rem / 100000.0f.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 6;  // (p_lo, median, p_hi) x (k, k+1)
constexpr int kRows = 10;

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

__device__ __forceinline__ float corrected(int raw, float bg, bool clip) {
  const float v = __fsub_rn(static_cast<float>(raw), bg);
  return clip ? fmaxf(v, 0.0f) : v;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
tile_stats_u16_kernel(const uint16_t* __restrict__ tiles,
                      const uint8_t* __restrict__ masks,
                      const float* __restrict__ bgs,
                      float* __restrict__ out,
                      int N, int C, int P, int clip_neg, int p_lo1000,
                      int p_hi1000) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int iscratch[kWarps * kQ];
  __shared__ float fscratch[kWarps];

  const int tid = threadIdx.x;
  const int bi = blockIdx.x;  // b * N + i
  const int b = bi / N;
  const int i = bi % N;
  const bool clip = clip_neg != 0;
  const uint16_t* gx = tiles + static_cast<size_t>(bi) * C * P;
  const uint8_t* gm = masks + static_cast<size_t>(bi) * P;

  const uint16_t* x = gx;
  const uint8_t* m = gm;
  if (kSmem) {
    uint16_t* sx = reinterpret_cast<uint16_t*>(smem);
    uint8_t* sm = smem + static_cast<size_t>(C) * P * 2;
    const int nx = C * P;
    if ((reinterpret_cast<uintptr_t>(gx) & 15) == 0 && (nx & 7) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(gx);
      uint4* dst = reinterpret_cast<uint4*>(sx);
      for (int j = tid; j < nx / 8; j += kThreads) dst[j] = src[j];
    } else {
      for (int j = tid; j < nx; j += kThreads) sx[j] = gx[j];
    }
    for (int j = tid; j < P; j += kThreads) sm[j] = gm[j];
    __syncthreads();
    x = sx;
    m = sm;
  }

  int cnt[1] = {0};
  for (int j = tid; j < P; j += kThreads) cnt[0] += m[j] != 0;
  block_sum_int<1>(cnt, iscratch);
  const int n = cnt[0];
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  const int nm1 = n - 1 > 0 ? n - 1 : 0;

  // positions: ks[0..2] = k of p_lo, median, p_hi; ks[3..5] = k + 1
  const int ps[3] = {p_lo1000, 50000, p_hi1000};
  int ks[kQ];
  float gs[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int k;
    quantile_pos(n, ps[q], &k, &gs[q]);
    ks[q] = min(max(k, 0), nm1);
    ks[q + 3] = min(max(min(k + 1, nm1), 0), nm1);
  }

  for (int c = 0; c < C; ++c) {
    const uint16_t* xc = x + static_cast<size_t>(c) * P;
    const float bg = bgs[b * C + c];

    float s = 0.0f, mn = __int_as_float(0x7f800000), mx = -__int_as_float(0x7f800000);
    for (int j = tid; j < P; j += kThreads) {
      if (m[j]) {
        const float v = corrected(xc[j], bg, clip);
        s = __fadd_rn(s, v);
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
    }
    const float total = block_reduce<Op::kSum>(s, fscratch);
    const float vmin = block_reduce<Op::kMin>(mn, fscratch);
    const float vmax = block_reduce<Op::kMax>(mx, fscratch);
    const float mean = __fdiv_rn(total, nf);

    float ss = 0.0f;
    for (int j = tid; j < P; j += kThreads) {
      if (m[j]) {
        const float d = __fsub_rn(corrected(xc[j], bg, clip), mean);
        ss = __fadd_rn(ss, __fmul_rn(d, d));
      }
    }
    const float var = __fdiv_rn(block_reduce<Op::kSum>(ss, fscratch), nf);

    int lo[kQ], hi[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      lo[q] = 0;
      hi[q] = 65535;
    }
    for (int step = 0; step < 16; ++step) {
      int mid[kQ], le[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        mid[q] = (lo[q] + hi[q]) >> 1;
        le[q] = 0;
      }
      for (int j = tid; j < P; j += kThreads) {
        if (m[j]) {
          const int v = xc[j];
#pragma unroll
          for (int q = 0; q < kQ; ++q) le[q] += v <= mid[q];
        }
      }
      block_sum_int<kQ>(le, iscratch);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (le[q] >= ks[q] + 1) {
          hi[q] = mid[q];
        } else {
          lo[q] = mid[q] + 1;
        }
      }
    }

    if (tid == 0) {
      float osf[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) osf[q] = corrected(hi[q], bg, clip);
      float interp[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        interp[q] = __fadd_rn(osf[q], __fmul_rn(gs[q], __fsub_rn(osf[q + 3], osf[q])));
      }
      const float nan = __int_as_float(0x7fc00000);
      const bool empty = n == 0;
      const float row[kRows] = {
          empty ? nan : mean,          empty ? nan : interp[1],
          empty ? nan : __fsqrt_rn(var), empty ? nan : interp[0],
          empty ? nan : interp[2],     empty ? nan : vmin,
          empty ? nan : vmax,          empty ? nan : total,
          static_cast<float>(n),       static_cast<float>(n)};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        out[((static_cast<size_t>(b) * kRows + r) * C + c) * N + i] = row[r];
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the staged variant needs for one tile.
long long ip_tilestats_smem_bytes(int C, int t) {
  const long long P = static_cast<long long>(t) * t;
  return C * P * 2 + P;
}

// The card's opt-in limit of shared memory per block, or -1 on error.
long long ip_tilestats_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

// tiles (B, N, C, t, t) u16, masks (B, N, t, t) u8 (0/1), bgs (B, C) f32,
// out (B, 10, C, N) f32; all contiguous on the current device.  Launches on
// *stream* and returns the cudaError_t of the launch (0 = success).
int ip_tilestats_u16(const void* tiles, const void* masks, const void* bgs,
                     void* out, int B, int N, int C, int t, int clip_neg,
                     int p_lo1000, int p_hi1000, int use_smem, void* stream) {
  const int blocks = B * N;
  if (blocks == 0) return 0;
  const int P = t * t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const uint16_t*>(tiles);
  const auto* mp = static_cast<const uint8_t*>(masks);
  const auto* bp = static_cast<const float*>(bgs);
  auto* op = static_cast<float*>(out);
  if (use_smem) {
    const size_t bytes = static_cast<size_t>(ip_tilestats_smem_bytes(C, t));
    cudaError_t err = cudaFuncSetAttribute(
        tile_stats_u16_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_stats_u16_kernel<true><<<blocks, kThreads, bytes, s>>>(
        tp, mp, bp, op, N, C, P, clip_neg, p_lo1000, p_hi1000);
  } else {
    tile_stats_u16_kernel<false><<<blocks, kThreads, 0, s>>>(
        tp, mp, bp, op, N, C, P, clip_neg, p_lo1000, p_hi1000);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Per-ROI statistics of float32 tiles, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel imageprocess_tpu/ops/pallas_roistats.py::_kernel
// (wrappers roi_stats_pallas / _roi_stats_pallas_jit): all nine statistics
// of ops/stats.py::masked_stats -- mean, median, std (ddof 0), p5, p95,
// min, max, sum, count -- over the finite masked pixels of a (T, T) tile
// cut out of a (C, H, W) frame at a per-ROI origin.  One form serves both
// callers: frames (F, C, H, W), masks (R, T, T), per-ROI int32
// (frame, row, col); ops.roistats.roi_stats_tiled passes one full frame
// with tile origins, the FRET step its (B*N, 3, t, t) stack with origin 0.
// Origins are clamped into the frame as jax.lax.dynamic_slice clamps them;
// none needs the TPU's (8, 128) alignment.
//
// Design.  One CTA per (ROI, channel).  A first pass reads the tile once
// from device memory: count, sum, min and max of the valid (masked and
// finite) pixels, and each pixel's 32-bit sort key -- the float's bits
// mapped so that unsigned order is float order, -0.0 sharing +0.0's key,
// and 0xffffffff for an invalid pixel, above every finite key -- staged in
// shared memory (T = 128: 64 KB, opt-in dynamic shared memory).  The
// variance (two passes, as the plain version) and the six exact order
// statistics then read only the keys.  The order statistics are the TPU
// kernel's bisection over the key space, started from [key(min),
// key(max)] and stopped when all six searches have converged (at most 32
// steps): per step every thread counts its keys <= mid for the six
// searches at once, warp shuffles plus one shared-memory partial per warp
// give every thread the same six counts, and every thread updates
// identical bounds.  A tile whose keys exceed the opt-in limit (227 KB:
// T > 240) runs the second instantiation, which recomputes the keys from
// device memory on every pass.
//
// What bounds it on this card: the tile crosses HBM once (FRET bench
// chunk: 216 tiles x 64 KB = 14 MB, ~4 us at 3.35 TB/s), while up to 32
// bisection passes over shared memory, each ending in a block reduction,
// make it latency- and shared-memory-bound: the same sequential search
// that made the TPU kernel latency-bound.  216 CTAs of 16 warps keep all
// 132 SMs busy; the early stop cuts the passes where the values span a
// narrow key range.
//
// Numerics.  Built with --fmad=false and explicit round-to-nearest
// intrinsics, as the plain PyTorch version rounds each operation: npx,
// the order statistics, vmin and vmax are exact; the quantile
// interpolation lo + g * (hi - lo) is bit-equal given them; sums differ
// from the plain version only by their summation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using ip::kQ;
using ip::kThreads;
using ip::kWarps;
using ip::Op;
using ip::block_reduce;
using ip::block_sum_int;
constexpr int kStats = 9;
constexpr uint32_t kInvalid = 0xffffffffu;

// float -> uint32, monotone in the float order (finite values land in
// [0x00800000, 0xff7fffff]); -0.0 maps to +0.0's key.  Unsigned, so no
// signed overflow.
__device__ __forceinline__ uint32_t sortable_key(float v) {
  const uint32_t b = v == 0.0f ? 0u : __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// |v| < inf; false for NaN.
__device__ __forceinline__ bool is_finite(float v) {
  return fabsf(v) < __int_as_float(0x7f800000);
}

__device__ __forceinline__ float key_to_float(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
roi_stats_f32_kernel(const float* __restrict__ frames,
                     const uint8_t* __restrict__ masks,
                     const int* __restrict__ offs,
                     float* __restrict__ out,
                     int F, int C, int H, int W, int T, int p_lo1000,
                     int p_hi1000) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int iscratch[kWarps * kQ];
  __shared__ float fscratch[kWarps];

  const int tid = threadIdx.x;
  const int r = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const int P = T * T;
  const int f = min(max(offs[3 * r], 0), F - 1);
  const int y0 = min(max(offs[3 * r + 1], 0), H - T);
  const int x0 = min(max(offs[3 * r + 2], 0), W - T);
  const float* x = frames + (static_cast<size_t>(f) * C + c) * H * W +
                   static_cast<size_t>(y0) * W + x0;
  const uint8_t* m = masks + static_cast<size_t>(r) * P;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  const bool dense = W == T;  // the tile is contiguous (the stack form)

  auto pixel = [&](int j) -> float {
    return dense ? x[j] : x[static_cast<size_t>(j / T) * W + j % T];
  };
  auto key_at = [&](int j) -> uint32_t {
    if (kSmem) return keys[j];
    const float v = pixel(j);
    return (m[j] != 0 && is_finite(v)) ? sortable_key(v) : kInvalid;
  };

  int cnt[1] = {0};
  float s = 0.0f;
  float mn = __int_as_float(0x7f800000), mx = -__int_as_float(0x7f800000);
  for (int j = tid; j < P; j += kThreads) {
    const float v = pixel(j);
    const bool ok = m[j] != 0 && is_finite(v);
    if (ok) {
      ++cnt[0];
      s = __fadd_rn(s, v);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    if (kSmem) keys[j] = ok ? sortable_key(v) : kInvalid;
  }
  block_sum_int<1>(cnt, iscratch);  // its barriers also publish the keys
  const int n = cnt[0];
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  const float total = block_reduce<Op::kSum>(s, fscratch);
  const float vmin = block_reduce<Op::kMin>(mn, fscratch);
  const float vmax = block_reduce<Op::kMax>(mx, fscratch);
  const float mean = __fdiv_rn(total, nf);

  float ss = 0.0f;
  for (int j = tid; j < P; j += kThreads) {
    const uint32_t k = key_at(j);
    if (k != kInvalid) {
      const float d = __fsub_rn(key_to_float(k), mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(block_reduce<Op::kSum>(ss, fscratch), nf);

  int ks[kQ];
  float gs[3];
  ip::quantile_positions(n, p_lo1000, p_hi1000, ks, gs);

  // The (k+1)-th smallest key is the least v with count(keys <= v) > k;
  // it lies in [key(vmin), key(vmax)], so mid never reaches kInvalid.
  uint32_t lo[kQ], hi[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    lo[q] = n > 0 ? sortable_key(vmin) : 0u;
    hi[q] = n > 0 ? sortable_key(vmax) : 0u;
  }
  for (int step = 0; step < 32; ++step) {
    bool done = true;
#pragma unroll
    for (int q = 0; q < kQ; ++q) done = done && lo[q] == hi[q];
    if (done) break;  // uniform: every thread holds the same bounds
    uint32_t mid[kQ];
    int le[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      mid[q] = (lo[q] & hi[q]) + ((lo[q] ^ hi[q]) >> 1);
      le[q] = 0;
    }
    for (int j = tid; j < P; j += kThreads) {
      const uint32_t k = key_at(j);
#pragma unroll
      for (int q = 0; q < kQ; ++q) le[q] += k <= mid[q];
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
    float interp[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float a = key_to_float(hi[q]), b = key_to_float(hi[q + 3]);
      interp[q] = __fadd_rn(a, __fmul_rn(gs[q], __fsub_rn(b, a)));
    }
    const float nan = __int_as_float(0x7fc00000);
    const bool empty = n == 0;
    const float row[kStats] = {
        empty ? nan : mean,            empty ? nan : interp[1],
        empty ? nan : __fsqrt_rn(var), empty ? nan : interp[0],
        empty ? nan : interp[2],       empty ? nan : vmin,
        empty ? nan : vmax,            empty ? nan : total,
        static_cast<float>(n)};
    float* o = out + (static_cast<size_t>(r) * C + c) * kStats;
#pragma unroll
    for (int k = 0; k < kStats; ++k) o[k] = row[k];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the staged variant needs for a T x T tile.
long long ip_roistats_smem_bytes(int T) {
  return static_cast<long long>(T) * T * 4;
}

// The most dynamic shared memory the staged variant may take on *device*:
// the opt-in limit less the kernel's static shared memory; -1 on error.
long long ip_roistats_smem_limit(int device) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, roi_stats_f32_kernel<true>) != cudaSuccess) {
    return -1;
  }
  const long long optin = ip::smem_optin(device);
  return optin < 0 ? -1 : optin - static_cast<long long>(attr.sharedSizeBytes);
}

// frames (F, C, H, W) f32, masks (R, T, T) u8 (0/1), offs (R, 3) int32
// (frame, row, col), out (R, C, 9) f32 in the order of ops.stats.STAT_FIELDS
// (npx as a float); all contiguous on the current device, T <= H, T <= W.
// Launches on *stream* and returns the cudaError_t of the launch
// (0 = success).
int ip_roistats_f32(const void* frames, const void* masks, const void* offs,
                    void* out, int R, int F, int C, int H, int W, int T,
                    int p_lo1000, int p_hi1000, int use_smem, void* stream) {
  const long long blocks = static_cast<long long>(R) * C;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fp = static_cast<const float*>(frames);
  const auto* mp = static_cast<const uint8_t*>(masks);
  const auto* op = static_cast<const int*>(offs);
  auto* outp = static_cast<float*>(out);
  if (use_smem) {
    const size_t bytes = static_cast<size_t>(ip_roistats_smem_bytes(T));
    cudaError_t err = cudaFuncSetAttribute(
        roi_stats_f32_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    roi_stats_f32_kernel<true><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
        fp, mp, op, outp, F, C, H, W, T, p_lo1000, p_hi1000);
  } else {
    roi_stats_f32_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        fp, mp, op, outp, F, C, H, W, T, p_lo1000, p_hi1000);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

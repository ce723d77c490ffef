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
// What bounds it on this card: device memory at best -- the FRET bench
// chunk (72 tiles x 3 channels x 64 KB of values + 1.2 MB of masks) is
// 15.3 MB, 4.6 us at 3.35 TB/s, and the arithmetic a few float operations
// per pixel -- but in practice the issue and latency of the sweeps over
// shared memory (per-key bit tests, bin compares and shared atomics) and
// the scans between them (PERF.md).  The earlier design lost more: up to 32 bisection sweeps, each ending in a block
// reduction, in CTAs of 512 threads at 84 registers that fit one per SM,
// so its 216 CTAs ran in two waves on the 132 SMs (not, as its note said,
// all at once).
//
// Design.  One CTA of kThreads = 512 threads per (ROI, channel), at most 64
// registers (__launch_bounds__(512, 2)), 80 KB of dynamic and 21.7 KB of
// static shared memory at T = 128: two CTAs share an SM, so a bench
// chunk's 216 CTAs are all resident at once on the 132 SMs.
// - Staging: where every tile row is 16-byte aligned (T and W multiples of
//   4 and an aligned origin; always so in the stack form at T % 4 == 0) the
//   values, and the mask with stage_mask (which the host sets where the
//   mask fits beside them without costing a resident CTA per SM), come
//   into shared memory by 16-byte cp.async, issued all at once without
//   registers; otherwise sweep 1 reads device memory.
// - Sweep 1 (the only pass over device memory besides staging), four
//   pixels per thread and step, branch-free: validity (masked and finite),
//   count, sum, min, max, each pixel's 32-bit sort key written in place over
//   its value (the float's bits mapped so that unsigned order is float
//   order, -0.0 sharing +0.0's key, 0xffffffff for an invalid pixel), and
//   the 256-bin histogram of the keys' top byte.
// - Radix select (common.cuh::RadixSelect): a scan of the histogram gives
//   each of the six ranks its bin and its rank inside the bin; sweep 2
//   fuses the variance (two-pass, as the plain version: the mean is known)
//   with the histograms of the second byte of the <= 6 selected prefixes
//   (searches with one prefix share one); sweep 3 counts the third byte and
//   appends the keys that match a 16-bit prefix to a candidate list over
//   the spent mask's space, so that sweep 4 reads only those.  4 sweeps and
//   4 scans instead of 2 sweeps and up to 32 bisection steps.
// Shared memory: keys and mask take 5 T^2 bytes beside the static 21.7 KB,
// which fits the opt-in 227 KB up to T = 205.  Up to T = 229 the keys (4 T^2
// bytes) still fit: without stage_mask sweep 1 reads the mask from device
// memory and sweep 4 reads all keys (no room for the candidate list).  Larger tiles
// run the second instantiation, which computes the keys from device memory
// on every sweep (and reads all keys in sweep 4).
//
// Numerics.  Built with --fmad=false and explicit round-to-nearest
// intrinsics, as the plain PyTorch version rounds each operation: npx and
// the order statistics are exact by construction (every digit is a count),
// so are vmin and vmax; the quantile interpolation lo + g * (hi - lo) is
// bit-equal given them; sums differ from the plain version only by their
// summation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using ip::kMinBlocks;
using ip::kQ;
using ip::kThreads;
using ip::kWarps;
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
__global__ void __launch_bounds__(kThreads, kMinBlocks)
roi_stats_f32_kernel(const float* __restrict__ frames,
                     const uint8_t* __restrict__ masks,
                     const int* __restrict__ offs,
                     float* __restrict__ out,
                     int F, int C, int H, int W, int T, int p_lo1000,
                     int p_hi1000, bool stage_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ip::RadixShared rs;
  __shared__ int iscratch[kWarps];
  __shared__ float fscratch[3 * kWarps];
  __shared__ int ncand;  // keys appended to the candidate list in sweep 3

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
  // the mask's space (allocated only with stage_mask), later the candidates
  uint8_t* smask = smem + static_cast<size_t>(P) * 4;
  const bool dense = W == T;  // the tile is contiguous (the stack form)

  auto pixel = [&](int j) -> float {
    return dense ? x[j] : x[static_cast<size_t>(j / T) * W + j % T];
  };
  // the four keys from j on (kInvalid past the tile)
  auto keys4 = [&](int j, uint32_t (&k)[4]) {
    if (kSmem && j + 3 < P) {
      const uint4 q = *reinterpret_cast<const uint4*>(keys + j);
      k[0] = q.x, k[1] = q.y, k[2] = q.z, k[3] = q.w;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      k[e] = kInvalid;
      if (j + e < P) {
        if (kSmem) {
          k[e] = keys[j + e];
        } else {
          const float v = pixel(j + e);
          if (m[j + e] != 0 && is_finite(v)) k[e] = sortable_key(v);
        }
      }
    }
  };

  ip::radix_clear(&rs);
  if (tid == 0) ncand = 0;
  // Staging: every row 16-byte aligned (so P % 16 == 0)
  const bool staged = kSmem && T % 4 == 0 && W % 4 == 0 && ip::aligned16(x);
  const bool mask_staged = staged && stage_mask && ip::aligned16(m);
  if (staged) {
    const int per_row = T / 4;
    for (int k = tid; k < P / 4; k += kThreads) {
      const int row = k / per_row, col = (k - row * per_row) * 4;
      ip::cp_async16(keys + row * T + col, x + static_cast<size_t>(row) * W + col);
    }
    if (mask_staged) {
      for (int k = tid; k < P / 16; k += kThreads) ip::cp_async16(smask + 16 * k, m + 16 * k);
    }
    ip::cp_async_wait_all();
  }
  __syncthreads();  // the staged tile and the cleared histograms

  // Sweep 1, four pixels per thread and step: count, sum, min, max; keys
  // in place; top-byte histogram.
  ip::RadixSelect<32> sel(&rs);
  int cnt = 0;
  float s = 0.0f;
  float mn = __int_as_float(0x7f800000), mx = -__int_as_float(0x7f800000);
  for (int j = 4 * tid; j < P; j += 4 * kThreads) {
    float v[4];
    bool ok[4];
    if (staged) {  // P % 4 == 0: a whole chunk
      const uint4 q = *reinterpret_cast<const uint4*>(keys + j);
      const uint32_t m4 = mask_staged
                              ? *reinterpret_cast<const uint32_t*>(smask + j)
                              : m[j] | m[j + 1] << 8 | m[j + 2] << 16 |
                                    static_cast<uint32_t>(m[j + 3]) << 24;
      v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
      v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
#pragma unroll
      for (int e = 0; e < 4; ++e) ok[e] = ((m4 >> (8 * e)) & 0xffu) != 0;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ok[e] = j + e < P && m[j + e] != 0;
        v[e] = ok[e] ? pixel(j + e) : 0.0f;
      }
    }
    uint32_t k[4];
    int bin[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // branch-free, so the four keys overlap
      ok[e] = ok[e] && is_finite(v[e]);
      cnt += ok[e];
      s = ok[e] ? __fadd_rn(s, v[e]) : s;
      mn = ok[e] ? fminf(mn, v[e]) : mn;
      mx = ok[e] ? fmaxf(mx, v[e]) : mx;
      k[e] = ok[e] ? sortable_key(v[e]) : kInvalid;
      bin[e] = ok[e] ? sel.bin0(k[e]) : -1;
    }
    if (kSmem) {
      if (j + 3 < P) {
        *reinterpret_cast<uint4*>(keys + j) = make_uint4(k[0], k[1], k[2], k[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < P) keys[j + e] = k[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
  }
  const ip::Moments mo = ip::block_moments(cnt, s, mn, mx, iscratch, fscratch);
  const int n = mo.n;  // its barriers publish the keys
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  const float total = mo.sum, vmin = mo.mn, vmax = mo.mx;
  const float mean = __fdiv_rn(total, nf);

  int ks[kQ];
  float gs[3];
  ip::quantile_positions(n, p_lo1000, p_hi1000, ks, gs);
  const bool any = n > 0;  // uniform across the CTA
  if (any) {
    sel.start(ks);
    sel.select();
  }

  // Sweep 2: the variance and the second byte's histograms.
  float ss = 0.0f;
  for (int j = 4 * tid; j < P; j += 4 * kThreads) {
    uint32_t k[4];
    keys4(j, k);
    int bin[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = k[e] != kInvalid;
      const float d = __fsub_rn(key_to_float(k[e]), mean);
      ss = ok ? __fadd_rn(ss, __fmul_rn(d, d)) : ss;
      bin[e] = ok && any ? sel.bin(k[e]) : -1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
  }
  const float var = __fdiv_rn(ip::block_sum(ss, fscratch), nf);

  if (any) {
    sel.select();
    // Sweep 3: the third byte's histograms.  With the keys in shared
    // memory and room for the mask, the keys that match a search's 16-bit
    // prefix also go to a candidate list over the mask's space (no longer
    // needed), so that sweep 4 reads only them.
    uint32_t* cand = reinterpret_cast<uint32_t*>(smask);
    const int cap = kSmem && stage_mask ? P / 4 : 0;
    for (int j0 = 0; j0 < P; j0 += 4 * kThreads) {  // warp-uniform trip count
      const int j = j0 + 4 * tid;
      uint32_t k[4];
      keys4(j, k);
      int bin[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) bin[e] = k[e] != kInvalid ? sel.bin(k[e]) : -1;
#pragma unroll
      for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
      if (cap > 0) {
        const bool take[4] = {bin[0] >= 0, bin[1] >= 0, bin[2] >= 0, bin[3] >= 0};
        ip::append4(cand, &ncand, cap, k, take);
      }
    }
    __syncthreads();
    sel.select();
    // Sweep 4: the low byte, over the candidates when they all fitted.
    const int nc = ncand;  // published by select()'s barriers
    if (cap > 0 && nc <= cap) {
      for (int i = tid; i < nc; i += kThreads) ip::hist_add(rs.hist, sel.bin(cand[i]));
    } else {
      for (int j = 4 * tid; j < P; j += 4 * kThreads) {
        uint32_t k[4];
        keys4(j, k);
        int bin[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) bin[e] = k[e] != kInvalid ? sel.bin(k[e]) : -1;
#pragma unroll
        for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
      }
    }
    __syncthreads();
    sel.select();
  }

  if (tid == 0) {
    float interp[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float a = key_to_float(sel.key[q]), b = key_to_float(sel.key[q + 3]);
      interp[q] = __fadd_rn(a, __fmul_rn(gs[q], __fsub_rn(b, a)));
    }
    const float nan = __int_as_float(0x7fc00000);
    const float row[kStats] = {
        any ? mean : nan,            any ? interp[1] : nan,
        any ? __fsqrt_rn(var) : nan, any ? interp[0] : nan,
        any ? interp[2] : nan,       any ? vmin : nan,
        any ? vmax : nan,            any ? total : nan,
        static_cast<float>(n)};
    float* o = out + (static_cast<size_t>(r) * C + c) * kStats;
#pragma unroll
    for (int k = 0; k < kStats; ++k) o[k] = row[k];
  }
}

// The dynamic shared memory granted to the staged variant, per device.
size_t g_granted[ip::kMaxDevices] = {};

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the staged variant needs for a T x T tile:
// the keys, and the mask with *stage_mask*.
long long ip_roistats_smem_bytes(int T, int stage_mask) {
  return static_cast<long long>(T) * T * (stage_mask ? 5 : 4);
}

// The most dynamic shared memory the staged variant may take on *device*:
// the opt-in limit less the kernel's static shared memory; -1 on error.
long long ip_roistats_smem_limit(int device) {
  return ip::smem_limit(roi_stats_f32_kernel<true>, device);
}

// Resident CTAs per SM of the variant a launch with these arguments takes
// (-1 on error), for the current device.
int ip_roistats_occupancy(int T, int use_smem, int stage_mask) {
  return use_smem ? ip::occupancy(roi_stats_f32_kernel<true>,
                                  static_cast<size_t>(ip_roistats_smem_bytes(T, stage_mask)),
                                  g_granted)
                  : ip::occupancy(roi_stats_f32_kernel<false>, 0, nullptr);
}

// frames (F, C, H, W) f32, masks (R, T, T) u8 (0/1), offs (R, 3) int32
// (frame, row, col), out (R, C, 9) f32 in the order of ops.stats.STAT_FIELDS
// (npx as a float); all contiguous on the current device, T <= H, T <= W.
// *use_smem* stages the keys in shared memory, *stage_mask* the mask beside
// them.  Launches R * C CTAs on *stream* and returns the cudaError_t of the
// launch (0 = success).
int ip_roistats_f32(const void* frames, const void* masks, const void* offs,
                    void* out, int R, int F, int C, int H, int W, int T,
                    int p_lo1000, int p_hi1000, int use_smem, int stage_mask,
                    void* stream) {
  const long long blocks = static_cast<long long>(R) * C;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fp = static_cast<const float*>(frames);
  const auto* mp = static_cast<const uint8_t*>(masks);
  const auto* op = static_cast<const int*>(offs);
  auto* outp = static_cast<float*>(out);
  if (use_smem) {
    const size_t bytes = static_cast<size_t>(ip_roistats_smem_bytes(T, stage_mask));
    const cudaError_t err = ip::prepare_once(roi_stats_f32_kernel<true>, bytes, g_granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    roi_stats_f32_kernel<true><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
        fp, mp, op, outp, F, C, H, W, T, p_lo1000, p_hi1000, stage_mask != 0);
  } else {
    roi_stats_f32_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        fp, mp, op, outp, F, C, H, W, T, p_lo1000, p_hi1000, false);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

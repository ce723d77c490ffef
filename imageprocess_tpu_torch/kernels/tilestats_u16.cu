// Per-ROI statistics of raw u16 tiles, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel imageprocess_tpu/ops/pallas_tilestats.py::_kernel
// (wrapper batched_order_stats_pallas) and the XLA moments around it
// (ops/tilestats_u16.py::tile_stats_u16): one launch produces the whole
// packed (B, 10, C, N) result of the batched intensity step, rows
// mean, median, std, p5, p95, vmin, vmax, vsum, npx, area.
//
// What bounds it on this card: device memory at best -- each pixel and
// mask byte crosses it once (intensity bench chunk: 4.7 MB of u16 tiles +
// 1.2 MB of masks, 5.9 MB, 1.8 us at 3.35 TB/s), and the arithmetic is a
// few float operations per pixel -- but in practice the issue and latency
// of the two sweeps over shared memory and of the scans (PERF.md).  The
// earlier design lost more: one CTA per (frame, ROI) -- 72 CTAs for 132
// SMs -- ran both channels in series, 19 sweeps each with 32 block
// reductions.
//
// Design.  One CTA of kThreads = 512 threads per (frame b, ROI i, channel
// c): 144 CTAs at the bench shape, each with 32 KB of pixels and 16 KB of
// mask (dynamic) and 21.7 KB of histograms (static) in shared memory and
// at most 64 registers (__launch_bounds__(512, 2)): two fit on an SM, so
// every CTA of a chunk is resident at once.
// - Staging: the channel's contiguous t x t tile and the mask come into
//   shared memory by 16-byte cp.async where the sizes and addresses allow
//   (t * t a multiple of 16), else by plain loads.
// - Sweep 1, four pixels per thread and step, branch-free: count, sum, min
//   and max of clip(x - bg) over the masked pixels, and the 256-bin
//   histogram of the high byte of the raw values.
// - Radix select (common.cuh::RadixSelect): a scan gives each of the six
//   ranks its bin; sweep 2 fuses the variance (two-pass, as the plain
//   version) with the low-byte histograms of the <= 6 selected high bytes;
//   a second scan gives the exact raw u16 order statistics.  2 sweeps and 2
//   scans instead of 19 sweeps and 32 block reductions.
// - The npx and area rows come from the mask count, which every channel's
//   CTA computes; each CTA writes its own channel's rows.
// A tile above the opt-in shared memory (3 t^2 bytes beside the static
// 21.7 KB > 227 KB: t > 264) runs the second instantiation, which reads
// device memory on both sweeps.
//
// Numerics.  Built with --fmad=false, and the arithmetic that must match
// the plain PyTorch version uses explicit round-to-nearest intrinsics, so
// no product is fused into an add: masks, counts, order statistics, vmin
// and vmax are exact; the order statistics are the raw u16 values,
// corrected and interpolated as the plain version does; sums differ from
// the plain version only by their summation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using ip::kMinBlocks;
using ip::kQ;
using ip::kThreads;
using ip::kWarps;
constexpr int kRows = 10;

__device__ __forceinline__ float corrected(int raw, float bg, bool clip) {
  const float v = __fsub_rn(static_cast<float>(raw), bg);
  return clip ? fmaxf(v, 0.0f) : v;
}

// The dynamic shared memory granted to the staged variant, per device.
size_t g_granted[ip::kMaxDevices] = {};

// Offset of the mask behind the staged pixels, 16-byte aligned.
__host__ __device__ __forceinline__ int mask_offset(int P) {
  return (P * 2 + 15) & ~15;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_stats_u16_kernel(const uint16_t* __restrict__ tiles,
                      const uint8_t* __restrict__ masks,
                      const float* __restrict__ bgs,
                      float* __restrict__ out,
                      int N, int C, int P, int clip_neg, int p_lo1000,
                      int p_hi1000) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ip::RadixShared rs;
  __shared__ int iscratch[kWarps];
  __shared__ float fscratch[3 * kWarps];

  const int tid = threadIdx.x;
  const int bic = blockIdx.x;  // (b * N + i) * C + c
  const int bi = bic / C;
  const int c = bic - bi * C;
  const int b = bi / N;
  const int i = bi - b * N;
  const bool clip = clip_neg != 0;
  const float bg = bgs[b * C + c];
  const uint16_t* gx = tiles + static_cast<size_t>(bic) * P;
  const uint8_t* gm = masks + static_cast<size_t>(bi) * P;

  ip::radix_clear(&rs);
  const uint16_t* x = gx;
  const uint8_t* m = gm;
  if (kSmem) {
    uint16_t* sx = reinterpret_cast<uint16_t*>(smem);
    uint8_t* sm = smem + mask_offset(P);
    if (P % 8 == 0 && ip::aligned16(gx)) {
      for (int k = tid; k < P / 8; k += kThreads) ip::cp_async16(sx + 8 * k, gx + 8 * k);
    } else {
      for (int j = tid; j < P; j += kThreads) sx[j] = gx[j];
    }
    if (P % 16 == 0 && ip::aligned16(gm)) {
      for (int k = tid; k < P / 16; k += kThreads) ip::cp_async16(sm + 16 * k, gm + 16 * k);
    } else {
      for (int j = tid; j < P; j += kThreads) sm[j] = gm[j];
    }
    ip::cp_async_wait_all();
    x = sx;
    m = sm;
  }
  __syncthreads();  // the staged tile and the cleared histograms

  // the raw values and mask flags of the four pixels from j on
  const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(m) & 3) == 0;
  auto pixels4 = [&](int j, int (&raw)[4], bool (&ok)[4]) {
    if (vec) {  // P % 4 == 0: a whole chunk
      const uint2 xv = *reinterpret_cast<const uint2*>(x + j);
      const uint32_t m4 = *reinterpret_cast<const uint32_t*>(m + j);
      raw[0] = xv.x & 0xffff, raw[1] = xv.x >> 16;
      raw[2] = xv.y & 0xffff, raw[3] = xv.y >> 16;
#pragma unroll
      for (int e = 0; e < 4; ++e) ok[e] = ((m4 >> (8 * e)) & 0xffu) != 0;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ok[e] = j + e < P && m[j + e] != 0;
      raw[e] = ok[e] ? x[j + e] : 0;
    }
  };

  // Sweep 1, four pixels per thread and step: count, sum, min, max;
  // high-byte histogram of the raw values.
  ip::RadixSelect<16> sel(&rs);
  int cnt = 0;
  float s = 0.0f, mn = __int_as_float(0x7f800000), mx = -__int_as_float(0x7f800000);
  for (int j = 4 * tid; j < P; j += 4 * kThreads) {
    int raw[4];
    bool ok[4];
    pixels4(j, raw, ok);
    int bin[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // branch-free, so the four keys overlap
      const float v = corrected(raw[e], bg, clip);
      cnt += ok[e];
      s = ok[e] ? __fadd_rn(s, v) : s;
      mn = ok[e] ? fminf(mn, v) : mn;
      mx = ok[e] ? fmaxf(mx, v) : mx;
      bin[e] = ok[e] ? sel.bin0(static_cast<uint32_t>(raw[e])) : -1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
  }
  const ip::Moments mo = ip::block_moments(cnt, s, mn, mx, iscratch, fscratch);
  const int n = mo.n;  // its barriers publish the counts
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  const float total = mo.sum, vmin = mo.mn, vmax = mo.mx;
  const float mean = __fdiv_rn(total, nf);

  // positions: ks[0..2] = k of p_lo, median, p_hi; ks[3..5] = k + 1
  int ks[kQ];
  float gs[3];
  ip::quantile_positions(n, p_lo1000, p_hi1000, ks, gs);
  const bool any = n > 0;  // uniform across the CTA
  if (any) {
    sel.start(ks);
    sel.select();
  }

  // Sweep 2: the variance and the low-byte histograms.
  float ss = 0.0f;
  for (int j = 4 * tid; j < P; j += 4 * kThreads) {
    int raw[4];
    bool ok[4];
    pixels4(j, raw, ok);
    int bin[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = __fsub_rn(corrected(raw[e], bg, clip), mean);
      ss = ok[e] ? __fadd_rn(ss, __fmul_rn(d, d)) : ss;
      bin[e] = ok[e] && any ? sel.bin(static_cast<uint32_t>(raw[e])) : -1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
  }
  const float var = __fdiv_rn(ip::block_sum(ss, fscratch), nf);
  if (any) sel.select();

  if (tid == 0) {
    float osf[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) osf[q] = corrected(static_cast<int>(sel.key[q]), bg, clip);
    float interp[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      interp[q] = __fadd_rn(osf[q], __fmul_rn(gs[q], __fsub_rn(osf[q + 3], osf[q])));
    }
    const float nan = __int_as_float(0x7fc00000);
    const float row[kRows] = {
        any ? mean : nan,            any ? interp[1] : nan,
        any ? __fsqrt_rn(var) : nan, any ? interp[0] : nan,
        any ? interp[2] : nan,       any ? vmin : nan,
        any ? vmax : nan,            any ? total : nan,
        static_cast<float>(n),       static_cast<float>(n)};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      out[((static_cast<size_t>(b) * kRows + r) * C + c) * N + i] = row[r];
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the staged variant needs for one channel's
// t x t tile and its mask.
long long ip_tilestats_smem_bytes(int t) {
  const int P = t * t;
  return static_cast<long long>(mask_offset(P)) + P;
}

// The most dynamic shared memory the staged variant may take on *device*:
// the opt-in limit less the kernel's static shared memory; -1 on error.
long long ip_tilestats_smem_limit(int device) {
  return ip::smem_limit(tile_stats_u16_kernel<true>, device);
}

// Resident CTAs per SM of the variant a launch with these arguments takes
// (-1 on error), for the current device.
int ip_tilestats_occupancy(int t, int use_smem) {
  return use_smem ? ip::occupancy(tile_stats_u16_kernel<true>,
                                  static_cast<size_t>(ip_tilestats_smem_bytes(t)),
                                  g_granted)
                  : ip::occupancy(tile_stats_u16_kernel<false>, 0, nullptr);
}

// tiles (B, N, C, t, t) u16, masks (B, N, t, t) u8 (0/1), bgs (B, C) f32,
// out (B, 10, C, N) f32; all contiguous on the current device.  Launches
// B * N * C CTAs on *stream* and returns the cudaError_t of the launch
// (0 = success).
int ip_tilestats_u16(const void* tiles, const void* masks, const void* bgs,
                     void* out, int B, int N, int C, int t, int clip_neg,
                     int p_lo1000, int p_hi1000, int use_smem, void* stream) {
  const long long blocks = static_cast<long long>(B) * N * C;
  if (blocks == 0) return 0;
  const int P = t * t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const uint16_t*>(tiles);
  const auto* mp = static_cast<const uint8_t*>(masks);
  const auto* bp = static_cast<const float*>(bgs);
  auto* op = static_cast<float*>(out);
  if (use_smem) {
    const size_t bytes = static_cast<size_t>(ip_tilestats_smem_bytes(t));
    const cudaError_t err = ip::prepare_once(tile_stats_u16_kernel<true>, bytes, g_granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_stats_u16_kernel<true><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
        tp, mp, bp, op, N, C, P, clip_neg, p_lo1000, p_hi1000);
  } else {
    tile_stats_u16_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tp, mp, bp, op, N, C, P, clip_neg, p_lo1000, p_hi1000);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

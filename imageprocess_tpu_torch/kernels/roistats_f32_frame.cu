// Per-ROI statistics of whole float32 frames, written by hand for Hopper
// (sm_90a): the frame form of roistats_f32.
//
// Replaces the TPU kernel imageprocess_tpu/ops/pallas_roistats.py::_kernel
// where the port's callers hand it whole frames: ops.roistats.roi_stats_full
// (PNG-mask ROIs, the whole-frame ROI 0, ROIs too large for a tile, every
// key of a bg_scope="roi_union" run), which computes what the JAX package's
// ops/stats.py::roi_stats computes over full-frame masks.  For every
// (ROI, channel): the nine statistics of ops/stats.py::masked_stats --
// mean, median, std (ddof 0), p5, p95, min, max, sum, count -- over the
// finite masked pixels, the order statistics at np.percentile positions.
// Frames (C, H, W) and masks (N, H, W) come unpadded; out is (N, C, 9).
//
// What bounds it on this card: device memory -- each channel's values once
// and each valid mask once (a whole 1536 x 2048 frame in two channels with
// one mask: 28.3 MB, 8.5 us at 3.35 TB/s).  The tile form, given such a
// frame zero-padded to one 2048 x 2048 tile, ran one 512-thread CTA per
// (ROI, channel) -- 2 CTAs on 132 SMs -- whose four sweeps recomputed 4 M
// keys from device memory with scalar loads, padding rows included.
//
// Design.  A thread-block cluster of G CTAs per (ROI, channel) (G <= 16,
// chosen by the host so that the grid fills the SMs once at one CTA per SM),
// each CTA owning a band of whole rows of the real H x W frame.
// - Loads: where the channel's and the mask's planes are 16-byte aligned,
//   each thread reads 16-pixel units -- one 16-byte mask load, then one
//   16-byte value load per nonzero 4-byte mask word -- kUnroll units at a
//   time; a warp whose mask bytes are all zero reads no values and does no
//   work, so a sparse ROI costs mostly its mask bytes.  A band's ragged
//   head and tail, and unaligned planes, go pixel by pixel.
// - The radix select of common.cuh::RadixSelect (8-bit digits, six ranks,
//   four sweeps), its histograms built in each CTA's shared memory and
//   summed across the cluster through distributed shared memory: after
//   each sweep every CTA publishes its histograms of the searches in play,
//   cluster.sync(), and every CTA adds all G of them in rank order, so
//   every CTA selects the same bins.  The published copies alternate
//   between two buffers, so one cluster.sync() per sweep suffices.
// - Sweep 1 appends every valid key to its warp's list in dynamic shared
//   memory; when no warp's list overflows, sweeps 2-4 read the lists and
//   not device memory (a sparse ROI is read once).  Otherwise sweep 3
//   appends the keys that match a search's 16-bit prefix, and sweep 4
//   reads only those unless a list overflows again.
// - Moments: count, sum, min and max in sweep 1, the variance two-pass in
//   sweep 2 (the mean known), as the plain version.  The CTAs' partials are
//   combined in rank order through distributed shared memory, with no
//   float atomics, and each warp's lists are filled in a fixed order, so
//   two launches on the same inputs give bit-equal rows.
// - One launch per call (cudaLaunchKernelEx with a cluster dimension); no
//   host synchronisation.
//
// Numerics as roistats_f32.cu: --fmad=false and explicit round-to-nearest
// intrinsics; npx, min, max and the order statistics are exact, sums differ
// from the plain version only by their summation order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using ip::kBins;
using ip::kQ;
using ip::kThreads;
using ip::kWarps;
constexpr int kStats = 9;
constexpr int kMaxCluster = 16;  // the non-portable cluster size of Hopper
constexpr int kUnroll = 4;       // 16-pixel units per thread in flight
constexpr uint32_t kInvalid = 0xffffffffu;
constexpr uint32_t kFull = 0xffffffffu;

// float -> uint32, monotone in the float order; -0.0 maps to +0.0's key.
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

// A warp's list of keys in shared memory; n is the same in every lane and
// may grow past cap (the list is then incomplete and must not be read).
struct WarpList {
  uint32_t* keys;
  int cap;
  int n;

  __device__ __forceinline__ bool overflowed() const { return n > cap; }

  // Append k[e] where take[e], in lane order; every lane of the warp calls
  // it.  Stops appending once the list has overflowed.
  __device__ __forceinline__ void push4(const uint32_t (&k)[4], const bool (&take)[4]) {
    if (n > cap) return;  // warp-uniform
    const int c = take[0] + take[1] + take[2] + take[3];
    if (!__any_sync(kFull, c > 0)) return;
    const int lane = threadIdx.x & 31;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int i = n + incl - c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (take[e]) {
        if (i < cap) keys[i] = k[e];
        ++i;
      }
    }
    n += total;
  }
};

// A CTA's partial moments, read by the other CTAs of its cluster.
struct Partial {
  int n;
  float sum, mn, mx, ss;
};

// Pixels [lo, hi) of a plane one at a time, as f's first of four (the
// other three masked off).  The trip count is the same in every thread,
// so f may hold warp-wide operations.
template <class F>
__device__ __forceinline__ void scalar_range(const float* x, const uint8_t* m,
                                             long long lo, long long hi, F& f) {
  for (long long q = lo; q < hi; q += kThreads) {
    const long long p = q + threadIdx.x;
    const bool mk = p < hi && m[p] != 0;
    const float v[4] = {mk ? x[p] : 0.0f, 0.0f, 0.0f, 0.0f};
    const bool ok[4] = {mk, false, false, false};
    f(v, ok);
  }
}

// Call f(v[4], mask[4]) over the pixels [p0, p1) of the value plane x and
// the mask plane m: 16-pixel units with 16-byte loads where both planes are
// 16-byte aligned (*vec*), pixel by pixel at the ragged ends.  Every lane of
// a warp calls f equally often; a warp whose kUnroll units have no mask
// byte set skips them.
template <class F>
__device__ __forceinline__ void sweep_band(const float* x, const uint8_t* m, long long p0,
                                           long long p1, bool vec, F&& f) {
  if (!vec) {
    scalar_range(x, m, p0, p1, f);
    return;
  }
  const long long a = min(p1, (p0 + 15) & ~15LL);
  const long long b = max(a, p1 & ~15LL);
  scalar_range(x, m, p0, a, f);
  const long long units = (b - a) >> 4;
  const uint4* mu = reinterpret_cast<const uint4*>(m + a);
  const float4* xu = reinterpret_cast<const float4*>(x + a);
  for (long long u0 = 0; u0 < units; u0 += static_cast<long long>(kUnroll) * kThreads) {
    uint4 mw[kUnroll];
    bool set = false;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = u0 + k * kThreads + threadIdx.x;
      mw[k] = u < units ? __ldg(mu + u) : make_uint4(0u, 0u, 0u, 0u);
      set = set || (mw[k].x | mw[k].y | mw[k].z | mw[k].w) != 0u;
    }
    if (!__any_sync(kFull, set)) continue;
    float4 v[kUnroll][4];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = u0 + k * kThreads + threadIdx.x;
      const uint32_t w[4] = {mw[k].x, mw[k].y, mw[k].z, mw[k].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[k][q] = w[q] != 0u ? __ldg(xu + 4 * u + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t w[4] = {mw[k].x, mw[k].y, mw[k].z, mw[k].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float vv[4] = {v[k][q].x, v[k][q].y, v[k][q].z, v[k][q].w};
        const bool ok[4] = {(w[q] & 0xffu) != 0u, (w[q] & 0xff00u) != 0u,
                            (w[q] & 0xff0000u) != 0u, (w[q] & 0xff000000u) != 0u};
        f(vv, ok);
      }
    }
  }
  scalar_range(x, m, b, p1, f);
}

// Sum the CTAs' histograms of the searches in play across the cluster:
// this CTA's (its warps' copies of slot 0 merged) go to *mine*, and after
// cluster.sync() every CTA adds all of them in rank order into its own
// histograms (slot 0 into warp 0's copy), ready for RadixSelect::select().
__device__ void exchange(cg::cluster_group& cluster, const ip::RadixSelect<32>& sel,
                         ip::RadixShared& rs, uint32_t* mine) {
  const int G = static_cast<int>(cluster.num_blocks());
  __syncthreads();  // this sweep's counts
  for (int j = threadIdx.x; j < kQ * kBins; j += kThreads) {
    const int s = j / kBins, b = j - s * kBins;
    if (sel.slot[s] != s) continue;
    uint32_t v = 0u;
    if (s == 0) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        v += rs.hist[w * kBins + b];
        rs.hist[w * kBins + b] = 0u;
      }
    } else {
      uint32_t* h = rs.hist + (kWarps + s - 1) * kBins + b;
      v = *h;
      *h = 0u;
    }
    mine[j] = v;
  }
  cluster.sync();
  for (int j = threadIdx.x; j < kQ * kBins; j += kThreads) {
    const int s = j / kBins, b = j - s * kBins;
    if (sel.slot[s] != s) continue;
    uint32_t t = 0u;
    for (int q = 0; q < G; ++q) t += cluster.map_shared_rank(mine, q)[j];
    rs.hist[s == 0 ? b : (kWarps + s - 1) * kBins + b] = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
roi_stats_f32_frame_kernel(const float* __restrict__ frames,
                           const uint8_t* __restrict__ masks,
                           float* __restrict__ out, int C, int H, int W,
                           int p_lo1000, int p_hi1000, int warp_cap) {
  extern __shared__ __align__(16) uint32_t lists[];  // kWarps x warp_cap keys
  __shared__ ip::RadixShared rs;
  __shared__ uint32_t mine[2][kQ * kBins];  // published histograms, alternating
  __shared__ Partial part;
  __shared__ int iscratch[kWarps];
  __shared__ float fscratch[3 * kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane_id = static_cast<int>(blockIdx.x) / G;  // r * C + c
  const int r = lane_id / C, c = lane_id - r * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t HW = static_cast<size_t>(H) * W;
  const float* x = frames + static_cast<size_t>(c) * HW;
  const uint8_t* m = masks + static_cast<size_t>(r) * HW;
  const int band = (H + G - 1) / G;
  const int y0 = min(H, rank * band), y1 = min(H, y0 + band);
  const long long p0 = static_cast<long long>(y0) * W, p1 = static_cast<long long>(y1) * W;
  const bool vec = ip::aligned16(x) && ip::aligned16(m);
  WarpList list{lists + static_cast<size_t>(warp) * warp_cap, warp_cap, 0};

  ip::radix_clear(&rs);
  __syncthreads();

  // Sweep 1: count, sum, min, max; the top byte's histogram; every valid
  // key to its warp's list.
  ip::RadixSelect<32> sel(&rs);
  int cnt = 0;
  float s = 0.0f;
  float mn = __int_as_float(0x7f800000), mx = -__int_as_float(0x7f800000);
  sweep_band(x, m, p0, p1, vec, [&](const float (&v)[4], const bool (&mk)[4]) {
    uint32_t k[4];
    bool ok[4];
    int bin[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // branch-free, so the four keys overlap
      ok[e] = mk[e] && is_finite(v[e]);
      cnt += ok[e];
      s = ok[e] ? __fadd_rn(s, v[e]) : s;
      mn = ok[e] ? fminf(mn, v[e]) : mn;
      mx = ok[e] ? fmaxf(mx, v[e]) : mx;
      k[e] = ok[e] ? sortable_key(v[e]) : kInvalid;
      bin[e] = ok[e] ? sel.bin0(k[e]) : -1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
    list.push4(k, ok);
  });
  const bool listed = !__syncthreads_or(list.overflowed());
  const ip::Moments mo = ip::block_moments(cnt, s, mn, mx, iscratch, fscratch);
  if (tid == 0) {
    part.n = mo.n;
    part.sum = mo.sum;
    part.mn = mo.mn;
    part.mx = mo.mx;
  }
  exchange(cluster, sel, rs, mine[0]);  // its cluster.sync() publishes part
  int n = 0;
  float total = 0.0f, vmin = __int_as_float(0x7f800000), vmax = -__int_as_float(0x7f800000);
  for (int q = 0; q < G; ++q) {  // rank order: the same sums in every CTA
    const Partial* pq = cluster.map_shared_rank(&part, q);
    n += pq->n;
    total = __fadd_rn(total, pq->sum);
    vmin = fminf(vmin, pq->mn);
    vmax = fmaxf(vmax, pq->mx);
  }
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  const float mean = __fdiv_rn(total, nf);

  int ks[kQ];
  float gs[3];
  ip::quantile_positions(n, p_lo1000, p_hi1000, ks, gs);
  const bool any = n > 0;  // uniform across the cluster
  float var = 0.0f;
  // each warp's own list, in its order
  auto walk = [&](auto&& g) {
    for (int i = lane; i < list.n; i += 32) g(list.keys[i]);
  };
  auto count_key = [&](uint32_t k) { ip::hist_add(rs.hist, sel.bin(k)); };
  if (any) {
    sel.start(ks);
    sel.select();

    // Sweep 2: the variance and the second byte's histograms.
    float ss = 0.0f;
    if (listed) {
      walk([&](uint32_t k) {
        const float d = __fsub_rn(key_to_float(k), mean);
        ss = __fadd_rn(ss, __fmul_rn(d, d));
        count_key(k);
      });
    } else {
      sweep_band(x, m, p0, p1, vec, [&](const float (&v)[4], const bool (&mk)[4]) {
        int bin[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = mk[e] && is_finite(v[e]);
          const float d = __fsub_rn(v[e], mean);
          ss = ok ? __fadd_rn(ss, __fmul_rn(d, d)) : ss;
          bin[e] = ok ? sel.bin(sortable_key(v[e])) : -1;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
      });
    }
    ss = ip::block_sum(ss, fscratch);
    if (tid == 0) part.ss = ss;
    exchange(cluster, sel, rs, mine[1]);
    float sst = 0.0f;
    for (int q = 0; q < G; ++q) sst = __fadd_rn(sst, cluster.map_shared_rank(&part, q)->ss);
    var = __fdiv_rn(sst, nf);
    sel.select();

    // Sweep 3: the third byte's histograms; without the lists of sweep 1,
    // the keys that match a search's 16-bit prefix go to the lists.
    bool cands = false;
    if (listed) {
      walk(count_key);
    } else {
      list.n = 0;
      sweep_band(x, m, p0, p1, vec, [&](const float (&v)[4], const bool (&mk)[4]) {
        uint32_t k[4];
        int bin[4];
        bool take[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = mk[e] && is_finite(v[e]);
          k[e] = ok ? sortable_key(v[e]) : kInvalid;
          bin[e] = ok ? sel.bin(k[e]) : -1;
          take[e] = bin[e] >= 0;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
        list.push4(k, take);
      });
      cands = !__syncthreads_or(list.overflowed());
    }
    exchange(cluster, sel, rs, mine[0]);
    sel.select();

    // Sweep 4: the low byte, from the lists where they are whole.
    if (listed || cands) {
      walk(count_key);
    } else {
      sweep_band(x, m, p0, p1, vec, [&](const float (&v)[4], const bool (&mk)[4]) {
        int bin[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bin[e] = mk[e] && is_finite(v[e]) ? sel.bin(sortable_key(v[e])) : -1;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ip::hist_add(rs.hist, bin[e]);
      });
    }
    exchange(cluster, sel, rs, mine[1]);
    sel.select();
  }

  if (rank == 0 && tid == 0) {
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
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// Per device, once: the most keys per warp's list (the opt-in shared
// memory less the static), granted as dynamic shared memory, and clusters
// above the portable 8 allowed.  Later calls only read the cache, so a
// launch inside a CUDA graph capture sets no attribute.
bool g_ready[ip::kMaxDevices] = {};
int g_cap[ip::kMaxDevices] = {};

cudaError_t prepare(int device, int* cap) {
  if (device < 0 || device >= ip::kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_ready[device]) {
    const long long limit = ip::smem_limit(roi_stats_f32_frame_kernel, device);
    if (limit < 0) return cudaErrorInvalidValue;
    const int c = static_cast<int>(limit / (kWarps * static_cast<long long>(sizeof(uint32_t))));
    cudaError_t err = ip::prepare_kernel(roi_stats_f32_frame_kernel,
                                         static_cast<size_t>(c) * kWarps * sizeof(uint32_t));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(roi_stats_f32_frame_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    g_cap[device] = c;
    g_ready[device] = true;
  }
  *cap = g_cap[device];
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(unsigned blocks, int G, int warp_cap,
                                 cudaLaunchAttribute* attr, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(warp_cap) * kWarps * sizeof(uint32_t);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(G);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// The most keys each warp's list may hold on *device* (-1 on error).
int ip_roistats_frame_max_warp_cap(int device) {
  int cap = 0;
  return prepare(device, &cap) == cudaSuccess ? cap : -1;
}

// The largest cluster size in 16, 8, 4, 2, 1 of which the current device can
// hold at least one cluster with lists of *warp_cap* keys (-1 on error).
int ip_roistats_frame_max_cluster(int warp_cap) {
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || prepare(dev, &cap) != cudaSuccess ||
      warp_cap < 0 || warp_cap > cap) {
    return -1;
  }
  for (int g = kMaxCluster; g >= 1; g /= 2) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(static_cast<unsigned>(g), g, warp_cap,
                                                 &attr, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, roi_stats_f32_frame_kernel, &cfg) ==
            cudaSuccess &&
        clusters > 0) {
      return g;
    }
    cudaGetLastError();  // clear a refusal before the next size
  }
  return -1;
}

// frames (C, H, W) f32, masks (N, H, W) u8 (0/1), out (N, C, 9) f32 in the
// order of ops.stats.STAT_FIELDS (npx as a float); all contiguous on the
// current device.  Launches N * C clusters of G CTAs (1 <= G <= 16) with
// lists of *warp_cap* keys per warp on *stream*; returns the cudaError_t
// of the launch (0 = success).
int ip_roistats_f32_frame(const void* frames, const void* masks, void* out, int N, int C,
                          int H, int W, int p_lo1000, int p_hi1000, int G, int warp_cap,
                          void* stream) {
  const long long lanes = static_cast<long long>(N) * C;
  if (lanes == 0) return 0;
  if (G < 1 || G > kMaxCluster || warp_cap < 0 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (warp_cap > cap) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(static_cast<unsigned>(lanes * G), G, warp_cap, &attr,
                    static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, roi_stats_f32_frame_kernel,
                           static_cast<const float*>(frames),
                           static_cast<const uint8_t*>(masks), static_cast<float*>(out), C, H,
                           W, p_lo1000, p_hi1000, warp_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ip_frame_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

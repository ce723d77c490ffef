// Device helpers shared by the per-ROI statistics kernels
// (tilestats_u16.cu, roistats_f32.cu): the int32 np.percentile position
// arithmetic, block-wide reductions, 16-byte cp.async staging, and the
// radix select of six order statistics (8-bit digits, most significant
// first) that both kernels run over their keys, in CTAs of kThreads.
//
// Why plain shared atomics and not warp-aggregated ones: on an H100, one
// __match_any_sync per key made the histogram sweeps several times slower
// than one plain shared atomic per key, on crowded and on uniform values
// alike (PERF.md, Findings).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ip {

// 512 threads: the sweeps are bound by issue and latency, and at one or two
// CTAs per SM (144 or 216 CTAs on 132 SMs at the bench shapes) 16 warps per
// CTA hide it better than 8 (PERF.md, Findings).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;  // CTAs per SM the register budget must allow
constexpr int kQ = 6;          // (p_lo, median, p_hi) x (k, k+1)
constexpr int kBins = 256;     // one 8-bit digit
static_assert(kThreads % kBins == 0, "the scan gives each of the first kBins threads a bin");

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

// Block-wide sum: warp shuffles, then one partial per warp in shared
// memory that every thread combines itself (so all threads hold the same
// result).  The trailing barrier lets the scratch be reused at once.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = __fadd_rn(r, scratch[w]);
  __syncthreads();
  return r;
}

// Count, sum, min and max of a sweep in one block-wide reduction (one
// barrier pair instead of four); every thread gets the totals.
struct Moments {
  int n;
  float sum, mn, mx;
};

__device__ __forceinline__ Moments block_moments(int n, float s, float mn, float mx,
                                                 int* iscratch, float* fscratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, o);
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    iscratch[warp] = n;
    fscratch[warp] = s;
    fscratch[kWarps + warp] = mn;
    fscratch[2 * kWarps + warp] = mx;
  }
  __syncthreads();
  Moments r{iscratch[0], fscratch[0], fscratch[kWarps], fscratch[2 * kWarps]};
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    r.n += iscratch[w];
    r.sum = __fadd_rn(r.sum, fscratch[w]);
    r.mn = fminf(r.mn, fscratch[kWarps + w]);
    r.mx = fmaxf(r.mx, fscratch[2 * kWarps + w]);
  }
  __syncthreads();
  return r;
}

// 16-byte asynchronous copy from device to shared memory (both addresses
// 16-byte aligned); cp_async_wait_all waits for this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Histograms of a radix select.  Slot 0 -- the top digit's histogram, and
// at lower levels the one that every search sharing the first search's
// prefix counts into, where crowded keys land -- has one sub-histogram per
// warp (words w * 256 ...), merged in the scan; slots 1..5 (searches whose
// prefix differs from every earlier search's) have one each (words
// (kWarps + s - 1) * 256 ...).  Plain shared atomics: Hopper absorbs lanes
// of one warp hitting one address, and the per-warp copies keep the warps
// of a CTA apart on the crowded slot.
constexpr int kHistWords = (kWarps + kQ - 1) * kBins;

// Count one key into histogram word *w* (from RadixSelect::bin0 / bin);
// w < 0 counts nothing.
__device__ __forceinline__ void hist_add(uint32_t* hist, int w) {
  if (w >= 0) atomicAdd(hist + w, 1u);
}

// Append the four *v[e]* where *take[e]* to *list* (capacity *cap*): one
// scan of the lanes' counts and one atomic per warp.  Every lane of the
// warp must call it; *count* may grow past *cap* (the list is then
// incomplete, and the caller must not use it).
__device__ __forceinline__ void append4(uint32_t* list, int* count, int cap,
                                        const uint32_t (&v)[4], const bool (&take)[4]) {
  const int c = take[0] + take[1] + take[2] + take[3];
  if (!__any_sync(0xffffffffu, c > 0)) return;
  const int lane = threadIdx.x & 31;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(count, incl);
  int i = __shfl_sync(0xffffffffu, base, 31) + incl - c;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (take[e]) {
      if (i < cap) list[i] = v[e];
      ++i;
    }
  }
}

// Shared-memory state of a radix select: the histograms, the scan's warp
// totals, and each search's digits and rank as the bin owners publish them.
struct RadixShared {
  uint32_t hist[kHistWords];
  uint32_t wsum[kWarps * kQ];
  uint32_t key[kQ];
  int rank[kQ];
};

// Zero the histograms; the caller's next barrier publishes it.
__device__ __forceinline__ void radix_clear(RadixShared* sh) {
  for (int j = threadIdx.x; j < kHistWords; j += kThreads) sh->hist[j] = 0;
}

// The six exact order statistics of kBits-bit unsigned keys by radix
// select, 8 bits per level, most significant first: a sweep counts every
// valid key whose higher digits equal a search's prefix into that search's
// histogram of the next digit (bin()), then select() scans the histograms
// and gives each search the bin holding its rank.  kBits / 8 sweeps find
// every key exactly.  Every thread holds the same copy of the state and
// takes the same branches; select() holds barriers.
template <int kBits>
struct RadixSelect {
  RadixShared* sh;
  uint32_t key[kQ];   // the digits found so far, in place
  int rank[kQ];       // rank inside the bucket of key's prefix
  int slot[kQ];       // the histogram search q counts into (the first
                      // search with the same prefix)
  uint32_t pref[kQ];  // search q's prefix at this level
  int level;

  int warp_base;      // this warp's copy of slot 0
  bool single;        // every search counts into slot 0

  __device__ explicit RadixSelect(RadixShared* s)
      : sh(s), level(0), warp_base((threadIdx.x >> 5) * kBins), single(true) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      key[q] = 0;
      rank[q] = 0;
      slot[q] = 0;
      pref[q] = 0;
    }
  }

  // A prefix no key has at a level below the top: prefixes there are at
  // most kBits - 8 bits wide.
  static constexpr uint32_t kNoPrefix = 0xffffffffu;

  // The ranks to find, before the first select().
  __device__ __forceinline__ void start(const int (&ks)[kQ]) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) rank[q] = ks[q];
  }

  // Histogram word of a key at level 0: its top digit, in this warp's copy.
  __device__ __forceinline__ int bin0(uint32_t k) const {
    return warp_base + static_cast<int>(k >> (kBits - 8));
  }

  // Histogram word of a key at a lower level, or -1 when its higher digits
  // match no search.  Branch-free: a slot that leads no search holds a
  // prefix no key has (kNoPrefix), so one compare per slot decides.
  __device__ __forceinline__ int bin(uint32_t k) const {
    const int shift = kBits - 8 * (level + 1);
    const int d = static_cast<int>((k >> shift) & 0xffu);
    const uint32_t p = k >> (shift + 8);
    int b = p == pref[0] ? warp_base + d : -1;
    if (single) return b;  // uniform: every search shares slot 0's prefix
#pragma unroll
    for (int s = 1; s < kQ; ++s) b = p == pref[s] ? (kWarps + s - 1) * kBins + d : b;
    return b;
  }

  // After a sweep's counts and a barrier: scan, pick each search's digit,
  // clear the histograms and move to the next level.
  __device__ void select() {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int shift = kBits - 8 * (level + 1);
    const bool scans = tid < kBins;  // whole warps: one bin per thread
    uint32_t c[kQ] = {}, incl[kQ] = {};
    if (scans) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {  // slot 0: merge the warps' copies
        c[0] += sh->hist[w * kBins + tid];
        sh->hist[w * kBins + tid] = 0u;
      }
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        if (slot[s] != s) continue;  // uniform: the same in every thread
        if (s > 0) {
          uint32_t* h = sh->hist + (kWarps + s - 1) * kBins + tid;
          c[s] = *h;
          *h = 0u;
        }
        incl[s] = c[s];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(0xffffffffu, incl[s], o);
          if (lane >= o) incl[s] += t;
        }
        if (lane == 31) sh->wsum[warp * kQ + s] = incl[s];
      }
    }
    __syncthreads();
    if (scans) {
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        if (slot[s] != s) continue;
        uint32_t base = 0;
        for (int w = 0; w < warp; ++w) base += sh->wsum[w * kQ + s];
        incl[s] += base;  // now inclusive over the whole block
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        uint32_t cq = 0, iq = 0;
#pragma unroll
        for (int s = 0; s < kQ; ++s) {
          if (slot[q] == s) {
            cq = c[s];
            iq = incl[s];
          }
        }
        const uint32_t r = static_cast<uint32_t>(rank[q]);
        if (cq > 0 && r < iq && r >= iq - cq) {  // this thread's bin holds it
          sh->key[q] = key[q] | (static_cast<uint32_t>(tid) << shift);
          sh->rank[q] = static_cast<int>(r - (iq - cq));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      key[q] = sh->key[q];
      rank[q] = sh->rank[q];
    }
    ++level;
    // the next level's prefixes: searches with equal digits so far share
    // the histogram of the first of them
    uint32_t p[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      p[q] = key[q] >> shift;
      slot[q] = q;
#pragma unroll
      for (int q2 = q - 1; q2 >= 0; --q2) {
        if (p[q2] == p[q]) slot[q] = q2;
      }
      pref[q] = slot[q] == q ? p[q] : kNoPrefix;
    }
    single = true;
#pragma unroll
    for (int q = 1; q < kQ; ++q) single = single && slot[q] == 0;
  }
};

// Set the opt-in dynamic shared memory of *kernel* and ask for the largest
// shared-memory carveout, so that several CTAs fit on an SM.
template <typename K>
inline cudaError_t prepare_kernel(K kernel, size_t dyn_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn_bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

// prepare_kernel once per device for the largest size asked so far:
// *granted* holds that size per device (the caller's array at namespace
// scope, one per kernel, shared by its launches and occupancy queries).
// The attribute is never lowered, so a smaller query cannot undo what a
// larger launch needs; it costs nothing on later launches.
constexpr int kMaxDevices = 64;
template <typename K>
inline cudaError_t prepare_once(K kernel, size_t dyn_bytes, size_t* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return prepare_kernel(kernel, dyn_bytes);
  if (granted[dev] >= dyn_bytes && granted[dev] > 0) return cudaSuccess;
  err = prepare_kernel(kernel, dyn_bytes);
  if (err == cudaSuccess) granted[dev] = dyn_bytes;
  return err;
}

// Resident CTAs per SM of *kernel* at kThreads threads and *dyn_bytes* of
// dynamic shared memory, or -1 on error.  A kernel with dynamic shared
// memory passes its *granted* array (prepare_once); one without passes
// nullptr and keeps its attributes as they are.
template <typename K>
inline int occupancy(K kernel, size_t dyn_bytes, size_t* granted) {
  if (granted != nullptr && prepare_once(kernel, dyn_bytes, granted) != cudaSuccess) {
    return -1;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    dyn_bytes) != cudaSuccess) {
    return -1;
  }
  return n;
}

// The most dynamic shared memory *kernel* may take on *device*: the opt-in
// limit less its static shared memory; -1 on error.
template <typename K>
inline long long smem_limit(K kernel, int device) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return static_cast<long long>(v) - static_cast<long long>(attr.sharedSizeBytes);
}

}  // namespace ip

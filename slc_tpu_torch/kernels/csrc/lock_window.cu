// The two middle values of |dP/du| over a frame-0 absolute map, for the
// tracker's lock window (slc_tpu_torch/ops/demod.py suggest_lock_window).
//
// Not a port of a TPU kernel: slc_tpu computes this median with numpy on
// the host (slc_tpu/ops/demod.py:297-314), once per sequence, and so did
// the port, with the card idle for ~30 ms at 1024x1280. Here it stays on
// the card beside the map.
//
// Over the interior pixels [1:-1, 1:-1] of a float32 (h, w) map P:
//   g = 0.5 * (P[v, u+1] - P[v, u-1])  in float64 (IEEE, as numpy),
//   valid where P[v, u] > 0 and |g| > 1e-3,
// the count n of valid pixels and the order statistics (n-1)//2 and n//2
// of |g| (numpy's two middle values; one value twice for an odd n).
//
// Exact radix select. A non-negative double's bit pattern, read as an
// unsigned 64-bit integer, sorts as the double does, so the k-th smallest
// |g| is found digit by digit from the top: kPasses passes of 12-bit
// digits (the last of 4 bits), each one launch.
//   - Every pass reads P again (5.2 MB at 1024x1280, resident in the 50
//     MB L2 after the first), recomputes g and its key, and histograms
//     the pass's digit of the keys whose higher digits match the prefix
//     chosen so far for either of the two ranks; a block histograms in
//     shared memory with warp-aggregated atomics, then adds its non-zero
//     bins to the histogram in global memory.
//   - The pass's last block to finish (a ticket counter) scans that
//     histogram, picks each rank's bucket, narrows the rank, extends the
//     prefix, zeroes the histogram for the next pass and writes the
//     result so far. The first pass also takes n, the histogram's total.
//   - Until the two ranks part (an even n whose middle values differ in
//     a digit), one histogram serves both; after, each has its own.
// Bound: the passes' reads of P, ~31 MB of L2 traffic in all at
// 1024x1280, and their launches; the host sees only the 24-byte result.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // pixels a thread loads before it uses them
constexpr int kDigitBits = 12;
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = (64 + kDigitBits - 1) / kDigitBits;  // 6
constexpr int kPer = kBins / kThreads;  // bins a thread scans
constexpr unsigned kNoBin = 0xffffffffu;

// Global state of one call, zeroed before the first pass.
struct Work {
  unsigned int hist[2][kBins];
  unsigned long long prefix[2];  // the ranks' keys, digits chosen so far
  unsigned long long rank[2];    // each rank within its prefix's keys
  unsigned long long n;          // valid pixels (after the first pass)
  unsigned int split;            // the two prefixes differ
  unsigned int ticket;           // blocks done in this pass
};

// The pass's digit: the key's bits [shift, hi), hi = 64 - 12 * pass.
__device__ __forceinline__ int digit_hi(int pass) {
  return 64 - kDigitBits * pass;
}
__device__ __forceinline__ int digit_shift(int pass) {
  const int s = digit_hi(pass) - kDigitBits;
  return s > 0 ? s : 0;
}

// A pixel's |g| as its key, from its left, centre and right values, and
// whether the pixel is valid, exactly as numpy: float32 widened to float64, an IEEE
// subtraction, a multiply by 0.5.
__device__ __forceinline__ bool abs_gradient(float l, float c, float r,
                                             unsigned long long* key) {
  const double g = __dmul_rn(0.5, __dsub_rn((double)r, (double)l));
  const double a = fabs(g);
  *key = (unsigned long long)__double_as_longlong(a);
  return (double)c > 0.0 && a > 1e-3;
}

// Exclusive scan over the block of each thread's ``mine``: the sum of the
// threads below it; the block's total into *s_total. Every thread calls it.
__device__ unsigned long long block_scan(unsigned long long mine,
                                         unsigned long long* s_warp,
                                         unsigned long long* s_total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  __syncthreads();  // s_warp may still be read from a previous call
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (tid == 0) {
    unsigned long long run = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      const unsigned long long t = s_warp[k];
      s_warp[k] = run;
      run += t;
    }
    *s_total = run;
  }
  __syncthreads();
  return s_warp[warp] + inc - mine;
}

// The thread's kPer consecutive bins of ``hist`` (read from L2, where the
// other blocks' atomics landed) and the count of keys in the bins below
// them.
__device__ unsigned long long load_bins(const unsigned int* hist,
                                        unsigned int (&v)[kPer],
                                        unsigned long long* s_warp,
                                        unsigned long long* s_total) {
  unsigned long long mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = __ldcg(hist + threadIdx.x * kPer + j);
    mine += v[j];
  }
  return block_scan(mine, s_warp, s_total);
}

// Which of the thread's bins holds ``rank`` (only the thread that has it
// writes) and the count of keys below that bin.
__device__ void find_rank(const unsigned int (&v)[kPer],
                          unsigned long long below, unsigned long long rank,
                          int* s_bin, unsigned long long* s_below) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (rank >= below && rank < below + v[j]) {
      *s_bin = threadIdx.x * kPer + j;
      *s_below = below;
    }
    below += v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    lw_radix_pass(const float* __restrict__ p, int h, int w, Work* work,
                  unsigned long long* out, int pass) {
  __shared__ unsigned int s_hist[2 * kBins];
  __shared__ unsigned long long s_warp[kThreads / 32];
  __shared__ unsigned long long s_below[2], s_total;
  __shared__ int s_bin[2];
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31;
  if (pass > 0 && work->n == 0) return;  // nothing valid: result written
  const int hi = digit_hi(pass), shift = digit_shift(pass);
  const unsigned int mask = (1u << (hi - shift)) - 1u;
  const bool split = work->split != 0;
  const unsigned long long pre0 = work->prefix[0], pre1 = work->prefix[1];
  const int nh = split ? 2 : 1;

  for (int b = tid; b < nh * kBins; b += kThreads) s_hist[b] = 0;
  __syncthreads();

  // Interior rows 1 .. h-2 of the flat map; border columns skipped. A
  // tile's base is the same for the whole block, so every warp runs the
  // loop alike and its lanes meet at the warp-wide match.
  // (The wrapper keeps h * w under 2^30, so int indices do.)
  const int begin = w, end = (h - 1) * w, tile = kThreads * kUnroll;
  for (int base = begin + blockIdx.x * tile; base < end;
       base += gridDim.x * tile) {
    float l[kUnroll], c[kUnroll], r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = base + k * kThreads + tid;
      if (i < end) {
        l[k] = __ldg(p + i - 1);
        c[k] = __ldg(p + i);
        r[k] = __ldg(p + i + 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = base + k * kThreads + tid;
      unsigned int bin = kNoBin;
      if (i < end) {
        const int u = i % w;
        unsigned long long key;
        if (u != 0 && u != w - 1 && abs_gradient(l[k], c[k], r[k], &key)) {
          const unsigned int d = (unsigned int)(key >> shift) & mask;
          if (pass == 0 || (key >> hi) == (pre0 >> hi)) {
            bin = d;
          } else if (split && (key >> hi) == (pre1 >> hi)) {
            bin = kBins + d;
          }
        }
      }
      // Warp-aggregated: one shared atomic per distinct bin in the warp.
      if (__ballot_sync(0xffffffffu, bin != kNoBin)) {
        const unsigned int peers = __match_any_sync(0xffffffffu, bin);
        if (bin != kNoBin && lane == __ffs(peers) - 1)
          atomicAdd(&s_hist[bin], (unsigned int)__popc(peers));
      }
    }
  }
  __syncthreads();
  unsigned int* g_hist = &work->hist[0][0];
  for (int b = tid; b < nh * kBins; b += kThreads) {
    const unsigned int v = s_hist[b];
    if (v) atomicAdd(g_hist + b, v);
  }

  // The last block to finish picks the buckets.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&work->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // Bins past the pass's digit hold 0: the last pass's 4-bit digit
  // leaves the scan over all kBins right.
  unsigned int v[kPer];
  const unsigned long long below0 =
      load_bins(work->hist[0], v, s_warp, &s_total);
  unsigned long long n = work->n, rank0 = work->rank[0],
                     rank1 = work->rank[1];
  if (pass == 0) {
    n = s_total;
    if (n == 0) {
      if (tid == 0) out[0] = out[1] = out[2] = 0;
      return;  // work->n stays 0: the later passes return at once
    }
    rank0 = (n - 1) / 2;
    rank1 = n / 2;
  }
  find_rank(v, below0, rank0, &s_bin[0], &s_below[0]);
  if (split) {
    const unsigned long long below1 =
        load_bins(work->hist[1], v, s_warp, &s_total);
    find_rank(v, below1, rank1, &s_bin[1], &s_below[1]);
  } else {
    find_rank(v, below0, rank1, &s_bin[1], &s_below[1]);
  }
  __syncthreads();
  if (tid == 0) {
    const unsigned long long p0 =
        pre0 | ((unsigned long long)s_bin[0] << shift);
    const unsigned long long p1 =
        (split ? pre1 : pre0) | ((unsigned long long)s_bin[1] << shift);
    work->n = n;
    work->rank[0] = rank0 - s_below[0];
    work->rank[1] = rank1 - s_below[1];
    work->prefix[0] = p0;
    work->prefix[1] = p1;
    work->split = p0 != p1;
    work->ticket = 0;
    out[0] = n;
    out[1] = p0;
    out[2] = p1;
  }
  for (int b = tid; b < nh * kBins; b += kThreads) g_hist[b] = 0;
}

}  // namespace

// The bytes of a call's workspace, which the wrapper allocates.
extern "C" long slc_lock_window_work_bytes() { return (long)sizeof(Work); }

// n and the bits of the two middle |g| of the (h, w) float32 map ``p``
// into out[0..2] (uint64), by kPasses launches on ``stream`` after
// zeroing ``work`` (slc_lock_window_work_bytes()). Returns a cudaError_t.
extern "C" int slc_lock_window(const float* p, int h, int w, void* work,
                               unsigned long long* out,
                               cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(Work), stream);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long pixels = h > 2 ? (long long)(h - 2) * w : 0;
  const long long tiles = (pixels + kThreads * kUnroll - 1) /
                          (kThreads * kUnroll);
  long long grid = 2LL * sms;
  if (tiles < grid) grid = tiles;
  if (grid < 1) grid = 1;
  for (int pass = 0; pass < kPasses; ++pass) {
    lw_radix_pass<<<(unsigned int)grid, kThreads, 0, stream>>>(
        p, h, w, static_cast<Work*>(work), out, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

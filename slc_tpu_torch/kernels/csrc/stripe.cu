// Stripe regression on 2-D tiles.
//
// Replaces slc_tpu/pallas/stripe.py:102 stripe_regression_pallas: the
// window-row vertical box sum (int32, exact) -> interior mask -> max/min
// offsets over [-r, r) -> optional parabola, exact or quantized to fbits
// bits (fast sub-pixel mode). It reads the u8 frame and writes two f32
// maps, 9 B/px (3.5 us at 1.3 MP on an H100); its bound is the plain
// version's roll tournament, 231 operations/px (4.5 us). Its time is set
// by the latency of each phase and by how evenly the SMs are loaded. A
// block owns a kTileH x kTileW tile, in two phases, as track's first two
// (dynamic_step.cu):
//
//   1. the frame window (r rows above and below the tile, r + 1 columns to
//      its left and r to its right) staged in shared memory in 16-byte
//      chunks (stage_tiles; one byte at a time at a ragged width), then
//      its interior-masked box sums from shared memory by all threads
//      (box_sums_smem, exact integers);
//   2. per thread K = 4 neighbouring pixels of one row: the windowed
//      extrema from keys that carry the offset (window_extrema, each tap
//      loaded once for the four windows), the parabola fraction
//      (extrema_from_keys: the reference's tie rule), and the two strips
//      stored as float4 where the maps allow.
//
// 40-row tiles make 260 blocks at 1024x1280: one wave of at most two
// blocks per SM (132 SMs). A block's 640 threads take its 1280 items in
// two rounds, under 51 registers each (tools/compare_lock_builds.py timed
// shorter tiles and other block sizes against this: all slower). A warp
// takes 8 groups of a row on 4 rows, so its taps, on rows of odd pitch,
// hit 32 distinct banks.
#include "common.cuh"

namespace {

constexpr int kTileW = 128, kTileH = 40, kK = 4;
constexpr int kThreads = 640;

// Shared memory of a tile: the box sums vs on the tile's columns plus the
// windows' reach, r + 1 left and r right (nv columns from x0 - r - 1, odd
// pitch pv), then the frame rows of the box sums (frows), staged from a
// 16-byte boundary ``lead`` columns left of x0 (off = the box sums' first
// column in a staged row).
struct StripePlan {
  static constexpr int G = kTileW / kK;   // pixel groups of a tile row
  int nv, pv, lead, off, nchunk, fpitch, frows;
  __host__ __device__ explicit StripePlan(int r)
      : nv(kTileW + 2 * r + 1), pv((kTileW + 2 * r + 1) | 1),
        lead((r + 1 + 15) / 16 * 16), off(lead - (r + 1)),
        nchunk((off + nv + 15) / 16), fpitch(16 * nchunk),
        frows(kTileH + 2 * r) {}
  static_assert(kTileH % 4 == 0 && G % 8 == 0, "warps of 8 x 4 items");
  __host__ __device__ int vs_bytes() const {
    return (int)(sizeof(int) * kTileH * pv + 15) / 16 * 16;
  }
  __host__ __device__ size_t smem_bytes() const {
    return vs_bytes() + frows * fpitch;
  }
};

// VEC: float4 stores (w % 4 == 0, both maps 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
stripe_kernel(const uint8_t* __restrict__ frame, float* __restrict__ sw_out,
              float* __restrict__ sb_out, int h, int w, int r, int subpixel,
              int fbits, bool vec_frame) {
  using Plan = StripePlan;
  constexpr int K = kK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Plan pl(r);
  int* vs = reinterpret_cast<int*>(smem_raw);
  uint8_t* fwin = smem_raw + pl.vs_bytes();
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;

  stage_tiles<uint8_t>(frame, h, w, vec_frame, y0 - r, pl.frows,
                       x0 - pl.lead, pl.nchunk, 1, 0, fwin, pl.fpitch, 0);
  __syncthreads();
  box_sums_smem(fwin, pl.fpitch, pl.off, h, w, r, y0, kTileH, x0 - r - 1,
                pl.nv, vs, pl.pv);
  __syncthreads();

  constexpr int gblocks = Plan::G / 8;
  for (int q = threadIdx.x; q < Plan::G * kTileH; q += kThreads) {
    const int wi = q >> 5, l = q & 31;
    const int g = wi % gblocks * 8 + (l & 7);
    const int rr = wi / gblocks * 4 + (l >> 3);
    const int gy = y0 + rr, gx0 = x0 + K * g;
    if (gy >= h || gx0 >= w) continue;
    float sw[K] = {}, sb[K] = {};
    if (gy >= r && gy < h - r && gx0 + K > r && gx0 < w - r) {
      const int* x = vs + rr * pl.pv + K * g + 1;   // x[j]: tap j
      int kmax[K], kmin[K];
      window_extrema<K>(x, 2 * r, kmax, kmin);
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int gx = gx0 + m;
        if (gx >= r && gx < w - r)
          extrema_from_keys(x, m + r, kmax[m], kmin[m], subpixel != 0, fbits,
                            &sw[m], &sb[m]);
      }
    }
    const long long gi0 = (long long)gy * w + gx0;
    const bool full = VEC && gx0 + K <= w;
    store_group<K>(sw_out, gi0, full, gx0, w, sw);
    store_group<K>(sb_out, gi0, full, gx0, w, sb);
  }
}

}  // namespace

extern "C" int slc_stripe(const uint8_t* frame, float* sw, float* sb, int h,
                          int w, int window, int subpixel, int fbits,
                          cudaStream_t stream) {
  const int r = window / 2;
  const bool vec = w % 4 == 0 && aligned16(sw) && aligned16(sb);
  const auto kern = vec ? stripe_kernel<true> : stripe_kernel<false>;
  const size_t smem = StripePlan(r).smem_bytes();
  const cudaError_t err = fit_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const bool vec_frame = w % 16 == 0 && aligned16(frame);
  kern<<<grid, kThreads, smem, stream>>>(frame, sw, sb, h, w, r, subpixel,
                                         fbits, vec_frame);
  return (int)cudaGetLastError();
}

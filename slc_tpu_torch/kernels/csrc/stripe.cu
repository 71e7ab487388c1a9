// Stripe regression on 2-D tiles.
//
// Replaces slc_tpu/pallas/stripe.py:102 stripe_regression_pallas: the
// window-row vertical box sum (int32, exact) -> interior mask -> max/min
// offsets over [-r, r) -> optional parabola, exact or quantized to fbits
// bits (fast sub-pixel mode). It reads the u8 frame and
// writes two f32 maps, 9 B/px; the halo re-reads go through L1/L2. A
// block computes the box sums of its tile plus r+1 columns of halo on the
// left and r on the right into shared memory once, and each thread then
// scans its pixels' 2r offsets there, so the frame is read about once per
// tile instead of once per offset.
#include "common.cuh"

namespace {

constexpr int kTileW = 128;   // output columns per block
constexpr int kTileH = 32;    // output rows per block

__global__ void stripe_kernel(const uint8_t* __restrict__ frame,
                              float* __restrict__ sw_out,
                              float* __restrict__ sb_out, int h, int w,
                              int r, int subpixel, int fbits) {
  extern __shared__ int vs[];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int ncols = kTileW + 2 * r + 1;
  const int xs = x0 - (r + 1);          // global column of vs[.][0]
  box_sums_tile(frame, h, w, r, y0, kTileH, xs, ncols, vs);
  __syncthreads();

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int p = tid; p < kTileH * kTileW; p += nthreads) {
    const int rr = p / kTileW, cx = p % kTileW;
    const int gy = y0 + rr, gx = x0 + cx;
    if (gy >= h || gx >= w) continue;
    float sw = 0.0f, sb = 0.0f;
    if (gy >= r && gy < h - r && gx >= r && gx < w - r)
      extrema_px(vs + rr * ncols, cx + r + 1, r, subpixel != 0, fbits, &sw,
                 &sb);
    sw_out[(size_t)gy * w + gx] = sw;
    sb_out[(size_t)gy * w + gx] = sb;
  }
}

}  // namespace

extern "C" int slc_stripe(const uint8_t* frame, float* sw, float* sb, int h,
                          int w, int window, int subpixel, int fbits,
                          cudaStream_t stream) {
  const int r = window / 2;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const size_t smem = sizeof(int) * kTileH * (kTileW + 2 * r + 1);
  stripe_kernel<<<grid, 256, smem, stream>>>(frame, sw, sb, h, w, r,
                                             subpixel, fbits);
  return (int)cudaGetLastError();
}

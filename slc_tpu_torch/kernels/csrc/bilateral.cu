// Hole-aware 3x3 bilateral depth filter, one thread per output pixel.
//
// Replaces slc_tpu/pallas/bilateral.py:61 bilateral_filter_pallas: the
// reference's bilateralFilter(d=3, sigmaColor=10, sigmaSpace=25)
// (depthMapUtils.cpp:179) with zero-depth pixels as missing. A block
// stages its 32x8 tile and a 1-px halo in shared memory; out-of-image
// neighbours are stored as 0 and so count as missing, the border rule the
// TPU kernel runs. It reads one f32 map and writes one, 8 B/px, so device
// memory bounds it; the halo re-reads stay on chip.
//
// The arithmetic is the plain PyTorch path's, tap for tap in the same
// order: w = exp((v - z)^2 * inv2sc + d2 * inv2ss), num += w * v,
// den += w, each operation rounded on its own (no FMA contraction), and
// out = num / max(den, 1e-12) where z != 0.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;

__global__ void bilateral_kernel(const float* __restrict__ img,
                                 float* __restrict__ out, int h, int w,
                                 float inv2sc, float inv2ss) {
  __shared__ float tile[kTileH + 2][kTileW + 2];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < (kTileH + 2) * (kTileW + 2); i += kTileW * kTileH) {
    const int ty = i / (kTileW + 2), tx = i % (kTileW + 2);
    const int gy = y0 + ty - 1, gx = x0 + tx - 1;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                       ? img[(size_t)gy * w + gx]
                       : 0.0f;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy >= h || gx >= w) return;
  const float z = tile[threadIdx.y + 1][threadIdx.x + 1];
  float res = 0.0f;
  if (z != 0.0f) {
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const float v = tile[threadIdx.y + 1 + dy][threadIdx.x + 1 + dx];
        if (v == 0.0f) continue;  // a hole or outside the image
        const float d = __fsub_rn(v, z);
        const float space = __fmul_rn((float)(dy * dy + dx * dx), inv2ss);
        const float wt =
            expf(__fadd_rn(__fmul_rn(__fmul_rn(d, d), inv2sc), space));
        num = __fadd_rn(num, __fmul_rn(wt, v));
        den = __fadd_rn(den, wt);
      }
    }
    res = __fdiv_rn(num, fmaxf(den, 1e-12f));
  }
  out[(size_t)gy * w + gx] = res;
}

}  // namespace

extern "C" int slc_bilateral(const float* img, float* out, int h, int w,
                             float inv2sc, float inv2ss,
                             cudaStream_t stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  bilateral_kernel<<<grid, dim3(kTileW, kTileH), 0, stream>>>(
      img, out, h, w, inv2sc, inv2ss);
  return (int)cudaGetLastError();
}

// Multi-frequency heterodyne absolute decode, one thread per pixel.
//
// Replaces slc_tpu/pallas/heterodyne.py:201 heterodyne_decode_pallas. Per
// pixel: N-step phase of each of the F fringe frequencies (atan2f) ->
// wrapped fraction u_f = pix_f / T_f -> minimum modulation over the
// frequencies -> beat cascade u = frac(u_i - u_{i+1}) up to one coarse
// phase -> unwrap down the left spine, k = round(x/T - u),
// x = (k + u) * T -> wrap into [0, extent) -> optional modulation mask ->
// triangulation with C and D rebuilt from their six coefficients. It
// reads F*N u8 planes and writes 4 f32 maps: 28 B/px at 12 planes, so
// device-memory bandwidth bounds it.
//
// The arithmetic is the plain PyTorch path's, operation for operation:
// the step coefficients are the host's float32 cos/sin values (not the
// exact {1, 0, -1, 0} of the N = 4 closed form), and every product, sum
// and quotient is rounded on its own (__fmul_rn, __fadd_rn, IEEE
// division; no FMA contraction), so a fringe-order rounding falls as the
// plain path's does except where atan2f itself differs.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kMaxFreq = 8;
constexpr int kMaxSteps = 16;
constexpr float kTwoPi = 6.283185307179586f;

// Per-call constants, computed on the host as slc_tpu_torch/ops/unwrap.py
// and ops/phase.py compute them.
struct Het {
  int nfreq, n;
  float period[kMaxFreq];       // T_f, float32
  float scale[kMaxFreq];        // float32(T_f) / float32(2 pi)
  float spine[kMaxFreq - 1];    // period of the leftmost phase per level
  float coarse, extent;
  float ck[kMaxSteps], sk[kMaxSteps];  // cos / sin of the step angles
  float two_over_n;
  int use_mod;
  float min_mod;
};

__device__ __forceinline__ float wrap_delta(float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fsub_rn(d, floorf(d));
}

__global__ void heterodyne_kernel(const uint8_t* __restrict__ images,
                                  float* __restrict__ x_out,
                                  float* __restrict__ y_out,
                                  float* __restrict__ z_out,
                                  float* __restrict__ pu_out, int h, int w,
                                  Het hp, Tri t) {
  const size_t npx = (size_t)h * w;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= npx) return;
  const int row = (int)(idx / w), col = (int)(idx % w);

  float frac[kMaxFreq];
  float mod_min = CUDART_INF_F;
#pragma unroll
  for (int f = 0; f < kMaxFreq; ++f) {
    if (f >= hp.nfreq) break;
    // N-step phase (slc_tpu_torch/ops/phase.py:25-37): coefficient sums
    // in step order, then the 2/N scale.
    float s = 0.0f, c = 0.0f;
    for (int k = 0; k < hp.n; ++k) {
      const float img = (float)images[(size_t)(f * hp.n + k) * npx + idx];
      s = __fadd_rn(s, __fmul_rn(img, hp.ck[k]));
      c = __fadd_rn(c, __fmul_rn(img, hp.sk[k]));
    }
    s = __fmul_rn(s, hp.two_over_n);
    c = __fmul_rn(c, hp.two_over_n);
    // Wrapped projector offset in (0, T] (ops/phase.py:40-49).
    float ang = atan2f(s, c);
    if (ang < 0.0f) ang = __fadd_rn(ang, kTwoPi);
    float pix = __fadd_rn(__fmul_rn(ang, hp.scale[f]), 0.5f);
    if (pix > hp.period[f]) pix = __fsub_rn(pix, hp.period[f]);
    frac[f] = __fdiv_rn(pix, hp.period[f]);
    if (hp.use_mod)
      mod_min = fminf(mod_min,
                      __fsqrt_rn(__fadd_rn(__fmul_rn(s, s), __fmul_rn(c, c))));
  }

  // Beat pyramid (ops/unwrap.py heterodyne_unwrap): each level replaces
  // u_i by frac(u_i - u_{i+1}) in place, left to right, after saving its
  // leftmost phase for the way down.
  float spine_u[kMaxFreq - 1];
#pragma unroll
  for (int l = 0; l < kMaxFreq - 1; ++l) {
    if (l >= hp.nfreq - 1) break;
    spine_u[l] = frac[0];
#pragma unroll
    for (int i = 0; i < kMaxFreq - 1; ++i) {
      if (i >= hp.nfreq - 1 - l) break;
      frac[i] = wrap_delta(frac[i], frac[i + 1]);
    }
  }
  float xx = __fmul_rn(frac[0], hp.coarse);
#pragma unroll
  for (int l = kMaxFreq - 2; l >= 0; --l) {
    if (l > hp.nfreq - 2) continue;
    const float p = hp.spine[l], u = spine_u[l];
    const float k = rintf(__fsub_rn(__fdiv_rn(xx, p), u));  // half to even
    xx = __fmul_rn(__fadd_rn(k, u), p);
  }
  float pu = __fsub_rn(
      xx, __fmul_rn(hp.extent, floorf(__fdiv_rn(xx, hp.extent))));
  if (hp.use_mod && !(mod_min > hp.min_mod)) pu = 0.0f;

  float z, x, y;
  triangulate_px(t, pu, row, col, &z, &x, &y);
  x_out[idx] = x;
  y_out[idx] = y;
  z_out[idx] = z;
  pu_out[idx] = pu;
}

}  // namespace

// periods, scales: nfreq floats; spine: nfreq - 1 floats; ck, sk: n floats
// (all host memory, copied into the kernel's parameters).
extern "C" int slc_heterodyne(const uint8_t* images, float* x, float* y,
                              float* z, float* pu, int h, int w, int nfreq,
                              int n, const float* periods,
                              const float* scales, const float* spine,
                              float coarse, float extent, const float* ck,
                              const float* sk, float two_over_n, int use_mod,
                              float min_mod, const float* tri,
                              cudaStream_t stream) {
  if (nfreq < 1 || nfreq > kMaxFreq || n < 1 || n > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  Het hp = {};
  hp.nfreq = nfreq;
  hp.n = n;
  for (int f = 0; f < nfreq; ++f) {
    hp.period[f] = periods[f];
    hp.scale[f] = scales[f];
  }
  for (int l = 0; l + 1 < nfreq; ++l) hp.spine[l] = spine[l];
  hp.coarse = coarse;
  hp.extent = extent;
  for (int k = 0; k < n; ++k) {
    hp.ck[k] = ck[k];
    hp.sk[k] = sk[k];
  }
  hp.two_over_n = two_over_n;
  hp.use_mod = use_mod;
  hp.min_mod = min_mod;
  const size_t npx = (size_t)h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((npx + threads - 1) / threads);
  heterodyne_kernel<<<blocks, threads, 0, stream>>>(images, x, y, z, pu, h, w,
                                                    hp, tri_from_host(tri));
  return (int)cudaGetLastError();
}

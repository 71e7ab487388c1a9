// Multi-frequency heterodyne absolute decode, four pixels of a row a
// thread.
//
// Replaces slc_tpu/pallas/heterodyne.py:201 heterodyne_decode_pallas. Per
// pixel: N-step phase of each of the F fringe frequencies (atan2f) ->
// wrapped fraction u_f = pix_f / T_f -> minimum modulation over the
// frequencies -> beat cascade u = frac(u_i - u_{i+1}) up to one coarse
// phase -> unwrap down the left spine, k = round(x/T - u),
// x = (k + u) * T -> wrap into [0, extent) -> optional modulation mask ->
// triangulation with C and D rebuilt from their six coefficients. It
// reads F*N u8 planes and writes 4 f32 maps: 28 B/px at 12 planes (11.0 us
// at 1.3 MP on an H100), but its instruction throughput binds it
// more: ~600 a pixel in the (3, 4) instance's SASS, for three atan2f
// (each with an IEEE division of its own), nine IEEE divisions and a
// square root, each with its checks and slow-path branches.
//
// Layout: a block is 32 x kRows threads; a warp takes 128 columns of one
// row, a lane four neighbouring columns, so each plane is one 4-byte load
// for four pixels (a warp: one 128-byte line) and each map one float4
// store (element by element at a width that is not a multiple of 4). A
// block takes 8 rows of 128 columns: 1280 blocks at 1024x1280, 1.62 waves
// at the 6 blocks an SM holds (40 registers a thread); one wave of blocks
// walking the rows was no faster.
// The reference's 3 frequencies x 4 steps take an instance with both loops
// unrolled and the 12 planes' words requested at once; any other (F, N)
// the wrapper takes, an instance whose loops run to the compile-time
// maxima and stop at the call's counts, so the per-call constants are read
// at fixed offsets of the parameter block.
//
// The arithmetic is the plain PyTorch path's, operation for operation:
// the step coefficients are the host's float32 cos/sin values (not the
// exact {1, 0, -1, 0} of the N = 4 closed form), and every product, sum
// and quotient is rounded on its own (__fmul_rn, __fadd_rn, IEEE
// division; no FMA contraction), so a fringe-order rounding falls as the
// plain path's does except where atan2f itself differs. A byte becomes a
// float exactly as a conversion would make it: 2^23 + b assembled from
// its bits, minus 2^23.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kMaxFreq = 8;
constexpr int kMaxSteps = 16;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kRows = 8;   // warps of a block, one row each

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

// Bytes [0, nv) of a plane at p (one 4-byte load when ``full``: nv == 4,
// p 4-byte aligned), 0 beyond.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ p,
                                              int nv, bool full) {
  if (full) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (m < nv) v |= (uint32_t)p[m] << (8 * m);
  return v;
}

// Byte m of ``word`` as a float: the bits of 2^23 + b, minus 2^23.
__device__ __forceinline__ float byte_float(uint32_t word, int m) {
  return __fsub_rn(__int_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + m)),
                   8388608.0f);
}

// F, N: the frequencies and steps, or 0 for the call's own (the generic
// instance). VEC: 4-byte plane loads and float4 stores (w % 4 == 0, the
// maps 16-byte aligned).
template <int F, int N, bool VEC>
__global__ void __launch_bounds__(32 * kRows)
    heterodyne_kernel(const uint8_t* __restrict__ images,
                      float* __restrict__ x_out, float* __restrict__ y_out,
                      float* __restrict__ z_out, float* __restrict__ pu_out,
                      int h, int w, Het hp, Tri t) {
  constexpr int kF = F ? F : kMaxFreq, kN = N ? N : kMaxSteps;
  constexpr bool kPreload = F != 0;
  const int nfreq = F ? F : hp.nfreq, n = N ? N : hp.n;
  const long long npx = (long long)h * w;
  const int col = (blockIdx.x * 32 + threadIdx.x) * 4;
  if (col >= w) return;
  const int nv = min(4, w - col);
  const bool full = VEC && nv == 4;

  const int row = blockIdx.y * kRows + threadIdx.y;
  if (row >= h) return;
  const long long g = (long long)row * w + col;
  uint32_t pre[kPreload ? kF * kN : 1];
  if (kPreload) {   // one branch for all the planes
    if (full) {
#pragma unroll
      for (int p = 0; p < kF * kN; ++p)
        pre[p] = load_word(images + p * npx + g, 4, true);
    } else {
#pragma unroll
      for (int p = 0; p < kF * kN; ++p)
        pre[p] = load_word(images + p * npx + g, nv, false);
    }
  }

  float frac[kF][4];
  float mod2_min[4];   // min over the frequencies of s^2 + c^2
#pragma unroll
  for (int m = 0; m < 4; ++m) mod2_min[m] = CUDART_INF_F;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f >= nfreq) break;
    // N-step phase (slc_tpu_torch/ops/phase.py:25-37): coefficient sums
    // in step order, then the 2/N scale.
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (k >= n) break;
      const uint32_t word =
          kPreload ? pre[kPreload ? f * kN + k : 0]
                   : load_word(images + (f * n + k) * npx + g, nv, full);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float img = byte_float(word, m);
        s[m] = __fadd_rn(s[m], __fmul_rn(img, hp.ck[k]));
        c[m] = __fadd_rn(c[m], __fmul_rn(img, hp.sk[k]));
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float sm = __fmul_rn(s[m], hp.two_over_n);
      const float cm = __fmul_rn(c[m], hp.two_over_n);
      // Wrapped projector offset in (0, T] (ops/phase.py:40-49).
      float ang = atan2f(sm, cm);
      if (ang < 0.0f) ang = __fadd_rn(ang, kTwoPi);
      float pix = __fadd_rn(__fmul_rn(ang, hp.scale[f]), 0.5f);
      if (pix > hp.period[f]) pix = __fsub_rn(pix, hp.period[f]);
      frac[f][m] = __fdiv_rn(pix, hp.period[f]);
      if (hp.use_mod)
        mod2_min[m] = fminf(mod2_min[m], __fadd_rn(__fmul_rn(sm, sm),
                                                   __fmul_rn(cm, cm)));
    }
  }

  float xo[4], yo[4], zo[4], po[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    // Beat pyramid (ops/unwrap.py heterodyne_unwrap): each level
    // replaces u_i by frac(u_i - u_{i+1}) in place, left to right, after
    // saving its leftmost phase for the way down.
    float spine_u[kF > 1 ? kF - 1 : 1];
#pragma unroll
    for (int l = 0; l < kF - 1; ++l) {
      if (l >= nfreq - 1) break;
      spine_u[l] = frac[0][m];
#pragma unroll
      for (int i = 0; i < kF - 1; ++i) {
        if (i >= nfreq - 1 - l) break;
        frac[i][m] = wrap_delta(frac[i][m], frac[i + 1][m]);
      }
    }
    float xx = __fmul_rn(frac[0][m], hp.coarse);
#pragma unroll
    for (int l = kF - 2; l >= 0; --l) {
      if (l > nfreq - 2) continue;
      const float p = hp.spine[l], u = spine_u[l];
      const float k = rintf(__fsub_rn(__fdiv_rn(xx, p), u));  // half to even
      xx = __fmul_rn(__fadd_rn(k, u), p);
    }
    float pu = __fsub_rn(
        xx, __fmul_rn(hp.extent, floorf(__fdiv_rn(xx, hp.extent))));
    // The minimum modulation: a rounded square root is monotone, so the
    // root of the minimum is the minimum of the roots.
    if (hp.use_mod && !(__fsqrt_rn(mod2_min[m]) > hp.min_mod)) pu = 0.0f;
    po[m] = pu;
    triangulate_px(t, pu, row, col + m, &zo[m], &xo[m], &yo[m]);
  }
  store_group<4>(x_out, g, full, col, w, xo);
  store_group<4>(y_out, g, full, col, w, yo);
  store_group<4>(z_out, g, full, col, w, zo);
  store_group<4>(pu_out, g, full, col, w, po);
}

template <int F, int N>
cudaError_t launch(const uint8_t* images, float* x, float* y, float* z,
                   float* pu, int h, int w, const Het& hp, const Tri& t,
                   cudaStream_t stream) {
  const bool vec = w % 4 == 0 && (uintptr_t)images % 4 == 0 &&
                   aligned16(x) && aligned16(y) && aligned16(z) &&
                   aligned16(pu);
  const auto kern = vec ? heterodyne_kernel<F, N, true>
                        : heterodyne_kernel<F, N, false>;
  const dim3 grid((w + 127) / 128, (h + kRows - 1) / kRows);
  kern<<<grid, dim3(32, kRows), 0, stream>>>(images, x, y, z, pu, h, w, hp,
                                              t);
  return cudaGetLastError();
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
  const Tri t = tri_from_host(tri);
  return (int)(nfreq == 3 && n == 4
                   ? launch<3, 4>(images, x, y, z, pu, h, w, hp, t, stream)
                   : launch<0, 0>(images, x, y, z, pu, h, w, hp, t, stream));
}

// Device helpers shared by the structured-light kernels (the roles of
// slc_tpu/pallas/mathx.py: triangulation with C/D rebuilt from their
// bilinear coefficients, the interior-masked vertical box sum, and the
// windowed extremum scan with the reference's tie-break).
//
// Built without --use_fast_math: divisions and square roots are IEEE, so
// the stripe offsets equal the plain PyTorch version bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Triangulation constants, in the order of the host float[14] the Python
// wrappers pass: A, B, fx, fy, cx, cy, C's and D's bilinear coefficients
// (cu, cv, c0, du, dv, d0; slc_tpu/pallas/mathx.py:482-498), fov_min,
// fov_max.
struct Tri {
  float a, b, fx, fy, cx, cy, cu, cv, c0, du, dv, d0, fov_min, fov_max;
};

static inline Tri tri_from_host(const float* t) {
  Tri r;
  r.a = t[0]; r.b = t[1]; r.fx = t[2]; r.fy = t[3]; r.cx = t[4];
  r.cy = t[5]; r.cu = t[6]; r.cv = t[7]; r.c0 = t[8]; r.du = t[9];
  r.dv = t[10]; r.d0 = t[11]; r.fov_min = t[12]; r.fov_max = t[13];
  return r;
}

// z = (B*P - A) / (C - D*P); a hole (P == 0) or z outside the FOV is 0;
// x = z * (u - cx) / fx, y = z * (v - cy) / fy
// (slc_tpu/ops/triangulate.py:25-54, CCalculation.cpp:666-785).
__device__ __forceinline__ void triangulate_px(const Tri& t, float pu,
                                               int row, int col, float* z,
                                               float* x, float* y) {
  const float u = (float)col, v = (float)row;
  const float cm = t.cu * u + (t.cv * v + t.c0);
  const float dm = t.du * u + (t.dv * v + t.d0);
  float zz = (t.b * pu - t.a) / (cm - dm * pu);
  if (pu == 0.0f || zz < t.fov_min || zz > t.fov_max) zz = 0.0f;
  *z = zz;
  *x = zz * ((u - t.cx) / t.fx);
  *y = zz * ((v - t.cy) / t.fy);
}

// Interior-masked vertical box sums of a tile (CCalculation.cpp:797-823):
// vs[rr * ncols + cc] = sum of frame rows [gy - r, gy + r] at column gx,
// gy = y0 + rr, gx = xs + cc, or 0 unless r <= gy < h - r and
// r <= gx < w - r. Integer running sums, exact. All threads of the block
// take part; the caller synchronizes afterwards.
__device__ __forceinline__ void box_sums_tile(const uint8_t* frame, int h,
                                              int w, int r, int y0,
                                              int nrows, int xs, int ncols,
                                              int* vs) {
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int cc = tid; cc < ncols; cc += nthreads) {
    const int gx = xs + cc;
    const bool col_in = gx >= r && gx < w - r;
    int sum = 0;
    if (col_in) {
      for (int yy = y0 - r; yy <= y0 + r; ++yy)
        if (yy >= 0 && yy < h) sum += frame[(size_t)yy * w + gx];
    }
    for (int rr = 0; rr < nrows; ++rr) {
      const int gy = y0 + rr;
      vs[rr * ncols + cc] = (col_in && gy >= r && gy < h - r) ? sum : 0;
      if (col_in) {
        const int add = gy + r + 1, sub = gy - r;
        if (add >= 0 && add < h) sum += frame[(size_t)add * w + gx];
        if (sub >= 0 && sub < h) sum -= frame[(size_t)sub * w + gx];
      }
    }
  }
}

// Parabola through (idx-1, vm), (idx, v0), (idx+1, vp): offset fraction
// clamped to +-0.5 (slc_tpu/ops/stripe.py:111-118).
__device__ __forceinline__ float parabola(int vm, int v0, int vp) {
  const float denom = (float)vm - 2.0f * (float)v0 + (float)vp;
  float frac = fabsf(denom) > 1e-6f ? 0.5f * (float)(vm - vp) / denom
                                    : 0.0f;
  return fminf(fmaxf(frac, -0.5f), 0.5f);
}

// Fast sub-pixel mode (slc_tpu/pallas/mathx.py:279-290, :332-376): a
// fraction quantized to fbits bits, q = clip(S/2 + 1/2 - S*frac, 0, S-1)
// truncated, read back as (S/2 - q)/S, S = 2^fbits. S*frac is exact, so
// a contracted FMA rounds as the plain version does.
__device__ __forceinline__ float quantize_frac(float frac, int fbits) {
  const float s = (float)(1 << fbits), half = 0.5f * s;
  const float q = truncf(fminf(fmaxf(half + 0.5f - s * frac, 0.0f), s - 1.0f));
  return (half - q) / s;
}

// Offsets of the max and min of vs_row[c + i] over i in [-r, r), starting
// from the center and updating on strict inequality: the center wins a
// tie, otherwise the leftmost offset (CCalculation.cpp:828-891). Reads
// vs_row[c - r - 1 .. c + r] when subpixel is set. fbits > 0 quantizes
// the fraction of a winner other than the center; a center tie keeps the
// exact fraction, as the TPU kernels do.
__device__ __forceinline__ void extrema_px(const int* vs_row, int c, int r,
                                           bool subpixel, int fbits,
                                           float* sw, float* sb) {
  const int v0 = vs_row[c];
  int bmax = v0, bmin = v0, imax = 0, imin = 0;
  for (int i = -r; i < r; ++i) {
    const int v = vs_row[c + i];
    if (v > bmax) { bmax = v; imax = i; }
    if (v < bmin) { bmin = v; imin = i; }
  }
  float fmax = (float)imax, fmin = (float)imin;
  if (subpixel) {
    float pmax = parabola(vs_row[c + imax - 1], bmax, vs_row[c + imax + 1]);
    float pmin = parabola(vs_row[c + imin - 1], bmin, vs_row[c + imin + 1]);
    if (fbits > 0) {
      if (imax != 0) pmax = quantize_frac(pmax, fbits);
      if (imin != 0) pmin = quantize_frac(pmin, fbits);
    }
    fmax += pmax;
    fmin += pmin;
  }
  *sw = fmax;
  *sb = fmin;
}

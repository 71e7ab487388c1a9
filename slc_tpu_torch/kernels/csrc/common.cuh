// Device helpers shared by the structured-light kernels (the roles of
// slc_tpu/pallas/mathx.py: triangulation with C/D rebuilt from their
// bilinear coefficients, the interior-masked vertical box sum, and the
// windowed extremum scan with the reference's tie-break).
//
// Built without --use_fast_math: divisions and square roots are IEEE, so
// the stripe offsets equal the plain PyTorch version bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
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

static inline bool aligned16(const void* p) {
  return (uintptr_t)p % 16 == 0;
}

// v[m] = p[gi0 + m] for the K pixels from global column gx0 of one row, 0
// outside [0, w); float4 loads when ``full`` (all K inside, 16-byte
// aligned).
template <int K>
__device__ __forceinline__ void load_group(const float* __restrict__ p,
                                           long long gi0, bool full,
                                           int gx0, int w, float (&v)[K]) {
  if (full) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + gi0) + j);
      v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < K; ++m)
    v[m] = gx0 + m >= 0 && gx0 + m < w ? p[gi0 + m] : 0.0f;
}

template <int K>
__device__ __forceinline__ void store_group(float* __restrict__ p,
                                            long long gi0, bool full,
                                            int gx0, int w,
                                            const float (&v)[K]) {
  if (full) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
      reinterpret_cast<float4*>(p + gi0)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    return;
  }
#pragma unroll
  for (int m = 0; m < K; ++m)
    if (gx0 + m >= 0 && gx0 + m < w) p[gi0 + m] = v[m];
}

// Stage ``ntiles`` windows of an (h, w) image of T into shared memory,
// side by side in the image and one after another in ``dst``: window t
// holds rows [gy0, gy0 + rows) and columns [xa + t * dx, ... + E *
// nchunk), dst[t * tile_elems + rr * pitch + c] the pixel at row gy0 + rr,
// column xa + t * dx + c, 0 outside the image. E = 16 / sizeof(T)
// elements make a 16-byte chunk; xa, dx, pitch and tile_elems are
// multiples of E, dst is 16-byte aligned. A chunk inside the image is
// one 16-byte load when ``vec`` (w a multiple of E and img 16-byte
// aligned); any other chunk is read one element at a time, so a ragged
// width stages exactly. Each thread issues the loads of kStageBatch
// chunks before it stores them. All threads of the block take part; the
// caller synchronizes afterwards.
constexpr int kStageBatch = 4;

template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ img,
                                            int h, int w, bool vec, int gy,
                                            int gx) {
  constexpr int E = 16 / sizeof(T);
  union {
    uint4 u;
    T e[E];
  } c;
  const bool row_in = gy >= 0 && gy < h;
  const T* src = img + (size_t)(row_in ? gy : 0) * w;
  if (vec && row_in && gx >= 0 && gx + E <= w)
    return __ldg(reinterpret_cast<const uint4*>(src + gx));
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = gx + e;
    c.e[e] = row_in && x >= 0 && x < w ? src[x] : T(0);
  }
  return c.u;
}

template <typename T>
__device__ __forceinline__ void stage_tiles(const T* __restrict__ img,
                                            int h, int w, bool vec, int gy0,
                                            int rows, int xa, int nchunk,
                                            int ntiles, int dx, T* dst,
                                            int pitch, int tile_elems) {
  constexpr int E = 16 / sizeof(T);
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int per_tile = rows * nchunk, n = ntiles * per_tile;
  for (int q0 = tid; q0 < n; q0 += kStageBatch * nt) {
    uint4 v[kStageBatch];
    int at[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int q = q0 + b * nt;
      at[b] = -1;
      if (q < n) {
        const int t = q / per_tile, i = q - t * per_tile;
        const int rr = i / nchunk, ch = i - rr * nchunk;
        v[b] = load_chunk(img, h, w, vec, gy0 + rr, xa + t * dx + E * ch);
        at[b] = t * tile_elems + rr * pitch + E * ch;
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b)
      if (at[b] >= 0) *reinterpret_cast<uint4*>(dst + at[b]) = v[b];
  }
}

// Allow a kernel more than the default 48 KB of dynamic shared memory
// when asked (on the current device: the wrappers enter the tensors').
template <typename K>
static inline cudaError_t fit_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Interior-masked vertical box sums (CCalculation.cpp:797-823) from a
// staged frame window: vs[rr * pv + cc] = the sum of frame rows [gy - r,
// gy + r] at column gx, gy = y0 + rr, gx = xs + cc, or 0 unless r <= gy <
// h - r and r <= gx < w - r. The window ``f``
// holds global row y0 - r + i in its row i and column xs + cc at f[i *
// fpitch + off + cc]. Each work item is a column and a segment of
// kBoxSeg rows: one direct sum, then a running one; integers, so exact in
// any order. All threads of the block take part; the caller synchronizes
// afterwards.
constexpr int kBoxSeg = 17;

__device__ __forceinline__ void box_sums_smem(const uint8_t* f, int fpitch,
                                              int off, int h, int w, int r,
                                              int y0, int nrows, int xs,
                                              int ncols, int* vs, int pv) {
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nseg = (nrows + kBoxSeg - 1) / kBoxSeg;
  for (int q = tid; q < ncols * nseg; q += nt) {
    const int sg = q / ncols, cc = q - sg * ncols;
    const int gx = xs + cc;
    const bool col_in = gx >= r && gx < w - r;
    const int e0 = sg * kBoxSeg, e1 = min(e0 + kBoxSeg, nrows);
    const uint8_t* fc = f + off + cc;
    int sum = 0;
    for (int k = 0; k <= 2 * r; ++k) sum += fc[(e0 + k) * fpitch];
    for (int rr = e0;;) {
      const int gy = y0 + rr;
      vs[rr * pv + cc] = col_in && gy >= r && gy < h - r ? sum : 0;
      if (++rr == e1) break;
      sum += fc[(rr + 2 * r) * fpitch] - fc[(rr - 1) * fpitch];
    }
  }
}

// The extrema of K neighbouring windows at once: for m in [0, K),
// kmax[m] and kmin[m] are the max and min over j in [m, m + L) of the keys
// (x[j] << 8) | (255 - j) and (x[j] << 8) | j, x[j] >= 0 and below 2^23,
// j < 256. The value is key >> 8; of equal values the max key holds the
// leftmost j, and so does the min key. Each tap is loaded once: the taps
// [m, K - 1) by a suffix pass, [K - 1, L) shared by every window, [L, L +
// m) by a prefix pass. Needs L >= K - 1.
template <int K>
__device__ __forceinline__ void window_extrema(const int* x, int L,
                                               int (&kmax)[K],
                                               int (&kmin)[K]) {
  int amax[K - 1], amin[K - 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int v = x[j] << 8;
    amax[j] = v | (255 - j);
    amin[j] = v | j;
  }
#pragma unroll
  for (int j = K - 3; j >= 0; --j) {
    amax[j] = max(amax[j], amax[j + 1]);
    amin[j] = min(amin[j], amin[j + 1]);
  }
  int mmax = INT_MIN, mmin = INT_MAX;
  for (int j = K - 1; j < L; ++j) {
    const int v = x[j] << 8;
    mmax = max(mmax, v | (255 - j));
    mmin = min(mmin, v | j);
  }
  int bmax = INT_MIN, bmin = INT_MAX;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    int omax = max(mmax, bmax), omin = min(mmin, bmin);
    if (m < K - 1) {
      omax = max(omax, amax[m]);
      omin = min(omin, amin[m]);
      const int j = L + m, v = x[j] << 8;
      bmax = max(bmax, v | (255 - j));
      bmin = min(bmin, v | j);
    }
    kmax[m] = omax;
    kmin[m] = omin;
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

// Offsets of the max and min of x[c + i] over i in [-r, r), from the keys
// of window_extrema for the window centred on x[c] (taps x[c - r .. c + r
// - 1], so j - c is the offset). The reference scans from the centre and
// updates on strict inequality (CCalculation.cpp:828-891): the centre wins
// a tie, otherwise the leftmost offset. So the max's offset is that of the
// leftmost maximum if it exceeds the centre value, else 0; the same for
// the min. With ``subpixel`` the parabola through the winner and its two
// neighbours adds its fraction (reads x[c - r - 1 .. c + r]); fbits > 0
// quantizes the fraction of a winner other than the centre, while a
// centre tie keeps the exact fraction, as the TPU kernels do.
__device__ __forceinline__ void extrema_from_keys(const int* x, int c,
                                                  int kmax, int kmin,
                                                  bool subpixel, int fbits,
                                                  float* sw, float* sb) {
  const int v0 = x[c];
  const int bmax = kmax >> 8, bmin = kmin >> 8;
  const int imax = bmax > v0 ? 255 - (kmax & 255) - c : 0;
  const int imin = bmin < v0 ? (kmin & 255) - c : 0;
  float fmax = (float)imax, fmin = (float)imin;
  if (subpixel) {
    float pmax = parabola(x[c + imax - 1], bmax, x[c + imax + 1]);
    float pmin = parabola(x[c + imin - 1], bmin, x[c + imin + 1]);
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

// One multigrid level of the spatial unwrap's preconditioner, in two
// kernels on 2-D tiles.
//
// Replaces slc_tpu/pallas/mgsmooth.py:149 mg_down_pallas (nu = 2 damped
// Jacobi sweeps from e = 0, then the residual) and :178 mg_up_pallas
// (nu = 2 post-smooths). A block owns a 32x16 output tile and stages r,
// omega*dinv, and the edge weights of the tile plus a 2-px halo in shared
// memory: the first sweep is computed on tile+2, the second on tile+1,
// the residual (or the second post-smooth) on the tile. Device memory
// sees 4 f32 reads and 2 writes per pixel for mg_down and 5 reads and 1
// write for mg_up (24 B/px each); the level's intermediates never leave
// the chip, where the plain path streams ~25 full-image maps.
//
// Exactness: every operation is the plain PyTorch path's, in its
// association (slc_tpu/ops/unwrap_spatial.py:57-76, :246-262):
//   matvec    ((dy_up - dy_dn) + dx_lt) - dx_rt,  dy = wy * (p_dn - p)
//   smoother  e + (omega * dinv) * (r - A e);  first sweep (omega*dinv)*r
// each rounded on its own with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// contracts nothing into an FMA. Out-of-image positions hold zero values
// and zero weights; a zero weight turns each missing edge term into an
// exact zero, as the plain path's zero rows and columns do.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 2;
constexpr int kSW = kTileW + 2 * kHalo;   // staged columns
constexpr int kSH = kTileH + 2 * kHalo;   // staged rows
constexpr int kThreads = kTileW * kTileH;

// The staged inputs of one tile. wy[i][j] weights the edge from staged
// row i to i+1, wx[i][j] the edge from column j to j+1; both are zero
// where that edge leaves the image.
struct Stage {
  float r[kSH][kSW];
  float omd[kSH][kSW];
  float wy[kSH][kSW];
  float wx[kSH][kSW];
};

__device__ void load_stage(Stage& s, const float* __restrict__ r,
                           const float* __restrict__ wy,
                           const float* __restrict__ wx,
                           const float* __restrict__ dinv, int h, int w,
                           float omega, int y0, int x0) {
  for (int i = threadIdx.x; i < kSH * kSW; i += kThreads) {
    const int sy = i / kSW, sx = i % kSW;
    const int gy = y0 + sy - kHalo, gx = x0 + sx - kHalo;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t g = (size_t)gy * w + gx;
    s.r[sy][sx] = in ? r[g] : 0.0f;
    s.omd[sy][sx] = in ? __fmul_rn(omega, dinv[g]) : 0.0f;
    // wy is (h-1, w) and wx is (h, w-1): no edge leaves the image.
    s.wy[sy][sx] = (in && gy < h - 1) ? wy[g] : 0.0f;
    s.wx[sy][sx] = (in && gx < w - 1) ? wx[(size_t)gy * (w - 1) + gx] : 0.0f;
  }
}

// (A p) at staged position (y, x); p is a staged field, read at the four
// neighbours, which must lie inside the stage.
__device__ __forceinline__ float matvec_at(const Stage& s,
                                           const float (*p)[kSW], int y,
                                           int x) {
  const float pc = p[y][x];
  const float dy_up = __fmul_rn(s.wy[y - 1][x], __fsub_rn(pc, p[y - 1][x]));
  const float dy_dn = __fmul_rn(s.wy[y][x], __fsub_rn(p[y + 1][x], pc));
  const float dx_lt = __fmul_rn(s.wx[y][x - 1], __fsub_rn(pc, p[y][x - 1]));
  const float dx_rt = __fmul_rn(s.wx[y][x], __fsub_rn(p[y][x + 1], pc));
  return __fsub_rn(__fadd_rn(__fsub_rn(dy_up, dy_dn), dx_lt), dx_rt);
}

// e + (omega*dinv) * (r - A e) at staged position (y, x).
__device__ __forceinline__ float sweep_at(const Stage& s,
                                          const float (*e)[kSW], int y,
                                          int x) {
  return __fadd_rn(e[y][x], __fmul_rn(s.omd[y][x],
                                      __fsub_rn(s.r[y][x],
                                                matvec_at(s, e, y, x))));
}

// dst = one damped-Jacobi sweep of src on the staged rows/columns
// [lo, kS - lo); positions outside the image are 0.
__device__ void sweep_ring(const Stage& s, const float (*src)[kSW],
                           float (*dst)[kSW], int lo, int h, int w, int y0,
                           int x0) {
  const int nh = kSH - 2 * lo, nw = kSW - 2 * lo;
  for (int i = threadIdx.x; i < nh * nw; i += kThreads) {
    const int y = lo + i / nw, x = lo + i % nw;
    const int gy = y0 + y - kHalo, gx = x0 + x - kHalo;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    dst[y][x] = in ? sweep_at(s, src, y, x) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    mg_down_kernel(const float* __restrict__ r, const float* __restrict__ wy,
                   const float* __restrict__ wx,
                   const float* __restrict__ dinv, float* __restrict__ e_out,
                   float* __restrict__ res_out, int h, int w, float omega) {
  __shared__ Stage s;
  __shared__ float e1[kSH][kSW];
  __shared__ float e2[kSH][kSW];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  load_stage(s, r, wy, wx, dinv, h, w, omega, y0, x0);
  __syncthreads();
  // Sweep 1 from e = 0 on the whole stage: (omega*dinv) * r.
  for (int i = threadIdx.x; i < kSH * kSW; i += kThreads) {
    const int y = i / kSW, x = i % kSW;
    e1[y][x] = __fmul_rn(s.omd[y][x], s.r[y][x]);
  }
  __syncthreads();
  sweep_ring(s, e1, e2, 1, h, w, y0, x0);   // sweep 2 on tile+1
  __syncthreads();
  const int ty = threadIdx.x / kTileW, tx = threadIdx.x % kTileW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < h && gx < w) {
    const int y = ty + kHalo, x = tx + kHalo;
    const size_t g = (size_t)gy * w + gx;
    e_out[g] = e2[y][x];
    res_out[g] = __fsub_rn(s.r[y][x], matvec_at(s, e2, y, x));
  }
}

__global__ void __launch_bounds__(kThreads)
    mg_up_kernel(const float* __restrict__ e, const float* __restrict__ r,
                 const float* __restrict__ wy, const float* __restrict__ wx,
                 const float* __restrict__ dinv, float* __restrict__ out,
                 int h, int w, float omega) {
  __shared__ Stage s;
  __shared__ float e0[kSH][kSW];
  __shared__ float e1[kSH][kSW];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  load_stage(s, r, wy, wx, dinv, h, w, omega, y0, x0);
  for (int i = threadIdx.x; i < kSH * kSW; i += kThreads) {
    const int sy = i / kSW, sx = i % kSW;
    const int gy = y0 + sy - kHalo, gx = x0 + sx - kHalo;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    e0[sy][sx] = in ? e[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();
  sweep_ring(s, e0, e1, 1, h, w, y0, x0);   // post-smooth 1 on tile+1
  __syncthreads();
  const int ty = threadIdx.x / kTileW, tx = threadIdx.x % kTileW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < h && gx < w)
    out[(size_t)gy * w + gx] = sweep_at(s, e1, ty + kHalo, tx + kHalo);
}

dim3 tiles(int h, int w) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
}

}  // namespace

extern "C" int slc_mg_down(const float* r, const float* wy, const float* wx,
                           const float* dinv, float* e, float* res, int h,
                           int w, float omega, cudaStream_t stream) {
  mg_down_kernel<<<tiles(h, w), kThreads, 0, stream>>>(r, wy, wx, dinv, e,
                                                       res, h, w, omega);
  return (int)cudaGetLastError();
}

extern "C" int slc_mg_up(const float* e, const float* r, const float* wy,
                         const float* wx, const float* dinv, float* out,
                         int h, int w, float omega, cudaStream_t stream) {
  mg_up_kernel<<<tiles(h, w), kThreads, 0, stream>>>(e, r, wy, wx, dinv, out,
                                                     h, w, omega);
  return (int)cudaGetLastError();
}

// One multigrid level of the spatial unwrap's preconditioner, in two
// kernels on the same 2-D tiles; and the K-cycle's coarsest level in one
// thread block (mg_coarse, at the end).
//
// Replaces slc_tpu/pallas/mgsmooth.py:149 mg_down_pallas (nu = 2 damped
// Jacobi sweeps from e = 0, then the residual) and :178 mg_up_pallas
// (nu = 2 post-smooths). Device memory sees 4 f32 reads and 2 writes per
// pixel for mg_down and 5 reads and 1 write for mg_up (24 B/px each, 9.4
// us at 1.3 MP on an H100); the level's intermediates never leave the
// chip, where the plain path streams ~25 full-image maps. Each sweep
// needs its input on a 1-px ring around its output, so a tile holds its
// first field with a 2-px halo and makes two passes over it, as the TPU
// kernels do (slc_tpu/pallas/mgsmooth.py:100-109, :124-130):
//   mg_up:   e                   -> sweep on tile+1 -> sweep on the tile;
//   mg_down: e1 = (omega*dinv)*r -> sweep on tile+1 -> e2 and r - A e2 on
//            the tile.
//
// A block owns 128 columns x TH rows; a warp spans the columns, a lane four
// of them (float4), and a thread a strip of NY rows, whose rows above and
// below each sweep reads from registers. r, omega*dinv and wy, which only
// the thread at their position reads, go from device memory to its
// registers, requested before the staging, once for both passes; wx goes
// to shared memory in 16-byte chunks (a halo of ~1.1x at 128 columns). So
// does mg_up's e. mg_down's e1 is computed where r and dinv are: each
// thread writes its strip's from its registers, and only the 2-px halo is
// staged from device memory (304 of 1584 chunks at 128x40). The full-size
// level takes 128x40 tiles with 4-row strips (260 blocks at 1024x1280, one
// wave of at most two per SM); a smaller level, where those make fewer
// blocks than the card has SMs, takes 128x8 tiles, with one-row strips for
// mg_up and two-row strips for mg_down. mg_down's levels too small for
// 128x8 tiles to fill the card take its 32x16 kernel
// (tools/mg_up_tiles.py times the shapes of both kernels).
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

// ---- mg_down on small levels ----
//
// A level too small to fill the card with 128-column tiles takes 32x16
// tiles, 512 threads a pixel each, which stage r, omega*dinv and the edge
// weights of tile+2 element by element: sweep 1 on tile+2, sweep 2 on
// tile+1, the residual on the tile.
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
    mg_down_small_kernel(const float* __restrict__ r,
                         const float* __restrict__ wy,
                         const float* __restrict__ wx,
                         const float* __restrict__ dinv,
                         float* __restrict__ e_out,
                         float* __restrict__ res_out, int h, int w,
                         float omega) {
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

dim3 small_tiles(int h, int w) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
}

// ---- 128-column tiles ----
//
// Shared memory holds the first field (E0: mg_up's e, mg_down's e1) and wx
// (WX) on the tile plus a 2-px halo, from column x0 - 8, and the first
// sweep's result (E1) on tile+1 plus
// its four-column groups, from x0 - 4. The ring of tile+1 (the rows above
// and below, the four-column groups left and right) is computed as extra
// float4 items.
constexpr int kUpW = 128;
constexpr int kUpG = kUpW / 4;   // lanes of a warp: four columns each
constexpr int kPE = kUpW + 16;   // E0 and WX pitch: columns x0 - 8 ..
constexpr int kP1 = kUpW + 8;    // E1 pitch: columns x0 - 4 ..
constexpr int kUpSMs = 132;      // an H100's SMs: the tile-shape rule

template <int TH, int NY>
struct UpPlan {
  static_assert(TH % NY == 0, "whole strips");
  static constexpr int kThreads = kUpG * TH / NY;
  static constexpr int kWX = (TH + 4) * kPE;        // E0 first
  static constexpr int kE1 = kWX + (TH + 2) * kPE;
  static constexpr size_t kBytes = sizeof(float) * (kE1 + (TH + 2) * kP1);
  // Ring items: rows -1 and TH over groups -1 .. kUpG, then groups -1
  // and kUpG over rows 0 .. TH - 1.
  static constexpr int kRingRows = 2 * (kUpG + 2);
  static constexpr int kRing = kRingRows + 2 * TH;
};

// v = row y of an (nrows, w) map at columns gx .. gx + 3, 0 outside it.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      int nrows, int w, int y, int gx,
                                      float (&v)[4]) {
  if (y < 0 || y >= nrows) {
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] = 0.0f;
    return;
  }
  load_group<4>(p, (long long)y * w + gx, VEC && gx >= 0 && gx + 4 <= w, gx,
                w, v);
}

// The float4 at row[0 .. 3] of shared memory.
__device__ __forceinline__ void read4(const float* row, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(row);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void write4(float* row, const float (&v)[4]) {
  *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
}

// Stage rows [ya, ya + rows) of wx, the (h, w - 1) edge weights, at
// columns [xa, xa + ncol) (ncol % 4 == 0) into dst (row pitch ``pitch``),
// 0 outside the map. A row of wx starts at any alignment, so the chunks
// are the flat array's 16-byte chunks that cover the row's span (16-byte
// loads when ``vec``: the array 16-byte aligned; else element-wise), each
// element stored at its own column. kStageBatch chunks a thread in flight;
// all threads of the block take part.
__device__ __forceinline__ void stage_wx(const float* __restrict__ wx, int h,
                                         int w, bool vec, int ya, int rows,
                                         int xa, int ncol, float* dst,
                                         int pitch) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int wm = w - 1, nchunk = ncol / 4 + 1, total = rows * nchunk;
  const long long n = (long long)h * wm;
  for (int q0 = tid; q0 < total; q0 += kStageBatch * nt) {
    float v[kStageBatch][4];
    int k0[kStageBatch], yr[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int q = q0 + b * nt;
      yr[b] = -1;
#pragma unroll
      for (int m = 0; m < 4; ++m) v[b][m] = 0.0f;
      if (q < total) {
        yr[b] = q / nchunk;
        const int ch = q - yr[b] * nchunk, y = ya + yr[b];
        int off = 0;
        if (y >= 0 && y < h) {
          const long long s = (long long)y * wm + xa;
          off = (int)(s & 3);
          const long long a = s - off + 4 * ch;
          if (vec && a >= 0 && a + 4 <= n) {
            const float4 c = __ldg(reinterpret_cast<const float4*>(wx + a));
            v[b][0] = c.x; v[b][1] = c.y; v[b][2] = c.z; v[b][3] = c.w;
          } else {
#pragma unroll
            for (int m = 0; m < 4; ++m)
              v[b][m] = a + m >= 0 && a + m < n ? wx[a + m] : 0.0f;
          }
        }
        k0[b] = 4 * ch - off;
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      if (yr[b] < 0) continue;
      const int y = ya + yr[b];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int k = k0[b] + m, c = xa + k;
        if (k >= 0 && k < ncol)
          dst[yr[b] * pitch + k] =
              y >= 0 && y < h && c >= 0 && c < wm ? v[b][m] : 0.0f;
      }
    }
  }
}

// (A p) at four neighbouring positions of a row, as the plain path's
// matvec. pu, pc, pd: the field on the rows above, at and below; pl, pr: at
// the columns left and right of the four; wyu, wyd: the weights of the
// edges up and down; wx[m]: of the edge right of position m, wxl: left of
// position 0.
__device__ __forceinline__ void matvec4(
    const float (&pu)[4], const float (&pc)[4], const float (&pd)[4],
    float pl, float pr, const float (&wyu)[4], const float (&wyd)[4],
    const float (&wx)[4], float wxl, float (&av)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float c = pc[m];
    const float left = m > 0 ? pc[m - 1] : pl;
    const float right = m < 3 ? pc[m + 1] : pr;
    const float wl = m > 0 ? wx[m - 1] : wxl;
    const float dy_up = __fmul_rn(wyu[m], __fsub_rn(c, pu[m]));
    const float dy_dn = __fmul_rn(wyd[m], __fsub_rn(pd[m], c));
    const float dx_lt = __fmul_rn(wl, __fsub_rn(c, left));
    const float dx_rt = __fmul_rn(wx[m], __fsub_rn(right, c));
    av[m] = __fsub_rn(__fadd_rn(__fsub_rn(dy_up, dy_dn), dx_lt), dx_rt);
  }
}

// One damped-Jacobi sweep at four neighbouring positions of a row, its
// arguments as matvec4's: e + (omega*dinv) * (r - A e).
__device__ __forceinline__ void sweep4(
    const float (&pu)[4], const float (&pc)[4], const float (&pd)[4],
    float pl, float pr, const float (&wyu)[4], const float (&wyd)[4],
    const float (&wx)[4], float wxl, const float (&r)[4],
    const float (&omd)[4], float (&out)[4]) {
  float av[4];
  matvec4(pu, pc, pd, pl, pr, wyu, wyd, wx, wxl, av);
#pragma unroll
  for (int m = 0; m < 4; ++m)
    out[m] = __fadd_rn(pc[m], __fmul_rn(omd[m], __fsub_rn(r[m], av[m])));
}

// The sweep at four columns of shared-memory row ``f`` (pitch ``pf``) and
// WX row ``x`` (both at the four's first column).
__device__ __forceinline__ void sweep_smem(
    const float* f, int pf, const float* x, const float (&wyu)[4],
    const float (&wyd)[4], const float (&r)[4], const float (&omd)[4],
    float (&out)[4]) {
  float pu[4], pc[4], pd[4], wx[4];
  read4(f - pf, pu);
  read4(f, pc);
  read4(f + pf, pd);
  read4(x, wx);
  sweep4(pu, pc, pd, f[-1], f[4], wyu, wyd, wx, x[-1], r, omd, out);
}

// VEC: float4 access to r, dinv, wy and out (w % 4 == 0, all 16-byte
// aligned); vec_e and vec_wx: 16-byte chunks of e and of wx.
template <int TH, int NY, bool VEC>
__global__ void __launch_bounds__(UpPlan<TH, NY>::kThreads, 2)
    mg_up_kernel(const float* __restrict__ e, const float* __restrict__ r,
                 const float* __restrict__ wy, const float* __restrict__ wx,
                 const float* __restrict__ dinv, float* __restrict__ out,
                 int h, int w, float omega, bool vec_e, bool vec_wx) {
  using Plan = UpPlan<TH, NY>;
  extern __shared__ __align__(16) float up_smem[];
  float* e0s = up_smem;
  float* wxs = up_smem + Plan::kWX;
  float* e1s = up_smem + Plan::kE1;
  const int x0 = blockIdx.x * kUpW, y0 = blockIdx.y * TH;
  const int lane = threadIdx.x & 31, i0 = (threadIdx.x >> 5) * NY;
  const int gx = x0 + 4 * lane, ya = y0 + i0;

  // The strip's r, omega*dinv and edge weights up and down (wyv[k],
  // wyv[k + 1] for row k), requested before the staging.
  float rv[NY][4], om[NY][4], wyv[NY + 1][4];
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    load4<VEC>(r, h, w, ya + k, gx, rv[k]);
    load4<VEC>(dinv, h, w, ya + k, gx, om[k]);
  }
#pragma unroll
  for (int k = 0; k <= NY; ++k)
    load4<VEC>(wy, h - 1, w, ya + k - 1, gx, wyv[k]);
  stage_tiles<float>(e, h, w, vec_e, y0 - 2, TH + 4, x0 - 8, kPE / 4, 1, 0,
                     e0s, kPE, 0);
  stage_wx(wx, h, w, vec_wx, y0 - 1, TH + 2, x0 - 8, kPE, wxs, kPE);
#pragma unroll
  for (int k = 0; k < NY; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) om[k][m] = __fmul_rn(omega, om[k][m]);
  __syncthreads();

  // Post-smooth 1 on tile+1 into E1, 0 outside the image: the strip...
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    const int i = i0 + k;
    float o[4];
    sweep_smem(e0s + (i + 2) * kPE + 8 + 4 * lane, kPE,
               wxs + (i + 1) * kPE + 8 + 4 * lane, wyv[k], wyv[k + 1], rv[k],
               om[k], o);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (y0 + i >= h || gx + m >= w) o[m] = 0.0f;
    write4(e1s + (i + 1) * kP1 + 4 + 4 * lane, o);
  }
  // ... and the ring.
  for (int q = threadIdx.x; q < Plan::kRing; q += Plan::kThreads) {
    int i, g;
    if (q < Plan::kRingRows) {
      i = q < kUpG + 2 ? -1 : TH;
      g = q % (kUpG + 2) - 1;
    } else {
      i = (q - Plan::kRingRows) >> 1;
      g = (q - Plan::kRingRows) & 1 ? kUpG : -1;
    }
    const int y = y0 + i, cx = x0 + 4 * g;
    float o[4] = {};
    if (y >= 0 && y < h && cx < w && cx + 4 > 0) {
      float rq[4], oq[4], wu[4], wd[4];
      load4<VEC>(r, h, w, y, cx, rq);
      load4<VEC>(dinv, h, w, y, cx, oq);
      load4<VEC>(wy, h - 1, w, y - 1, cx, wu);
      load4<VEC>(wy, h - 1, w, y, cx, wd);
#pragma unroll
      for (int m = 0; m < 4; ++m) oq[m] = __fmul_rn(omega, oq[m]);
      sweep_smem(e0s + (i + 2) * kPE + 8 + 4 * g, kPE,
                 wxs + (i + 1) * kPE + 8 + 4 * g, wu, wd, rq, oq, o);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (cx + m < 0 || cx + m >= w) o[m] = 0.0f;
    }
    write4(e1s + (i + 1) * kP1 + 4 + 4 * g, o);
  }
  __syncthreads();

  // Post-smooth 2 on the tile, from E1.
  if (gx >= w) return;
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    const int i = i0 + k;
    if (ya + k >= h) break;
    float o[4];
    sweep_smem(e1s + (i + 1) * kP1 + 4 + 4 * lane, kP1,
               wxs + (i + 1) * kPE + 8 + 4 * lane, wyv[k], wyv[k + 1], rv[k],
               om[k], o);
    store_group<4>(out, (long long)(ya + k) * w + gx, VEC && gx + 4 <= w, gx,
                   w, o);
  }
}

template <int TH, int NY>
cudaError_t launch_up(const float* e, const float* r, const float* wy,
                      const float* wx, const float* dinv, float* out, int h,
                      int w, float omega, cudaStream_t stream) {
  using Plan = UpPlan<TH, NY>;
  const bool vec = w % 4 == 0 && aligned16(r) && aligned16(wy) &&
                   aligned16(dinv) && aligned16(out);
  const auto kern = vec ? mg_up_kernel<TH, NY, true>
                        : mg_up_kernel<TH, NY, false>;
  const cudaError_t err = fit_smem(kern, Plan::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kUpW - 1) / kUpW, (h + TH - 1) / TH);
  kern<<<grid, Plan::kThreads, Plan::kBytes, stream>>>(
      e, r, wy, wx, dinv, out, h, w, omega, w % 4 == 0 && aligned16(e),
      aligned16(wx));
  return cudaGetLastError();
}


// ---- mg_down ----

// Stage sweep 1 from e = 0, e1 = (omega * dinv) * r, 0 outside the image,
// into E0's halo: the two rows above and the two below the tile at every
// column of E0, and the tile's rows at the 8 columns either side of it
// (the threads write the rest from their registers). The chunks are the
// flat arrays' 16-byte chunks that cover each row's span, as stage_wx
// takes them (16-byte loads when ``vec``: r and dinv 16-byte aligned), so
// a row whose start is not 16-byte aligned takes one chunk more.
template <int TH>
__device__ __forceinline__ void stage_e1_halo(const float* __restrict__ dinv,
                                              const float* __restrict__ r,
                                              float omega, int h, int w,
                                              bool vec, int y0, int x0,
                                              float* e0s) {
  const int nt = blockDim.x, tid = threadIdx.x, xa = x0 - 8;
  const int ragged = w & 3 ? 1 : 0;
  const int nfull = kPE / 4 + ragged, nside = 2 + ragged;
  const int total = 4 * nfull + TH * 2 * nside;
  const long long n = (long long)h * w;
  for (int q0 = tid; q0 < total; q0 += kStageBatch * nt) {
    float v[kStageBatch][4];
    int k0[kStageBatch], sr[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int q = q0 + b * nt;
      sr[b] = -1;
#pragma unroll
      for (int m = 0; m < 4; ++m) v[b][m] = 0.0f;
      if (q < total) {
        int ch;
        if (q < 4 * nfull) {   // rows 0, 1, TH + 2, TH + 3 of E0
          const int rr = q / nfull;
          ch = q - rr * nfull;
          sr[b] = rr < 2 ? rr : TH + rr;
        } else {               // rows 2 .. TH + 1, either side
          const int qi = q - 4 * nfull, ir = qi / (2 * nside);
          const int j = qi - ir * 2 * nside;
          sr[b] = 2 + ir;
          ch = j < nside ? j : nfull - 2 * nside + j;
        }
        const int y = y0 - 2 + sr[b];
        int off = 0;
        if (y >= 0 && y < h) {
          const long long s = (long long)y * w + xa;
          off = (int)(s & 3);
          const long long a = s - off + 4 * ch;
          if (vec && a >= 0 && a + 4 <= n) {
            const float4 d = __ldg(reinterpret_cast<const float4*>(dinv + a));
            const float4 q4 = __ldg(reinterpret_cast<const float4*>(r + a));
            v[b][0] = __fmul_rn(__fmul_rn(omega, d.x), q4.x);
            v[b][1] = __fmul_rn(__fmul_rn(omega, d.y), q4.y);
            v[b][2] = __fmul_rn(__fmul_rn(omega, d.z), q4.z);
            v[b][3] = __fmul_rn(__fmul_rn(omega, d.w), q4.w);
          } else {
#pragma unroll
            for (int m = 0; m < 4; ++m)
              v[b][m] = a + m >= 0 && a + m < n
                            ? __fmul_rn(__fmul_rn(omega, dinv[a + m]),
                                        r[a + m])
                            : 0.0f;
          }
        }
        k0[b] = 4 * ch - off;
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      if (sr[b] < 0) continue;
      const int y = y0 - 2 + sr[b];
      const bool side = sr[b] >= 2 && sr[b] < TH + 2;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int k = k0[b] + m, c = xa + k;
        if (k >= 0 && k < kPE && !(side && k >= 8 && k < kPE - 8))
          e0s[sr[b] * kPE + k] =
              y >= 0 && y < h && c >= 0 && c < w ? v[b][m] : 0.0f;
      }
    }
  }
}

// The layout of mg_up_kernel with e1 in E0's place. VEC: float4 access to
// r, dinv, wy, e_out and res_out (w % 4 == 0, all 16-byte aligned); vec_rd:
// 16-byte chunks of r and dinv; vec_wx: of wx.
template <int TH, int NY, bool VEC>
__global__ void __launch_bounds__(UpPlan<TH, NY>::kThreads, 2)
    mg_down_kernel(const float* __restrict__ r, const float* __restrict__ wy,
                   const float* __restrict__ wx,
                   const float* __restrict__ dinv, float* __restrict__ e_out,
                   float* __restrict__ res_out, int h, int w, float omega,
                   bool vec_rd, bool vec_wx) {
  using Plan = UpPlan<TH, NY>;
  static_assert(Plan::kRing <= Plan::kThreads, "a ring item a thread");
  // The ring's inputs are requested before the staging where a thread has
  // the registers for them: 128 at two blocks of up to 256 threads an SM
  // (a 320-thread block's 102 would spill).
  constexpr bool kRingEarly = Plan::kThreads <= 256;
  extern __shared__ __align__(16) float down_smem[];
  float* e0s = down_smem;
  float* wxs = down_smem + Plan::kWX;
  float* e1s = down_smem + Plan::kE1;
  const int x0 = blockIdx.x * kUpW, y0 = blockIdx.y * TH;
  const int lane = threadIdx.x & 31, i0 = (threadIdx.x >> 5) * NY;
  const int gx = x0 + 4 * lane, ya = y0 + i0;

  // The strip's r, omega*dinv and edge weights up and down (wyv[k],
  // wyv[k + 1] for row k), requested before the staging; and the
  // position of the thread's ring item (row ri, group rg of tile+1;
  // mg_up_kernel's order).
  float rv[NY][4], om[NY][4], wyv[NY + 1][4];
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    load4<VEC>(r, h, w, ya + k, gx, rv[k]);
    load4<VEC>(dinv, h, w, ya + k, gx, om[k]);
  }
#pragma unroll
  for (int k = 0; k <= NY; ++k)
    load4<VEC>(wy, h - 1, w, ya + k - 1, gx, wyv[k]);
  const int q = threadIdx.x;
  int ri, rg;
  if (q < Plan::kRingRows) {
    ri = q < kUpG + 2 ? -1 : TH;
    rg = q % (kUpG + 2) - 1;
  } else {
    ri = (q - Plan::kRingRows) >> 1;
    rg = (q - Plan::kRingRows) & 1 ? kUpG : -1;
  }
  const int ry = y0 + ri, rx = x0 + 4 * rg;
  const bool ring = q < Plan::kRing;
  const bool ring_in = ring && ry >= 0 && ry < h && rx < w && rx + 4 > 0;
  float rq[4], oq[4], wu[4], wd[4];
  const auto load_ring = [&] {
    load4<VEC>(r, h, w, ry, rx, rq);
    load4<VEC>(dinv, h, w, ry, rx, oq);
    load4<VEC>(wy, h - 1, w, ry - 1, rx, wu);
    load4<VEC>(wy, h - 1, w, ry, rx, wd);
  };
  if (kRingEarly && ring_in) load_ring();
  stage_e1_halo<TH>(dinv, r, omega, h, w, vec_rd, y0, x0, e0s);
  stage_wx(wx, h, w, vec_wx, y0 - 1, TH + 2, x0 - 8, kPE, wxs, kPE);
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    float e1[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      om[k][m] = __fmul_rn(omega, om[k][m]);
      e1[m] = __fmul_rn(om[k][m], rv[k][m]);
    }
    write4(e0s + (i0 + k + 2) * kPE + 8 + 4 * lane, e1);
  }
  __syncthreads();

  // Sweep 2 on tile+1 into E1, 0 outside the image: the strip...
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    const int i = i0 + k;
    float o[4];
    sweep_smem(e0s + (i + 2) * kPE + 8 + 4 * lane, kPE,
               wxs + (i + 1) * kPE + 8 + 4 * lane, wyv[k], wyv[k + 1], rv[k],
               om[k], o);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (y0 + i >= h || gx + m >= w) o[m] = 0.0f;
    write4(e1s + (i + 1) * kP1 + 4 + 4 * lane, o);
  }
  // ... and the ring.
  if (ring) {
    float o[4] = {};
    if (ring_in) {
      if (!kRingEarly) load_ring();
#pragma unroll
      for (int m = 0; m < 4; ++m) oq[m] = __fmul_rn(omega, oq[m]);
      sweep_smem(e0s + (ri + 2) * kPE + 8 + 4 * rg, kPE,
                 wxs + (ri + 1) * kPE + 8 + 4 * rg, wu, wd, rq, oq, o);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (rx + m < 0 || rx + m >= w) o[m] = 0.0f;
    }
    write4(e1s + (ri + 1) * kP1 + 4 + 4 * rg, o);
  }
  __syncthreads();

  // e2 and r - A e2 on the tile, from E1.
  if (gx >= w) return;
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    const int i = i0 + k;
    if (ya + k >= h) break;
    const float* f = e1s + (i + 1) * kP1 + 4 + 4 * lane;
    const float* x = wxs + (i + 1) * kPE + 8 + 4 * lane;
    float pu[4], pc[4], pd[4], wxv[4], res[4];
    read4(f - kP1, pu);
    read4(f, pc);
    read4(f + kP1, pd);
    read4(x, wxv);
    matvec4(pu, pc, pd, f[-1], f[4], wyv[k], wyv[k + 1], wxv, x[-1], res);
#pragma unroll
    for (int m = 0; m < 4; ++m) res[m] = __fsub_rn(rv[k][m], res[m]);
    const long long g = (long long)(ya + k) * w + gx;
    const bool full = VEC && gx + 4 <= w;
    store_group<4>(e_out, g, full, gx, w, pc);
    store_group<4>(res_out, g, full, gx, w, res);
  }
}

template <int TH, int NY>
cudaError_t launch_down(const float* r, const float* wy, const float* wx,
                        const float* dinv, float* e, float* res, int h,
                        int w, float omega, cudaStream_t stream) {
  using Plan = UpPlan<TH, NY>;
  const bool vec = w % 4 == 0 && aligned16(r) && aligned16(wy) &&
                   aligned16(dinv) && aligned16(e) && aligned16(res);
  const auto kern = vec ? mg_down_kernel<TH, NY, true>
                        : mg_down_kernel<TH, NY, false>;
  const cudaError_t err = fit_smem(kern, Plan::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kUpW - 1) / kUpW, (h + TH - 1) / TH);
  kern<<<grid, Plan::kThreads, Plan::kBytes, stream>>>(
      r, wy, wx, dinv, e, res, h, w, omega, aligned16(r) && aligned16(dinv),
      aligned16(wx));
  return cudaGetLastError();
}

// The number of TH-row, 128-column tiles of an (h, w) level.
int tiles_of(int h, int w, int th) {
  return (w + kUpW - 1) / kUpW * ((h + th - 1) / th);
}

// mg_up's tile shape: 128x40 where that makes a block per SM, else 128x8.
bool tall_tiles(int h, int w) { return tiles_of(h, w, 40) >= kUpSMs; }

// ---- mg_coarse: the coarsest level ----
//
// Replaces no TPU kernel: slc_tpu solves its coarsest level as a
// lax.fori_loop inside one XLA program (slc_tpu/ops/unwrap_spatial.py:
// 226-232). In the port's plain path each visit was 467 launches (32
// sweeps of ~15 elementwise ops: 4 pads of the matvec's edge scatter,
// subs, muls, adds), 4 visits per preconditioner call at 1024x1280. Here
// one block owns the whole level: r, omega*dinv and the edge weights are
// staged in dynamic shared memory once, with sweep 1 from e = 0,
// (omega*dinv)*r; then sweeps - 1 sweeps e + (omega*dinv) * (r - A e)
// alternate between two e buffers, a __syncthreads() between sweeps; e
// goes to device memory once. The bound is latency, not bytes: ~25 KB in
// and 5 KB out at 32x40, but 32 dependent block-wide sweeps. Shared
// memory holds 24 B a pixel (coarse_bytes), so the level must fit one
// block's (ops.unwrap_spatial.MG_COARSE_KERNEL_MAX).
//
// Exactness as above: each operation rounded on its own, in the plain
// association. A neighbour off the image gives its matvec term an exact
// +0, as the plain path's zero-padded edges do (no zero-weight product).
constexpr int kCoarseThreads = 1024;

// Shared memory of an (h, w) level: r, omega*dinv and two e buffers of h*w,
// wy of (h-1)*w, wx of h*(w-1).
size_t coarse_bytes(int h, int w) {
  const size_t n = (size_t)h * w;
  return sizeof(float) *
         (4 * n + (size_t)(h - 1) * w + (size_t)h * (w - 1));
}

// One sweep at flat position i = y * w + x, from src.
__device__ __forceinline__ float coarse_sweep_at(
    const float* src, const float* rs, const float* os, const float* wys,
    const float* wxs, int i, int y, int x, int h, int w) {
  const float pc = src[i];
  const float dy_up =
      y > 0 ? __fmul_rn(wys[i - w], __fsub_rn(pc, src[i - w])) : 0.0f;
  const float dy_dn =
      y < h - 1 ? __fmul_rn(wys[i], __fsub_rn(src[i + w], pc)) : 0.0f;
  // wx is (h, w - 1): the edge right of (y, x) is wx[y * (w - 1) + x].
  const float dx_lt =
      x > 0 ? __fmul_rn(wxs[i - y - 1], __fsub_rn(pc, src[i - 1])) : 0.0f;
  const float dx_rt =
      x < w - 1 ? __fmul_rn(wxs[i - y], __fsub_rn(src[i + 1], pc)) : 0.0f;
  const float av =
      __fsub_rn(__fadd_rn(__fsub_rn(dy_up, dy_dn), dx_lt), dx_rt);
  return __fadd_rn(pc, __fmul_rn(os[i], __fsub_rn(rs[i], av)));
}

// A thread takes positions threadIdx.x, + blockDim.x, ... of the level,
// the same ones in every sweep.
__global__ void __launch_bounds__(kCoarseThreads)
    mg_coarse_kernel(const float* __restrict__ r,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const float* __restrict__ dinv,
                     float* __restrict__ e_out, int h, int w, float omega,
                     int sweeps) {
  extern __shared__ float coarse_smem[];
  const int n = h * w, nt = blockDim.x, t = threadIdx.x;
  float* rs = coarse_smem;
  float* os = rs + n;
  float* src = os + n;
  float* dst = src + n;
  float* wys = dst + n;
  float* wxs = wys + (h - 1) * w;
  for (int i = t; i < n; i += nt) {
    const float rv = r[i], om = __fmul_rn(omega, dinv[i]);
    rs[i] = rv;
    os[i] = om;
    src[i] = __fmul_rn(om, rv);   // sweep 1 from e = 0
  }
  for (int i = t; i < (h - 1) * w; i += nt) wys[i] = wy[i];
  for (int i = t; i < h * (w - 1); i += nt) wxs[i] = wx[i];
  __syncthreads();
  // The thread's first position and the step between its positions.
  const int y0 = t / w, x0 = t - y0 * w;
  const int sy = nt / w, sx = nt - sy * w;
  for (int s = 1; s < sweeps; ++s) {
    int y = y0, x = x0;
    for (int i = t; i < n; i += nt) {
      dst[i] = coarse_sweep_at(src, rs, os, wys, wxs, i, y, x, h, w);
      y += sy;
      x += sx;
      if (x >= w) {
        x -= w;
        ++y;
      }
    }
    __syncthreads();
    float* done = dst;
    dst = src;
    src = done;
  }
  for (int i = t; i < n; i += nt) e_out[i] = src[i];
}

}  // namespace

// Profiling builds (tools/mg_up_tiles.py) give every level of a kernel the
// shape -DSLC_MG_DOWN_TH/NY or -DSLC_MG_UP_TH/NY.
extern "C" int slc_mg_down(const float* r, const float* wy, const float* wx,
                           const float* dinv, float* e, float* res, int h,
                           int w, float omega, cudaStream_t stream) {
#ifdef SLC_MG_DOWN_TH
  return (int)launch_down<SLC_MG_DOWN_TH, SLC_MG_DOWN_NY>(
      r, wy, wx, dinv, e, res, h, w, omega, stream);
#else
  // 128x40 where that makes a block per SM, 128x8 with 2-row strips where
  // that does, else the 32x16 tiles (tools/mg_up_tiles.py).
  if (tall_tiles(h, w))
    return (int)launch_down<40, 4>(r, wy, wx, dinv, e, res, h, w, omega,
                                   stream);
  if (tiles_of(h, w, 8) >= kUpSMs)
    return (int)launch_down<8, 2>(r, wy, wx, dinv, e, res, h, w, omega,
                                  stream);
  mg_down_small_kernel<<<small_tiles(h, w), kThreads, 0, stream>>>(
      r, wy, wx, dinv, e, res, h, w, omega);
  return (int)cudaGetLastError();
#endif
}

extern "C" int slc_mg_up(const float* e, const float* r, const float* wy,
                         const float* wx, const float* dinv, float* out,
                         int h, int w, float omega, cudaStream_t stream) {
#ifdef SLC_MG_UP_TH
  return (int)launch_up<SLC_MG_UP_TH, SLC_MG_UP_NY>(e, r, wy, wx, dinv, out,
                                                    h, w, omega, stream);
#else
  return (int)(tall_tiles(h, w)
                   ? launch_up<40, 4>(e, r, wy, wx, dinv, out, h, w, omega,
                                      stream)
                   : launch_up<8, 1>(e, r, wy, wx, dinv, out, h, w, omega,
                                     stream));
#endif
}

// The coarsest level: ``sweeps`` damped-Jacobi sweeps from e = 0 in one
// block, as few threads as make the same rounds of positions.
extern "C" int slc_mg_coarse(const float* r, const float* wy, const float* wx,
                             const float* dinv, float* e, int h, int w,
                             float omega, int sweeps, cudaStream_t stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = coarse_bytes(h, w);
  const cudaError_t err = fit_smem(mg_coarse_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n = h * w;
  const int rounds = (n + kCoarseThreads - 1) / kCoarseThreads;
  const int threads = ((n + rounds - 1) / rounds + 31) / 32 * 32;
  mg_coarse_kernel<<<1, threads, bytes, stream>>>(r, wy, wx, dinv, e, h, w,
                                                  omega, sweeps);
  return (int)cudaGetLastError();
}

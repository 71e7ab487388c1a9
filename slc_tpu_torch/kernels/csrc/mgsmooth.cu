// One multigrid level of the spatial unwrap's preconditioner, in two
// kernels on 2-D tiles.
//
// Replaces slc_tpu/pallas/mgsmooth.py:149 mg_down_pallas (nu = 2 damped
// Jacobi sweeps from e = 0, then the residual) and :178 mg_up_pallas
// (nu = 2 post-smooths). Device memory sees 4 f32 reads and 2 writes per
// pixel for mg_down and 5 reads and 1 write for mg_up (24 B/px each, 9.4
// us at 1.3 MP on an H100); the level's intermediates never leave the
// chip, where the plain path streams ~25 full-image maps. Each sweep
// needs its input on a 1-px ring around its output, so a tile stages its
// inputs with a 2-px halo: mg_up's first post-smooth runs on tile+1, its
// second on the tile; mg_down's first sweep (from e = 0) on tile+2, its
// second on tile+1, the residual on the tile.
//
// mg_down: a block owns a 32x16 tile, 512 threads a pixel each, and stages
// r, omega*dinv and the edge weights of tile+2 element by element.
//
// mg_up: a block owns 128 columns x TH rows; a warp spans the columns, a
// lane four of them (float4), and a thread a strip of NY rows, whose rows
// above and below each sweep reads from registers. e and wx go to shared
// memory in 16-byte chunks (a halo of ~1.1x at 128 columns, not 1.41x at
// 32x16); r, omega*dinv and wy, which only the thread at their position
// reads, go from device memory to its registers, requested before the
// staging, once for both sweeps. The full-size level takes 128x40 tiles
// with 4-row strips (260 blocks at 1024x1280, one wave of at most two per
// SM); a smaller level, where those make fewer blocks than the card has
// SMs, takes 128x8 tiles with one-row strips (tools/mg_up_tiles.py times
// the shapes).
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

dim3 tiles(int h, int w) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
}

// ---- mg_up ----
//
// Shared memory holds e (E0) and wx (WX) on the tile plus a 2-px halo,
// from column x0 - 8, and the first post-smooth e1 (E1) on tile+1 plus
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

// One damped-Jacobi sweep at four neighbouring positions of a row, as
// sweep_at: e + (omega*dinv) * (r - A e). pu, pc, pd: the field on the
// rows above, at and below; pl, pr: at the columns left and right of the
// four; wyu, wyd: the weights of the edges up and down; wx[m]: of the edge
// right of position m, wxl: left of position 0.
__device__ __forceinline__ void sweep4(
    const float (&pu)[4], const float (&pc)[4], const float (&pd)[4],
    float pl, float pr, const float (&wyu)[4], const float (&wyd)[4],
    const float (&wx)[4], float wxl, const float (&r)[4],
    const float (&omd)[4], float (&out)[4]) {
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
    const float av =
        __fsub_rn(__fadd_rn(__fsub_rn(dy_up, dy_dn), dx_lt), dx_rt);
    out[m] = __fadd_rn(c, __fmul_rn(omd[m], __fsub_rn(r[m], av)));
  }
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
#ifdef SLC_MG_UP_TH   // profiling builds (tools/mg_up_tiles.py)
  return (int)launch_up<SLC_MG_UP_TH, SLC_MG_UP_NY>(e, r, wy, wx, dinv, out,
                                                    h, w, omega, stream);
#else
  const int tiles40 = (w + kUpW - 1) / kUpW * ((h + 39) / 40);
  return (int)(tiles40 >= kUpSMs
                   ? launch_up<40, 4>(e, r, wy, wx, dinv, out, h, w, omega,
                                      stream)
                   : launch_up<8, 1>(e, r, wy, wx, dinv, out, h, w, omega,
                                     stream));
#endif
}

// Hole-aware 3x3 bilateral depth filter: 128-column tiles, a thread four
// columns of a strip of rows, each weight computed once for the two
// pixels that use it.
//
// Replaces slc_tpu/pallas/bilateral.py:61 bilateral_filter_pallas: the
// reference's bilateralFilter(d=3, sigmaColor=10, sigmaSpace=25)
// (depthMapUtils.cpp:179) with zero-depth pixels as missing. Out-of-image
// neighbours are stored as 0 and so count as missing, the border rule the
// TPU kernel runs (slc_tpu/pallas/bilateral.py:9-15).
//
// What bounds it on this card. It reads one f32 map and writes one, 8
// B/px, 3.1 us at 1.31 MP. But a pixel's nine expf, each with its range
// reduction, its nine hole tests and its IEEE division put it nearer the
// issue rate than the byte rate. So the layout cuts instructions (about
// 168 SASS instructions a pixel by static count, ~116 of them the four
// edge weights at 12 each, the taps and the division; the parent's ~500):
//
// - The weight of the edge p->q, expf((v_q - z_p)^2 * inv2sc + s), equals
//   that of q->p bit for bit: IEEE subtraction is exactly antisymmetric,
//   the square drops the sign, and s depends only on |dy| and |dx|. A
//   thread computes each undirected edge once (horizontal, vertical, two
//   diagonals: four per pixel) and both ends take it: 4 expf a pixel
//   instead of 9. The centre tap's weight is expf(-0) = 1 exactly wherever
//   z is finite; elsewhere the parent's result is NaN, and so is z - z.
// - Holes are masked by multiplying a weight by 0 or 1, not by predicated
//   taps: the predicates of 18 values spilled to registers and cost more
//   than the multiplies.
// - A warp takes 128 columns, a lane four of them, loaded as one float4
//   (w % 4 == 0 and aligned pointers; element-wise otherwise). The columns
//   left and right of a lane's four come from its neighbours by shuffle;
//   lanes 0 and 31 load the column beyond the warp. Lane 0's three edges
//   left of the warp are computed by lanes 0, 1 and 2 in one slot.
// - A warp walks a strip of kNY = 4 rows with a rolling window of three
//   rows and the edges of the row pair above in registers, the next row's
//   load issued a row ahead. Each row is read once per strip plus two halo
//   rows; nothing is staged in shared memory. Stores are float4.
// - Blocks of kWarps = 4 warps stacked down the image, 128 x 16 pixels:
//   640 blocks of 128 threads at 1024x1280. At 80 registers 6 blocks fit
//   an SM, so the grid is one wave, 4.85 blocks an SM. Strips of 1, 2 and
//   8 rows and blocks of 2 and 8 warps were slower or equal
//   (tools/bilateral_tiles.py).
//
// The arithmetic is the plain PyTorch path's and the parent kernel's, tap
// for tap in the same order (dy, then dx, from -1 to 1): w = exp((v -
// z)^2 * inv2sc + d2 * inv2ss), num += w * v, den += w for each tap whose
// v != 0, each operation rounded on its own (no FMA contraction), and out
// = num / max(den, 1e-12) where z != 0, else 0.
#include "common.cuh"

namespace {

constexpr int kW = 128;  // tile columns: 32 lanes x 4
#ifdef SLC_BIL_NY
constexpr int kNY = SLC_BIL_NY;  // profiling builds (tools/)
constexpr int kWarps = SLC_BIL_WARPS;
#else
constexpr int kNY = 4;
constexpr int kWarps = 4;
#endif
constexpr unsigned kFull = 0xffffffffu;

// One row of a lane's columns as loaded: c = columns gx .. gx + 3; halo =
// column gx - 1 for lane 0, gx + 4 for lane 31 (0 for the others). 0
// outside the image.
struct RowLoad {
  float c[4];
  float halo;
};

template <bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ img, int h,
                                         int w, int y, int gx, int lane,
                                         RowLoad& r) {
  r.halo = 0.0f;
  if (y < 0 || y >= h) {  // the same row for the whole warp
#pragma unroll
    for (int m = 0; m < 4; ++m) r.c[m] = 0.0f;
    return;
  }
  const long long row = (long long)y * w;
  load_group<4>(img, row + gx, VEC && gx + 4 <= w, gx, w, r.c);
  const int hx = lane == 0 ? gx - 1 : gx + 4;
  if ((lane == 0 || lane == 31) && hx >= 0 && hx < w)
    r.halo = __ldg(img + row + hx);
}

// v[j] = column gx - 1 + j of the row, j = 0 .. 5.
__device__ __forceinline__ void row_values(const RowLoad& r, int lane,
                                           float (&v)[6]) {
  const float left = __shfl_up_sync(kFull, r.c[3], 1);
  const float right = __shfl_down_sync(kFull, r.c[0], 1);
  v[0] = lane == 0 ? r.halo : left;
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m + 1] = r.c[m];
  v[5] = lane == 31 ? r.halo : right;
}

// The weight of the edge between two pixels of values a and b, s the
// space term of its offset.
__device__ __forceinline__ float edge(float a, float b, float s,
                                      float inv2sc) {
  const float d = __fsub_rn(a, b);
  return expf(__fadd_rn(__fmul_rn(__fmul_rn(d, d), inv2sc), s));
}

// The edges of row r (values C) and of the pair (r, r + 1) (D), at the
// lane's columns k = 0 .. 3 (column gx + k): h[k] between (r, gx + k) and
// (r, gx + k + 1); v[k] between (r, gx + k) and (r + 1, gx + k); d1[k]
// between (r, gx + k) and (r + 1, gx + k + 1); d2[k] between (r, gx + k +
// 1) and (r + 1, gx + k). hl, d1l and d2l are the same edges at column gx
// - 1: the left lane's k = 3, or for lane 0 its edges left of the warp.
struct Edges {
  float h[4], v[4], d1[4], d2[4];
  float hl, d1l, d2l;
};

// c0, c1: lane 0's C[0] and C[1]; set here to lane 0's D[0] and D[1],
// the next row's.
template <bool H>
__device__ __forceinline__ void row_edges(const float (&C)[6],
                                          const float (&D)[6], float s1,
                                          float s2, float inv2sc, int lane,
                                          float& c0, float& c1, Edges& e) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (H) e.h[k] = edge(C[k + 1], C[k + 2], s1, inv2sc);
    e.v[k] = edge(C[k + 1], D[k + 1], s1, inv2sc);
    e.d1[k] = edge(C[k + 1], D[k + 2], s2, inv2sc);
    e.d2[k] = edge(C[k + 2], D[k + 1], s2, inv2sc);
  }
  // Lane 0's left edges, one a lane: 0 the horizontal (C0, C1), 1 the
  // diagonal (C0, D1), 2 the anti-diagonal (C1, D0).
  const float e0 = __shfl_sync(kFull, D[0], 0);
  const float e1 = __shfl_sync(kFull, D[1], 0);
  const float ea = lane == 2 ? c1 : c0;
  const float eb = lane == 0 ? c1 : lane == 1 ? e1 : e0;
  const float ex = edge(ea, eb, lane == 0 ? s1 : s2, inv2sc);
  c0 = e0;
  c1 = e1;
  const float hl = H ? __shfl_up_sync(kFull, e.h[3], 1) : 0.0f;
  const float d1l = __shfl_up_sync(kFull, e.d1[3], 1);
  const float d2l = __shfl_up_sync(kFull, e.d2[3], 1);
  const float xh = H ? __shfl_sync(kFull, ex, 0) : 0.0f;
  const float xd1 = __shfl_sync(kFull, ex, 1);
  const float xd2 = __shfl_sync(kFull, ex, 2);
  e.hl = lane == 0 ? xh : hl;
  e.d1l = lane == 0 ? xd1 : d1l;
  e.d2l = lane == 0 ? xd2 : d2l;
}

// 1 where a value counts as a neighbour, 0 where it is missing (a hole, or
// outside the image).
__device__ __forceinline__ void counted(const float (&v)[6], float (&m)[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) m[j] = v[j] != 0.0f ? 1.0f : 0.0f;
}

// A tap of value v with wm, its weight times counted(v): the parent's
// skipped tap (v == 0) adds wm * v = +-0 to num and wm = +0 to den, which
// changes neither (num and den are never -0). wm is NaN for v == 0 only
// where the pixel's own z is NaN, and then so is its result.
__device__ __forceinline__ void tap(float v, float wm, float& num,
                                    float& den) {
  num = __fadd_rn(num, __fmul_rn(wm, v));
  den = __fadd_rn(den, wm);
}

// The up edges of the next row: the pair (r, r + 1)'s edges times
// counted() of row r's values, as the pixels of row r + 1 take them.
__device__ __forceinline__ void edges_up(const Edges& e, const float (&mc)[6],
                                         Edges& up) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    up.v[k] = __fmul_rn(e.v[k], mc[k + 1]);
    up.d1[k] = __fmul_rn(e.d1[k], mc[k + 1]);
    up.d2[k] = __fmul_rn(e.d2[k], mc[k + 2]);
  }
  up.d1l = __fmul_rn(e.d1l, mc[0]);
}

// The filtered row r at the lane's four columns: U, C, D the rows r - 1,
// r, r + 1, mc and md counted() of C and D; up the edges of the pair (r -
// 1, r) as edges_up gives them, cur those of row r and of the pair (r, r +
// 1). The centre tap's weight is expf(-0) = 1 where z is finite: num += z,
// den += 1. Where z is not, the parent's result is NaN, and so is z - z.
__device__ __forceinline__ void filter_row(
    const float (&U)[6], const float (&C)[6], const float (&D)[6],
    const float (&mc)[6], const float (&md)[6], const Edges& up,
    const Edges& cur, float (&res)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float z = C[m + 1];
    float num = 0.0f, den = 0.0f;
    tap(U[m], m ? up.d1[m - 1] : up.d1l, num, den);
    tap(U[m + 1], up.v[m], num, den);
    tap(U[m + 2], up.d2[m], num, den);
    tap(C[m], __fmul_rn(m ? cur.h[m - 1] : cur.hl, mc[m]), num, den);
    num = __fadd_rn(num, z);
    den = __fadd_rn(den, 1.0f);
    tap(C[m + 2], __fmul_rn(cur.h[m], mc[m + 2]), num, den);
    tap(D[m], __fmul_rn(m ? cur.d2[m - 1] : cur.d2l, md[m]), num, den);
    tap(D[m + 1], __fmul_rn(cur.v[m], md[m + 1]), num, den);
    tap(D[m + 2], __fmul_rn(cur.d1[m], md[m + 2]), num, den);
    const float dc = __fsub_rn(z, z);
    res[m] = z == 0.0f   ? 0.0f
             : dc == 0.0f ? __fdiv_rn(num, fmaxf(den, 1e-12f))
                          : dc;
  }
}

// VEC: float4 loads and stores (w % 4 == 0, img and out 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    bilateral_kernel(const float* __restrict__ img, float* __restrict__ out,
                     int h, int w, float inv2sc, float inv2ss) {
  const int lane = threadIdx.x;
  const int gx = blockIdx.x * kW + 4 * lane;
  const int ya = (blockIdx.y * kWarps + threadIdx.y) * kNY;
  if (ya >= h) return;  // the whole warp
  const float s1 = inv2ss, s2 = __fmul_rn(2.0f, inv2ss);
  RowLoad ld;
  float U[6], C[6];
  load_row<VEC>(img, h, w, ya - 1, gx, lane, ld);
  row_values(ld, lane, U);
  load_row<VEC>(img, h, w, ya, gx, lane, ld);
  row_values(ld, lane, C);
  load_row<VEC>(img, h, w, ya + 1, gx, lane, ld);
  float c0 = __shfl_sync(kFull, U[0], 0), c1 = __shfl_sync(kFull, U[1], 0);
  float mc[6], md[6];
  Edges up;
  {
    Edges e;
    row_edges<false>(U, C, s1, s2, inv2sc, lane, c0, c1, e);
    counted(U, mc);
    edges_up(e, mc, up);
  }
  counted(C, mc);
#pragma unroll
  for (int k = 0; k < kNY; ++k) {
    const int y = ya + k;
    if (y >= h) break;  // the whole warp
    float D[6];
    row_values(ld, lane, D);
    if (k + 1 < kNY) load_row<VEC>(img, h, w, y + 2, gx, lane, ld);
    Edges cur;
    row_edges<true>(C, D, s1, s2, inv2sc, lane, c0, c1, cur);
    counted(D, md);
    float res[4];
    filter_row(U, C, D, mc, md, up, cur, res);
    store_group<4>(out, (long long)y * w + gx, VEC && gx + 4 <= w, gx, w,
                   res);
    edges_up(cur, mc, up);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      U[j] = C[j];
      C[j] = D[j];
      mc[j] = md[j];
    }
  }
}

}  // namespace

extern "C" int slc_bilateral(const float* img, float* out, int h, int w,
                             float inv2sc, float inv2ss,
                             cudaStream_t stream) {
  const bool vec = w % 4 == 0 && aligned16(img) && aligned16(out);
  const auto kern = vec ? bilateral_kernel<true> : bilateral_kernel<false>;
  const dim3 grid((w + kW - 1) / kW,
                  (h + kWarps * kNY - 1) / (kWarps * kNY));
  kern<<<grid, dim3(32, kWarps), 0, stream>>>(img, out, h, w, inv2sc,
                                               inv2ss);
  return (int)cudaGetLastError();
}

// The dynamic tracking step, open loop and phase-locked.
//
// Replaces slc_tpu/pallas/dynamic_step.py:166 dynamic_step_pallas (open
// loop) and slc_tpu/pallas/dynamic_lock.py:297 dynamic_step_lock_pallas
// (locked). Both move 37 B/px of state and outputs (frame u8 + 3 f32 in,
// 6 f32 out), so device-memory bandwidth is their floor; the TPU fused
// each into one pass over row blocks that span the full image width.
// Here a block holds a 2-D tile, and the stages that need more than a
// tile run as separate launches through device memory (about 1.3 MP of
// f32 per map, which stays in the 50 MB L2):
//
//   track     stripe track on the tile + 1 px halo -> deltaP select -> 3x3
//             mean -> gradient-scale clip -> P' = P + deltaP. Open loop,
//             it also triangulates: one launch for the whole step.
//   lock_dc   DC = triangle(frame) / weight on a 64x32 tile: the frame
//             and its halo staged in shared memory, both separable passes
//             (box applied twice per axis, each pass truncated to the
//             image) in the block.
//   lock_corr on one GATE_BAND band x 32 columns, plus the column to their
//             left for the gate: the quadrature products iac*cos, iac*sin
//             of 2*pi*P'/T, their triangle sums C and S (in shared memory
//             only), then amplitude, atan2, per-pixel arccos refinement,
//             amplitude gate -> correction map, and the tile's partial
//             sums for the carrier gate.
//   snap      reduce each band's partials in a fixed order (no float
//             atomics: the gate is deterministic) -> gate -> P = P' +
//             correction -> triangulate.
//
// The carrier gate spans all columns of a band, so no tile decides it
// alone; that is why lock_corr and snap are separate launches. The lock's
// only device-memory scratch is DC, the correction map and the partials
// (and one float a band, where snap records the band's gate decision).
//
// The lock's launches (lock_dc, lock_corr, snap) are also the standalone
// lock, slc_phase_lock, which replaces slc_tpu/pallas/phaselock.py:216
// phase_lock_pallas: the same correction and re-triangulation on a given
// prediction P (u8 frame and f32 P in, P, z, x, y out: 21 B/px). With the
// open-loop step before it, it is the two-kernel form of the locked step,
// equal to the fused form bit for bit.
//
// Every triangle sum adds its taps in the plain version's order (the
// truncated box sums in ascending index, the row pass before the column
// pass, each product rounded before it is summed), so the lock's outputs
// do not depend on the tile shape. The sums are direct, not running: a
// thread keeps kSum neighbouring outputs in registers and loads each tap
// from shared memory once for all of them. Only lock_dc's row sums, exact
// integers in float, run.
//
// Bound: not by device memory (the lock must move 21 B/px, the maps stay
// in L2) but by instructions: n adds per output and pass in the plain
// version's order, and the halo's share of the staged products.
#include "common.cuh"

namespace {

constexpr double kPi = 3.141592653589793;
constexpr float kTwoPi = (float)(2.0 * kPi);
// Track tile (outputs): 42 rows make 44 of deltaP with its halo, 11
// bands of 4 rows; a thread takes kTrackK neighbouring pixels, a block
// has kTrackThreads threads.
constexpr int kTrackW = 128, kTrackH = 42, kTrackK = 4;
constexpr int kTrackThreads = 512;
constexpr int kLockW = 32;       // lock tile columns; a gate partial each
constexpr int kLockDcH = 64;     // lock_dc tile rows
constexpr int kDcChunk = 32;     // input rows staged at once by lock_dc
constexpr int kCorrChunk = 16;   // and by lock_corr (5 blocks per SM)
constexpr int kSum = 8;          // neighbouring window sums per thread
constexpr int kThreads = 256;

// Profiling builds only (tools/track_phases.py, -DSLC_TRACK_STOP=N): the
// track launch ends after its box sums (1) or after the extrema and the
// deltaP select (2), keeping the work before it live. 0, the library's
// build, runs every phase.
#ifndef SLC_TRACK_STOP
#define SLC_TRACK_STOP 0
#endif

// Shared memory of a track tile: deltaP on the tile plus one row above
// and below and K columns left and right (G groups of K columns, from
// global column x0 - K, row y0 - 1); the box sums vs on those columns
// plus the windows' reach, r + 1 left and r right (nv columns from x0 - K
// - r - 1, odd pitch pv); and the frame rows of the box sums (frows),
// staged from a 16-byte boundary ``lead`` columns left of x0 (off = the
// box sums' first column in a staged row). The frame and deltaP share one
// region: the frame is dead once the box sums are taken.
struct TrackPlan {
  static constexpr int K = kTrackK;
  static constexpr int G = kTrackW / K + 2;
  static constexpr int NC = G * K;           // deltaP columns
  static constexpr int ER = kTrackH + 2;     // deltaP rows
  static constexpr int PD = NC + 4;          // deltaP pitch (float4 rows)
  int nv, pv, lead, off, nchunk, fpitch, frows;
  __host__ __device__ explicit TrackPlan(int r)
      : nv(NC + 2 * r + 1), pv((NC + 2 * r + 1) | 1),
        lead((K + r + 1 + 15) / 16 * 16), off(lead - (K + r + 1)),
        nchunk((off + nv + 15) / 16), fpitch(16 * nchunk),
        frows(ER + 2 * r) {}
  static_assert(ER % 4 == 0 && (G - 2) % 8 == 0, "warps of 8 x 4 items");
  __host__ __device__ int vs_bytes() const {
    return (int)(sizeof(int) * ER * pv + 15) / 16 * 16;
  }
  __host__ __device__ size_t smem_bytes() const {
    const int f = frows * fpitch, d = (int)sizeof(float) * ER * PD;
    return vs_bytes() + (f > d ? f : d);
  }
};

// Stage A (+ D open loop) on a kTrackH x kTrackW tile, in three phases:
//
//   1. the frame window (stage_tiles, 16-byte chunks where the pitch
//      allows), then its interior-masked vertical box sums from shared
//      memory, all threads over columns and row segments (exact integers);
//   2. per thread K = 4 neighbouring pixels of one row: the windowed
//      extrema from keys that carry the offset (window_extrema: each tap
//      loaded once, one integer max or min per tap and window pass), the
//      parabola fraction (extrema_from_keys, the reference's tie rule),
//      the deltaP select; strips out; deltaP into shared memory;
//   3. per lane 4 neighbouring pixels of one row (a warp a 128-column
//      row; float4 loads and stores when VEC, w % 4 == 0): the 3x3 mean
//      (per dx the three rows (a + b) + c, summed in dx order from +0,
//      then / 9), the gradient scale clipped to [0.2, 5], P' = P + deltaP
//      as one fused multiply-add (as the compiler contracted the earlier
//      design, which the outputs equal bit for bit), and open loop the
//      triangulation.
//
// It moves 25 B/px inside the locked step (frame u8 and prev_sw, prev_sb,
// prev_pu in; P', sw, sb out) and 37 open loop (z, x, y too), but its
// time is set by latency and occupancy: each phase waits on shared or
// device memory, so what pays is warps in flight and SMs evenly loaded.
// Four pixels a thread (not eight) keep it under 64 registers, so two
// 512-thread blocks fit on an SM; 42-row tiles make 250 blocks at
// 1024x1280, at most two per SM, one wave.
//
// The 3x3 mean pads with zeros outside the image where slc_tpu's
// composite reflects (REFLECT_101): the two agree because deltaP is zero
// within r >= 2 px of the border whenever the carried strips are (the
// wrapper's precondition).
template <bool VEC>
__global__ void __launch_bounds__(kTrackThreads, 2)
track_kernel(const uint8_t* __restrict__ frame,
             const float* __restrict__ prev_sw,
             const float* __restrict__ prev_sb,
             const float* __restrict__ prev_pu, float* __restrict__ pu_out,
             float* __restrict__ sw_out, float* __restrict__ sb_out,
             float* z_out, float* x_out, float* y_out, int h, int w, int r,
             int subpixel, int fbits, int scale_gradient, int robust,
             bool vec_frame, Tri t) {
  using Plan = TrackPlan;
  constexpr int K = Plan::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Plan pl(r);
  int* vs = reinterpret_cast<int*>(smem_raw);
  uint8_t* fwin = smem_raw + pl.vs_bytes();
  float* dp1 = reinterpret_cast<float*>(fwin);
  const int x0 = blockIdx.x * kTrackW, y0 = blockIdx.y * kTrackH;
  const int tid = threadIdx.x;
  // Phase 2's item q: K pixels of deltaP row er, column group g. A warp
  // takes 8 neighbouring inner groups (128 bytes of a row) on 4 rows: its
  // float4 loads and stores touch 4 lines of device memory, and its taps,
  // on rows of odd pitch, 32 distinct banks. The two halo groups (columns
  // x0 - K .. x0 - 1 and x0 + kTrackW ..) follow, one item a lane.
  constexpr int n_inner = (Plan::G - 2) * Plan::ER;
  constexpr int n_items = Plan::G * Plan::ER;
  auto item = [](int q, int& g, int& er) {
    constexpr int gblocks = (Plan::G - 2) / 8;
    if (q < n_inner) {
      const int wi = q >> 5, l = q & 31;
      g = 1 + wi % gblocks * 8 + (l & 7);
      er = wi / gblocks * 4 + (l >> 3);
    } else {
      g = (q - n_inner) & 1 ? Plan::G - 1 : 0;
      er = (q - n_inner) >> 1;
    }
  };
  // A block is one of at most two per SM, so device-memory latency is
  // what its phases wait on: phase 2's carried strips are requested an
  // item ahead, the first during phase 1.
  auto strips = [&](int q, float (&a)[K], float (&b)[K]) {
    int g, er;
    item(q, g, er);
    const int gy = y0 - 1 + er, gx0 = x0 - K + K * g;
    if (q < n_items && gy >= 0 && gy < h && gx0 < w && gx0 + K > 0) {
      const long long gi0 = (long long)gy * w + gx0;
      const bool full = VEC && gx0 >= 0 && gx0 + K <= w;
      load_group<K>(prev_sw, gi0, full, gx0, w, a);
      load_group<K>(prev_sb, gi0, full, gx0, w, b);
    }
  };
  float nsw[K] = {}, nsb[K] = {};
  strips(tid, nsw, nsb);

  stage_tiles<uint8_t>(frame, h, w, vec_frame, y0 - 1 - r, pl.frows,
                       x0 - pl.lead, pl.nchunk, 1, 0, fwin, pl.fpitch, 0);
  __syncthreads();
  box_sums_smem(fwin, pl.fpitch, pl.off, h, w, r, y0 - 1, Plan::ER,
                x0 - K - r - 1, pl.nv, vs, pl.pv);
  __syncthreads();
  if (SLC_TRACK_STOP == 1) {
    if (vs[tid] < 0) pu_out[0] = 0.0f;   // never: box sums are >= 0
    return;
  }

  for (int q = tid; q < n_items; q += kTrackThreads) {
    int g, er;
    item(q, g, er);
    const int gy = y0 - 1 + er, gx0 = x0 - K + K * g;
    float psw[K], psb[K], d[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      psw[m] = nsw[m];
      psb[m] = nsb[m];
      d[m] = 0.0f;
    }
    strips(q + kTrackThreads, nsw, nsb);   // the next item's, meanwhile
    if (gy >= 0 && gy < h && gx0 < w && gx0 + K > 0) {
      const long long gi0 = (long long)gy * w + gx0;
      const bool full = VEC && gx0 >= 0 && gx0 + K <= w;
      float sw[K], sb[K];
      const int* x = vs + er * pl.pv + K * g + 1;   // x[j]: tap j
      int kmax[K], kmin[K];
      window_extrema<K>(x, 2 * r, kmax, kmin);
      const bool row_in = gy >= r && gy < h - r;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int gx = gx0 + m;
        sw[m] = sb[m] = 0.0f;
        if (row_in && gx >= r && gx < w - r)
          extrema_from_keys(x, m + r, kmax[m], kmin[m], subpixel != 0,
                            fbits, &sw[m], &sb[m]);
        if (gx >= 0 && gx < w) {
          // deltaP select (CCalculation.cpp:595-646; robust mean where
          // the two stripe families agree, slc_tpu/ops/stripe.py:161-183).
          const float d_b = psb[m] - sb[m], d_w = psw[m] - sw[m];
          d[m] = fabsf(d_b) < fabsf(d_w) ? d_b : d_w;
          if (robust && fabsf(d_b - d_w) <= 1.0f) d[m] = 0.5f * (d_b + d_w);
        }
      }
      if (er >= 1 && er <= kTrackH && g >= 1 && g <= Plan::G - 2) {
        store_group<K>(sw_out, gi0, full, gx0, w, sw);
        store_group<K>(sb_out, gi0, full, gx0, w, sb);
      }
    }
    float4* drow = reinterpret_cast<float4*>(dp1 + er * Plan::PD + K * g);
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
      drow[j] = make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2],
                            d[4 * j + 3]);
  }
  __syncthreads();
  if (SLC_TRACK_STOP == 2) {
    if (dp1[tid] == 1e30f) pu_out[0] = 0.0f;
    return;
  }

  // Phase 3: lane 4 columns, warp rows warp, warp + nwarps, ...
  constexpr int nwarps = kTrackThreads / 32;
  constexpr int NR = (kTrackH + nwarps - 1) / nwarps;
  const int c = 4 * (tid & 31), gx = x0 + c;
  if (gx >= w) return;
  const bool vec4 = VEC && gx + 4 <= w;
  float p[NR][4], pleft[NR], pright[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int i = (tid >> 5) + k * nwarps, gy = y0 + i;
    if (i >= kTrackH || gy >= h) break;
    const long long gi = (long long)gy * w + gx;
    load_group<4>(prev_pu, gi, vec4, gx, w, p[k]);
    pleft[k] = pright[k] = 0.0f;
    if (scale_gradient) {
      if (gx >= 1) pleft[k] = prev_pu[gi - 1];
      if (gx + 4 < w) pright[k] = prev_pu[gi + 4];
    }
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int i = (tid >> 5) + k * nwarps, gy = y0 + i;
    if (i >= kTrackH || gy >= h) break;
    // 3x3 mean (CCalculation.cpp:650): rows, then columns. tsum[j] is
    // column gx + j - 1's (above + centre) + below.
    float rows[3][6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* d0 = dp1 + (i + a) * Plan::PD + K + c;
      const float4 q = *reinterpret_cast<const float4*>(d0);
      rows[a][0] = d0[-1];
      rows[a][1] = q.x; rows[a][2] = q.y; rows[a][3] = q.z;
      rows[a][4] = q.w;
      rows[a][5] = d0[4];
    }
    float tsum[6];
#pragma unroll
    for (int j = 0; j < 6; ++j)
      tsum[j] = rows[0][j] + rows[1][j] + rows[2][j];
    float pu[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float s = 0.0f;
      s += tsum[m];
      s += tsum[m + 1];
      s += tsum[m + 2];
      const float dp = s / 9.0f;
      if (scale_gradient) {
        // g = dP/du of the carried map, clipped to [0.2, 5]
        // (slc_tpu/dynamic.py:187-192); CCalculation.cpp:652-660.
        const float pr = m < 3 ? p[k][m + 1] : pright[k];
        const float pl = m > 0 ? p[k][m - 1] : pleft[k];
        const float g = 0.5f * (pr - pl);
        pu[m] = fmaf(fminf(fmaxf(g, 0.2f), 5.0f), dp, p[k][m]);
      } else {
        pu[m] = p[k][m] + dp;
      }
    }
    const long long gi = (long long)gy * w + gx;
    store_group<4>(pu_out, gi, vec4, gx, w, pu);
    if (z_out != nullptr) {
      float z[4], xx[4], yy[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        triangulate_px(t, pu[m], gy, gx + m, &z[m], &xx[m], &yy[m]);
      store_group<4>(z_out, gi, vec4, gx, w, z);
      store_group<4>(x_out, gi, vec4, gx, w, xx);
      store_group<4>(y_out, gi, vec4, gx, w, yy);
    }
  }
}

// The last R taps of window_sums: a[m] = x[m * stride] for m < kSum.
template <int R>
__device__ __forceinline__ void window_tail(const float* x, int stride,
                                            const float (&a)[kSum],
                                            float (&acc)[kSum]) {
  float b[R > 1 ? R - 1 : 1];
#pragma unroll
  for (int t = 0; t < R - 1; ++t) b[t] = x[(kSum + t) * stride];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int m = 0; m < kSum; ++m)
      acc[m] += m + j < kSum ? a[m + j] : b[m + j - kSum];
}

// acc[m] = sum over d in [0, n) of x[(m + d) * stride], m in [0, kSum),
// each sum in ascending d from +0: blocks of kSum taps, then a tail of
// n % kSum. Each tap is loaded once; the reads stay within
// x[0 .. (n + kSum - 1) * stride].
__device__ __forceinline__ void window_sums(const float* x, int stride,
                                            int n, float (&acc)[kSum]) {
  static_assert(kSum == 8, "window_sums' tail cases assume kSum == 8");
  float a[kSum], b[kSum];
#pragma unroll
  for (int m = 0; m < kSum; ++m) {
    acc[m] = 0.0f;
    a[m] = x[m * stride];
  }
  const int full = n / kSum;
#pragma unroll 2
  for (int k = 0; k < full; ++k) {
    const float* xk = x + k * kSum * stride;
#pragma unroll
    for (int m = 0; m < kSum; ++m) b[m] = xk[(kSum + m) * stride];
#pragma unroll
    for (int j = 0; j < kSum; ++j)
#pragma unroll
      for (int m = 0; m < kSum; ++m)
        acc[m] += m + j < kSum ? a[m + j] : b[m + j - kSum];
#pragma unroll
    for (int m = 0; m < kSum; ++m) a[m] = b[m];
  }
  const float* xt = x + full * kSum * stride;
  switch (n - full * kSum) {
    case 1: window_tail<1>(xt, stride, a, acc); break;
    case 2: window_tail<2>(xt, stride, a, acc); break;
    case 3: window_tail<3>(xt, stride, a, acc); break;
    case 4: window_tail<4>(xt, stride, a, acc); break;
    case 5: window_tail<5>(xt, stride, a, acc); break;
    case 6: window_tail<6>(xt, stride, a, acc); break;
    case 7: window_tail<7>(xt, stride, a, acc); break;
    default: break;
  }
}

// The same sums as window_sums (stride 1) for inputs whose partial sums
// are all integers below 2^24, so that every float addition is exact in
// any order: one direct sum, then a running one.
__device__ __forceinline__ void window_sums_exact(const float* x, int n,
                                                  float (&acc)[kSum]) {
  float s = 0.0f;
  for (int d = 0; d < n; ++d) s += x[d];
  acc[0] = s;
#pragma unroll
  for (int m = 1; m < kSum; ++m) {
    s += x[m + n - 1] - x[m - 1];
    acc[m] = s;
  }
}

// dst[m * step] = acc[m] for the m in [0, kSum) with lo <= m0 + m < hi,
// m0 + m < n, and 0 for those outside [lo, hi): a group's sums, stored
// with the truncation to the image (m0 + m is the image row or column).
__device__ __forceinline__ void store_sums(float* dst, int step,
                                           const float (&acc)[kSum], int m0,
                                           int lo, int hi, int n) {
  if (m0 >= lo && m0 + kSum <= hi && m0 + kSum <= n) {
#pragma unroll
    for (int m = 0; m < kSum; ++m) dst[m * step] = acc[m];
    return;
  }
#pragma unroll
  for (int m = 0; m < kSum; ++m)
    if (m0 + m < n)
      dst[m * step] = m0 + m >= lo && m0 + m < hi ? acc[m] : 0.0f;
}

// Shared-memory plan of one triangle-sum tile: th output rows, nc output
// columns, half-windows ru (along a row) and rv (down a column), input
// rows staged ``chunk`` at a time. Region A holds the staged inputs and
// the row pass's inner sums of one chunk, later the column pass's inner
// sums; region B the row pass's
// outputs for all th + 4 rv input rows, later the tile's sums. Pitches
// leave room for the reads of window_sums past a row's last output, and
// are odd where the lanes of a warp walk down rows.
struct TriPlan {
  int th, ru, rv, chunk;
  int nin;     // input rows, th + 4 rv
  int nx, px;  // staged columns, nc + 4 ru, and their pitch
  int ni, pi;  // row-inner columns, nc + 2 ru, and their pitch
  int nci;     // column-inner rows, th + 2 rv
  int pb;      // pitch of the tile's columns in the column pass
  __host__ __device__ TriPlan(int th_, int nc_, int ru_, int rv_,
                              int chunk_)
      : th(th_), ru(ru_), rv(rv_), chunk(chunk_),
        nin(th_ + 4 * rv_),
        nx(nc_ + 4 * ru_), px((nc_ + 4 * ru_ + kSum) | 1),
        ni(nc_ + 2 * ru_), pi((nc_ + 2 * ru_ + kSum) | 1),
        nci(th_ + 2 * rv_), pb(nc_ | 1) {}
  __host__ __device__ int floats_a(int nf) const {
    const int rows = chunk * (px + pi), cols = (nci + kSum) * pb;
    return nf * (rows > cols ? rows : cols);
  }
  __host__ __device__ int floats_b(int nf) const {
    return nf * (nin + kSum) * pb;
  }
};

// The inputs of lock_dc: the frame. Its row pass sums at most 63 * 63
// values of 0..255, integers below 2^24: exact in float whatever the
// order (the column pass's sums may not be, and keep the order).
struct FrameIn {
  static constexpr int NF = 1;
  static constexpr bool kExactRows = true;
  const uint8_t* frame;
  int w;
  __device__ void operator()(int gy, int gx, float* v) const {
    v[0] = (float)frame[(size_t)gy * w + gx];
  }
};

// The inputs of lock_corr: iac*cos and iac*sin of 2*pi*pred/T, iac =
// frame - DC, each product rounded (no FMA contraction into the sums).
struct QuadIn {
  static constexpr int NF = 2;
  static constexpr bool kExactRows = false;
  const uint8_t* frame;
  const float* dc;
  const float* pred;
  float two_over_t;
  int w;
  __device__ void operator()(int gy, int gx, float* v) const {
    const size_t gi = (size_t)gy * w + gx;
    const float iac = (float)frame[gi] - dc[gi];
    float sn, cs;
    sincospif(pred[gi] * two_over_t, &sn, &cs);
    v[0] = __fmul_rn(iac, cs);
    v[1] = __fmul_rn(iac, sn);
  }
};

// Work item q of NF * n items as (field, group): NF is 1 or 2.
template <int NF>
__device__ __forceinline__ int field_of(int q, int n) {
  return NF == 2 && q >= n ? 1 : 0;
}

// Triangle sums of the tile whose output rows start at global row y0 and
// its NC columns (the plan's nc) at xo, CHUNK (the plan's chunk) input
// rows staged at a time (slc_tpu/ops/demod.py:76-97): per field, out(y,
// x) = column double box of the row double box of the input, each box
// pass truncated to the image (inputs outside it are 0, and an inner sum
// at a row or column outside it is 0). Leaves field f's sum at tile row
// i, column c in sb[(f * th + i) * pb + c]. Block: 32 x 8 threads, all
// taking part; the caller's reads follow a barrier.
template <int NC, int CHUNK, class In>
__device__ void tri_tile(const In& in, const TriPlan& pl, int h, int w,
                         int y0, int xo, float* sa, float* sb) {
  constexpr int NF = In::NF;
  constexpr int kRowsPerWarp = 32 / CHUNK;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nu = 2 * pl.ru + 1, nv = 2 * pl.rv + 1;
  float* sx = sa;                          // NF x CHUNK x px
  float* si = sa + NF * CHUNK * pl.px;     // NF x CHUNK x pi
  const int xs = xo - 2 * pl.ru;           // column of sx's column 0
  const int gi_n = (pl.ni + kSum - 1) / kSum;
  const int go_n = (NC + kSum - 1) / kSum;
  const int brows = pl.nin + kSum;         // rows of each field in sb
  // Row-pass work items: lane lr takes row lr of the chunk, so the lanes
  // of a warp walk down rows (odd pitches: no bank conflicts).
  const int lr = tx % CHUNK;
  const int slot0 = ty * kRowsPerWarp + tx / CHUNK;
  const int nslots = blockDim.y * kRowsPerWarp;
  const int nt = blockDim.x * blockDim.y;
  const float inv_nx = 1.0f / (float)pl.nx;

  for (int r0 = 0; r0 < pl.nin; r0 += CHUNK) {
    const int nr = min(CHUNK, pl.nin - r0);
    const int gy0 = y0 - 2 * pl.rv + r0;
    for (int p = ty * blockDim.x + tx; p < nr * pl.nx; p += nt) {
      // r = p / nx in float: p + 1/2 is at least 1/(2 nx) from a multiple
      // of nx, far above the rounding of the product (p < 2^13).
      const int r = __float2int_rd(((float)p + 0.5f) * inv_nx);
      const int c = p - r * pl.nx, gy = gy0 + r, gx = xs + c;
      float v[NF];
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        in(gy, gx, v);
      } else {
#pragma unroll
        for (int f = 0; f < NF; ++f) v[f] = 0.0f;
      }
#pragma unroll
      for (int f = 0; f < NF; ++f)
        sx[(f * CHUNK + r) * pl.px + c] = v[f];
    }
    __syncthreads();
    if (lr < nr) {
      // Inner sums: si's column j is global column xo - ru + j.
      for (int q = slot0; q < NF * gi_n; q += nslots) {
        const int f = field_of<NF>(q, gi_n), g = q - f * gi_n;
        float acc[kSum];
        const float* x = sx + (f * CHUNK + lr) * pl.px + g * kSum;
        if (In::kExactRows)
          window_sums_exact(x, nu, acc);
        else
          window_sums(x, 1, nu, acc);
        // In image columns: j with 0 <= xo - ru + j < w.
        store_sums(si + (f * CHUNK + lr) * pl.pi + g * kSum, 1, acc,
                   g * kSum, pl.ru - xo, w + pl.ru - xo, pl.ni);
      }
    }
    __syncthreads();
    if (lr < nr) {
      // Outer sums: sb's column c is global column xo + c.
      for (int q = slot0; q < NF * go_n; q += nslots) {
        const int f = field_of<NF>(q, go_n), g = q - f * go_n;
        float acc[kSum];
        const float* x = si + (f * CHUNK + lr) * pl.pi + g * kSum;
        if (In::kExactRows)
          window_sums_exact(x, nu, acc);
        else
          window_sums(x, 1, nu, acc);
        store_sums(sb + (f * brows + r0 + lr) * pl.pb + g * kSum, 1, acc,
                   g * kSum, 0, NC, NC);
      }
    }
    // The next chunk's staging writes sx, read before the last barrier.
  }
  __syncthreads();

  // Column pass, the lanes of a warp on neighbouring columns. Inner sums:
  // sci's row j is global row y0 - rv + j.
  const int tid = ty * blockDim.x + tx;
  float* sci = sa;                         // NF x (nci + kSum) x pb
  const int crows = pl.nci + kSum;
  const int gc_n = (pl.nci + kSum - 1) / kSum;
  const int gt_n = (pl.th + kSum - 1) / kSum;
  for (int p = tid; p < NF * gc_n * NC; p += nt) {
    const int c = p % NC, q = p / NC;
    const int f = field_of<NF>(q, gc_n), g = q - f * gc_n;
    float acc[kSum];
    window_sums(sb + (f * brows + g * kSum) * pl.pb + c, pl.pb, nv, acc);
    // In image rows: j with 0 <= y0 - rv + j < h.
    store_sums(sci + (f * crows + g * kSum) * pl.pb + c, pl.pb, acc,
               g * kSum, pl.rv - y0, h + pl.rv - y0, pl.nci);
  }
  __syncthreads();
  for (int p = tid; p < NF * gt_n * NC; p += nt) {
    const int c = p % NC, q = p / NC;
    const int f = field_of<NF>(q, gt_n), g = q - f * gt_n;
    float acc[kSum];
    window_sums(sci + (f * crows + g * kSum) * pl.pb + c, pl.pb, nv, acc);
    store_sums(sb + (f * pl.th + g * kSum) * pl.pb + c, pl.pb, acc,
               g * kSum, 0, pl.th, pl.th);
  }
  __syncthreads();
}

// Lock launch 1: DC = triangle(frame) / (wv[row] * wu[col]), the exact
// in-image weight. Block: kLockW x 8 threads, a kLockDcH x kLockW tile.
// Moves the frame (1 B/px and its halo, from L2 where tiles overlap) and
// writes DC (4 B/px).
__global__ void lock_dc_kernel(const uint8_t* __restrict__ frame,
                               const float* __restrict__ wu,
                               const float* __restrict__ wv,
                               float* __restrict__ dc, int h, int w, int ru,
                               int rv) {
  extern __shared__ float sm[];
  const TriPlan pl(kLockDcH, kLockW, ru, rv, kDcChunk);
  float* sb = sm + pl.floats_a(1);
  const int x0 = blockIdx.x * kLockW, y0 = blockIdx.y * kLockDcH;
  tri_tile<kLockW, kDcChunk>(FrameIn{frame, w}, pl, h, w, y0, x0, sm, sb);
  const int gx = x0 + threadIdx.x;
  for (int i = threadIdx.y; i < kLockDcH; i += blockDim.y) {
    const int gy = y0 + i;
    if (gy >= h || gx >= w) continue;
    dc[(size_t)gy * w + gx] = sb[i * pl.pb + threadIdx.x] / (wv[gy] * wu[gx]);
  }
}

__device__ __forceinline__ float wrap_pi(float x) {
  return x - kTwoPi * rintf(x / kTwoPi);
}

// Windowed demodulation at one pixel: amplitude, delta_phi and the
// amplitude/hole gate (slc_tpu/ops/demod.py:186-203).
__device__ __forceinline__ void demod_px(float c, float s, float wgt,
                                         float pu, float amp_floor,
                                         float* amp, float* dphi,
                                         bool* ok) {
  *amp = sqrtf(c * c + s * s) / wgt;
  *dphi = atan2f(-s, c);
  *ok = *amp > amp_floor && pu > 0.0f;
}

// Lock launch 2: C and S = triangle(iac * cos, iac * sin of 2*pi*pred/T)
// on one band of rows and kLockW + 1 columns (the tile's and the one to
// its left), kept in shared memory; then the correction map, and the
// partial sums of gx*gm and gm, gx the wrapped difference of delta_phi
// between columns c-1 and c where both are ok (slc_tpu/ops/demod.py:
// 204-224). Block: kLockW x 8 threads; thread (tx, ty) takes rows ty,
// ty + 8, ... of column tx, and the 256 partials reduce in a fixed tree,
// so the gate does not depend on the schedule. Reads frame, DC and pred
// with the windows' halo (mostly from L2); writes the correction (4 B/px)
// and one (num, den) pair per block.
__global__ void lock_corr_kernel(const uint8_t* __restrict__ frame,
                                 const float* __restrict__ dc,
                                 const float* __restrict__ pred,
                                 const float* __restrict__ wu,
                                 const float* __restrict__ wv,
                                 float* __restrict__ corr,
                                 float* __restrict__ partial, int h, int w,
                                 int ru, int rv, int band, float two_over_t,
                                 float phase_scale, float p_scale,
                                 float amp_floor) {
  constexpr int NC = kLockW + 1;
  extern __shared__ float sm[];
  const TriPlan pl(band, NC, ru, rv, kCorrChunk);
  float* sb = sm + pl.floats_a(2);
  const int x0 = blockIdx.x * kLockW, y0 = blockIdx.y * band;
  tri_tile<NC, kCorrChunk>(QuadIn{frame, dc, pred, two_over_t, w}, pl, h,
                           w, y0, x0 - 1, sm, sb);
  // Demodulate each pixel of the band's NC columns once, in place: C
  // becomes the amplitude, S delta_phi; region A (free once tri_tile has
  // returned) takes the ok flags after the gate's reduction buffers.
  float* amp = sb;                      // column c is global x0 - 1 + c
  float* dphi = sb + band * pl.pb;
  float* red_num = sm;
  float* red_den = sm + kThreads;
  float* okf = sm + 2 * kThreads;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx;
  for (int p = tid; p < band * NC; p += kThreads) {
    const int i = p / NC, c = p % NC;
    const int gy = y0 + i, gx = x0 - 1 + c;
    if (gy >= h || gx < 0 || gx >= w) continue;
    const int k = i * pl.pb + c;
    bool ok;
    demod_px(amp[k], dphi[k], wv[gy] * wu[gx], pred[(size_t)gy * w + gx],
             amp_floor, &amp[k], &dphi[k], &ok);
    okf[k] = ok ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int gx = x0 + tx;
  float num = 0.0f, den = 0.0f;
  for (int i = ty; i < band; i += blockDim.y) {
    const int gy = y0 + i;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    const int k = i * pl.pb + tx + 1;
    const float a = amp[k], dp = dphi[k];
    const bool ok = okf[k] != 0.0f;
    // Per-pixel arccos refinement against the window-corrected
    // prediction, blended by sin^2(phi).
    const float iac = (float)frame[gi] - dc[gi];
    const float cosp = fminf(fmaxf(iac / fmaxf(2.0f * a, 1e-6f), -1.0f),
                             1.0f);
    const float phimag = acosf(cosp);
    const float phi_ref = phase_scale * pred[gi] + dp;
    const float d_pos = wrap_pi(phimag - phi_ref);
    const float d_neg = wrap_pi(-phimag - phi_ref);
    const float d_px = fabsf(d_pos) <= fabsf(d_neg) ? d_pos : d_neg;
    const float conf = 1.0f - cosp * cosp;
    const float dpl = (dp + conf * d_px) * p_scale;
    corr[gi] = ok ? dpl : 0.0f;
    if (gx >= 1 && ok && okf[k - 1] != 0.0f) {
      num += wrap_pi(dp - dphi[k - 1]);
      den += 1.0f;
    }
  }
  red_num[tid] = num;
  red_den[tid] = den;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red_num[tid] += red_num[tid + s];
      red_den[tid] += red_den[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const size_t k = 2 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
    partial[k] = red_num[0];
    partial[k + 1] = red_den[0];
  }
}

// Lock launch 3, the gate and stage D: P = P' + correction where the
// band's amplitude-gated mean gradient is within the threshold, then
// triangulate. ``pu_in`` holds P', ``pu_out`` gets P; the locked step
// passes one buffer for both (each thread reads, then writes, its own
// pixel), the standalone lock a fresh output. Each band's decision goes
// to ``gate_out`` (1 applied, 0 gated off), for the caller to read.
__global__ void snap_kernel(const float* pu_in, float* pu_out,
                            const float* __restrict__ corr,
                            const float* __restrict__ partial, int ntiles,
                            int gate_on, float thresh,
                            float* __restrict__ gate_out,
                            float* __restrict__ z_out,
                            float* __restrict__ x_out,
                            float* __restrict__ y_out, int h, int w,
                            int band, Tri t) {
  __shared__ int gate;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (tx == 0 && ty == 0) {
    bool g = true;
    if (gate_on) {
      float num = 0.0f, den = 0.0f;
      const float* p = partial + 2 * (size_t)blockIdx.y * ntiles;
      for (int k = 0; k < ntiles; ++k) {
        num += p[2 * k];
        den += p[2 * k + 1];
      }
      g = fabsf(num / fmaxf(den, 1.0f)) <= thresh;
    }
    gate = g ? 1 : 0;
    if (blockIdx.x == 0) gate_out[blockIdx.y] = g ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int gx = blockIdx.x * kLockW + tx, y0 = blockIdx.y * band;
  for (int i = ty; i < band; i += blockDim.y) {
    const int gy = y0 + i;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    const float p = pu_in[gi] + (gate ? corr[gi] : 0.0f);
    float z, x, y;
    triangulate_px(t, p, gy, gx, &z, &x, &y);
    pu_out[gi] = p;
    z_out[gi] = z;
    x_out[gi] = x;
    y_out[gi] = y;
  }
}

// float4 maps (VEC) where w % 4 == 0 and every map is 16-byte aligned.
cudaError_t launch_track(const uint8_t* frame, const float* prev_sw,
                           const float* prev_sb, const float* prev_pu,
                         float* pu, float* sw, float* sb, float* z,
                         float* x, float* y, int h, int w, int window,
                         int subpixel, int fbits, int scale_gradient,
                         int robust, const Tri& t, cudaStream_t stream) {
  const int r = window / 2;
  const bool vec = w % 4 == 0 && aligned16(prev_sw) && aligned16(prev_sb) &&
                   aligned16(prev_pu) && aligned16(pu) && aligned16(sw) &&
                   aligned16(sb) && aligned16(z) && aligned16(x) &&
                   aligned16(y);
  const auto kern = vec ? track_kernel<true> : track_kernel<false>;
  const size_t smem = TrackPlan(r).smem_bytes();
  cudaError_t err = fit_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTrackW - 1) / kTrackW, (h + kTrackH - 1) / kTrackH);
  const bool vec_frame = w % 16 == 0 && aligned16(frame);
  kern<<<grid, kTrackThreads, smem, stream>>>(
      frame, prev_sw, prev_sb, prev_pu, pu, sw, sb, z, x, y, h, w, r,
      subpixel, fbits, scale_gradient, robust, vec_frame, t);
  return cudaGetLastError();
}

int n_bands(int h, int band) { return (h + band - 1) / band; }
int n_tiles(int w) { return (w + kLockW - 1) / kLockW; }

// Where the lock's launches stop: all of them, or (profiling only) after
// lock_dc or after lock_corr.
enum LockStop { kLockAll = 0, kLockAfterDc = 2, kLockAfterCorr = 3 };

// The lock's three launches: the lock-in correction of the prediction
// ``pred`` and the re-triangulation, P into ``pu_out`` (which may be
// ``pred`` itself). Shared by the locked step, which gives it the P' of
// its track launch, and by the standalone lock, which gives it the
// caller's prediction; so the two cannot drift apart.
cudaError_t launch_lock(const uint8_t* frame, const float* pred,
                        float* pu_out, float* z, float* x, float* y,
                        float* scratch, const float* wu, const float* wv,
                        int h, int w, float period, int win_u, int win_v,
                        float amp_floor, int gate_on, float gate_thresh,
                        int band, LockStop stop, const Tri& t,
                        cudaStream_t stream) {
  const size_t npx = (size_t)h * w;
  float* dc = scratch;
  float* corr = scratch + npx;
  float* partial = scratch + 2 * npx;
  const int ru = win_u / 2, rv = win_v / 2;
  const float two_over_t = (float)(2.0 / (double)period);
  const float phase_scale = (float)(2.0 * kPi / (double)period);
  const float p_scale = (float)((double)period / (2.0 * kPi));
  const dim3 block(kLockW, kThreads / kLockW);
  cudaError_t err;

  const TriPlan pd(kLockDcH, kLockW, ru, rv, kDcChunk);
  const size_t smem_dc = sizeof(float) * (pd.floats_a(1) + pd.floats_b(1));
  if ((err = fit_smem(lock_dc_kernel, smem_dc)) != cudaSuccess) return err;
  lock_dc_kernel<<<dim3(n_tiles(w), n_bands(h, kLockDcH)), block, smem_dc,
                   stream>>>(frame, wu, wv, dc, h, w, ru, rv);
  if ((err = cudaGetLastError()) != cudaSuccess || stop == kLockAfterDc)
    return err;

  const dim3 grid(n_tiles(w), n_bands(h, band));
  const TriPlan pc(band, kLockW + 1, ru, rv, kCorrChunk);
  const size_t smem_c = sizeof(float) * (pc.floats_a(2) + pc.floats_b(2));
  if ((err = fit_smem(lock_corr_kernel, smem_c)) != cudaSuccess) return err;
  lock_corr_kernel<<<grid, block, smem_c, stream>>>(
      frame, dc, pred, wu, wv, corr, partial, h, w, ru, rv, band,
      two_over_t, phase_scale, p_scale, amp_floor);
  if ((err = cudaGetLastError()) != cudaSuccess || stop == kLockAfterCorr)
    return err;

  snap_kernel<<<grid, block, 0, stream>>>(
      pred, pu_out, corr, partial, n_tiles(w), gate_on, gate_thresh,
      partial + 2 * (size_t)n_bands(h, band) * n_tiles(w), z, x, y, h, w,
      band, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" int slc_dynamic_step(const uint8_t* frame, const float* prev_sw,
                                const float* prev_sb, const float* prev_pu,
                                float* pu, float* sw, float* sb, float* z,
                                float* x, float* y, int h, int w, int window,
                                int subpixel, int fbits, int scale_gradient,
                                int robust, const float* tri,
                                cudaStream_t stream) {
  return (int)launch_track(frame, prev_sw, prev_sb, prev_pu, pu, sw, sb, z,
                           x, y, h, w, window, subpixel, fbits,
                           scale_gradient, robust, tri_from_host(tri),
                           stream);
}

// Floats of scratch the locked step and the standalone lock need: DC, the
// correction map, the band partials, and last each band's gate decision.
extern "C" long slc_dynamic_step_lock_scratch(int h, int w, int band) {
  return 2L * h * w + 2L * n_bands(h, band) * n_tiles(w) + n_bands(h, band);
}

// ``ablate`` (profiling only; the outputs are then garbage): 0 runs every
// launch, 1 stops after the track launch, 2 after lock_dc, 3 after
// lock_corr, as slc_tpu/pallas/dynamic_lock.py:316-319 truncates its
// kernel.
extern "C" int slc_dynamic_step_lock(
    const uint8_t* frame, const float* prev_sw, const float* prev_sb,
    const float* prev_pu, float* pu, float* sw, float* sb, float* z,
    float* x, float* y, float* scratch, const float* wu, const float* wv,
    int h, int w, int window, int subpixel, int fbits, int scale_gradient,
    int robust, float period, int win_u, int win_v, float amp_floor,
    int gate_on, float gate_thresh, int band, int ablate, const float* tri,
    cudaStream_t stream) {
  const Tri t = tri_from_host(tri);
  // Track and integrate; P' lands in ``pu``.
  cudaError_t err = launch_track(frame, prev_sw, prev_sb, prev_pu, pu, sw,
                                 sb, nullptr, nullptr, nullptr, h, w,
                                 window, subpixel, fbits, scale_gradient,
                                 robust, t, stream);
  if (err != cudaSuccess || ablate == 1) return (int)err;
  const LockStop stop = ablate == 2 ? kLockAfterDc
                        : ablate == 3 ? kLockAfterCorr : kLockAll;
  return (int)launch_lock(frame, pu, pu, z, x, y, scratch, wu, wv, h, w,
                          period, win_u, win_v, amp_floor, gate_on,
                          gate_thresh, band, stop, t, stream);
}

// The standalone lock (replaces slc_tpu/pallas/phaselock.py:216
// phase_lock_pallas): the lock's three launches on the caller's
// prediction ``pred``, which is only read; P, z, x, y go to fresh outputs.
extern "C" int slc_phase_lock(const uint8_t* frame, const float* pred,
                              float* pu, float* z, float* x, float* y,
                              float* scratch, const float* wu,
                              const float* wv, int h, int w, float period,
                              int win_u, int win_v, float amp_floor,
                              int gate_on, float gate_thresh, int band,
                              const float* tri, cudaStream_t stream) {
  return (int)launch_lock(frame, pred, pu, z, x, y, scratch, wu, wv, h, w,
                          period, win_u, win_v, amp_floor, gate_on,
                          gate_thresh, band, kLockAll, tri_from_host(tri),
                          stream);
}

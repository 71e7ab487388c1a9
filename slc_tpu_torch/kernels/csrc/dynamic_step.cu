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
//   track   stripe track on the tile + 1 px halo -> deltaP select -> 3x3
//           mean -> gradient-scale clip -> P' = P + deltaP. Open loop,
//           it also triangulates: one launch for the whole step.
//   row_tri / col_tri
//           separable triangle sums (box applied twice per axis, each
//           pass truncated to the image) of the frame (-> DC) and then of
//           the quadrature products iac*cos, iac*sin of 2*pi*P'/T.
//   finish  amplitude, atan2, per-pixel arccos refinement, amplitude
//           gate -> correction map, plus per (GATE_BAND band, column
//           tile) partial sums for the carrier gate.
//   snap    reduce each band's partials in a fixed order (no float
//           atomics: the gate is deterministic) -> gate -> P = P' +
//           correction -> triangulate.
//
// The carrier gate spans all columns of a band, so no tile decides it
// alone; that is why finish and snap are separate launches.
//
// The launches after track are also the standalone lock, slc_phase_lock,
// which replaces slc_tpu/pallas/phaselock.py:216 phase_lock_pallas: the
// same correction and re-triangulation on a given prediction P (u8 frame
// and f32 P in, P, z, x, y out: 21 B/px). With the open-loop step before
// it, it is the two-kernel form of the locked step, equal to the fused
// form bit for bit.
#include "common.cuh"

namespace {

constexpr double kPi = 3.141592653589793;
constexpr float kTwoPi = (float)(2.0 * kPi);
constexpr int kTrackW = 128, kTrackH = 32;   // track tile (outputs)
constexpr int kColW = 32, kColH = 64;        // col_tri tile
constexpr int kFinW = 32;                    // finish/snap tile columns
constexpr int kThreads = 256;

// Stage A (+ D open loop). The 3x3 mean pads with zeros outside the
// image where slc_tpu's composite reflects (REFLECT_101): the two agree
// because deltaP is zero within r >= 2 px of the border whenever the
// carried strips are (the wrapper's precondition).
__global__ void track_kernel(const uint8_t* __restrict__ frame,
                             const float* __restrict__ prev_sw,
                             const float* __restrict__ prev_sb,
                             const float* __restrict__ prev_pu,
                             float* __restrict__ pu_out,
                             float* __restrict__ sw_out,
                             float* __restrict__ sb_out, float* z_out,
                             float* x_out, float* y_out, int h, int w,
                             int r, int subpixel, int fbits,
                             int scale_gradient, int robust, Tri t) {
  extern __shared__ int smem[];
  const int x0 = blockIdx.x * kTrackW, y0 = blockIdx.y * kTrackH;
  const int eh = kTrackH + 2, ew = kTrackW + 2;   // strips + 1 px halo
  const int ncols = ew + 2 * r + 1;
  int* vs = smem;                                       // eh x ncols
  float* dp1 = reinterpret_cast<float*>(smem + eh * ncols);  // eh x ew
  box_sums_tile(frame, h, w, r, y0 - 1, eh, x0 - 1 - (r + 1), ncols, vs);
  __syncthreads();

  const int tid = threadIdx.x;
  for (int p = tid; p < eh * ew; p += blockDim.x) {
    const int er = p / ew, ec = p % ew;
    const int gy = y0 - 1 + er, gx = x0 - 1 + ec;
    float d = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      float sw = 0.0f, sb = 0.0f;
      if (gy >= r && gy < h - r && gx >= r && gx < w - r)
        extrema_px(vs + er * ncols, ec + r + 1, r, subpixel != 0, fbits,
                   &sw, &sb);
      const size_t gi = (size_t)gy * w + gx;
      // deltaP select (CCalculation.cpp:595-646; robust mean where the
      // two stripe families agree, slc_tpu/ops/stripe.py:161-183).
      const float d_b = prev_sb[gi] - sb, d_w = prev_sw[gi] - sw;
      d = fabsf(d_b) < fabsf(d_w) ? d_b : d_w;
      if (robust && fabsf(d_b - d_w) <= 1.0f) d = 0.5f * (d_b + d_w);
      if (er >= 1 && er <= kTrackH && ec >= 1 && ec <= kTrackW) {
        sw_out[gi] = sw;
        sb_out[gi] = sb;
      }
    }
    dp1[p] = d;
  }
  __syncthreads();

  for (int p = tid; p < kTrackH * kTrackW; p += blockDim.x) {
    const int er = p / kTrackW + 1, ec = p % kTrackW + 1;
    const int gy = y0 + er - 1, gx = x0 + ec - 1;
    if (gy >= h || gx >= w) continue;
    // 3x3 mean (CCalculation.cpp:650): rows, then columns.
    float s = 0.0f;
    for (int dx = -1; dx <= 1; ++dx) {
      const int c = ec + dx;
      s += dp1[(er - 1) * ew + c] + dp1[er * ew + c] + dp1[(er + 1) * ew + c];
    }
    float dp = s / 9.0f;
    const size_t gi = (size_t)gy * w + gx;
    if (scale_gradient) {
      // g = dP/du of the carried map, clipped to [0.2, 5]
      // (slc_tpu/dynamic.py:187-192).
      const float pr = gx + 1 < w ? prev_pu[gi + 1] : 0.0f;
      const float pl = gx >= 1 ? prev_pu[gi - 1] : 0.0f;
      const float g = 0.5f * (pr - pl);
      dp *= fminf(fmaxf(g, 0.2f), 5.0f);
    }
    const float pu = prev_pu[gi] + dp;     // CCalculation.cpp:652-660
    pu_out[gi] = pu;
    if (z_out != nullptr) {
      float z, x, y;
      triangulate_px(t, pu, gy, gx, &z, &x, &y);
      z_out[gi] = z;
      x_out[gi] = x;
      y_out[gi] = y;
    }
  }
}

// Row pass of the triangle: out[c] = sum over j in [c-r, c+r] of
// inner[j], inner[j] = sum over k in [j-r, j+r] of x[k], all indices
// truncated to [0, w) (slc_tpu/ops/demod.py:76-97). One block per row.
// MODE 0: x = frame. MODE 1: x = iac*cos(2*pi*P'/T), iac*sin(...), with
// iac = frame - dc.
template <int MODE>
__global__ void row_tri_kernel(const uint8_t* __restrict__ frame,
                               const float* __restrict__ dc,
                               const float* __restrict__ pu,
                               float two_over_t, float* __restrict__ out0,
                               float* __restrict__ out1, int w, int r) {
  constexpr int NF = MODE == 0 ? 1 : 2;
  extern __shared__ float sm[];
  float* xin = sm;             // NF x w
  float* inner = sm + NF * w;  // NF x w
  const size_t base = (size_t)blockIdx.x * w;
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    const float f = (float)frame[base + c];
    if (MODE == 0) {
      xin[c] = f;
    } else {
      const float iac = f - dc[base + c];
      float sn, cs;
      sincospif(pu[base + c] * two_over_t, &sn, &cs);
      xin[c] = iac * cs;
      xin[w + c] = iac * sn;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    const int lo = max(0, c - r), hi = min(w - 1, c + r);
    for (int f = 0; f < NF; ++f) {
      float s = 0.0f;
      for (int k = lo; k <= hi; ++k) s += xin[f * w + k];
      inner[f * w + c] = s;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    const int lo = max(0, c - r), hi = min(w - 1, c + r);
    for (int f = 0; f < NF; ++f) {
      float s = 0.0f;
      for (int k = lo; k <= hi; ++k) s += inner[f * w + k];
      (f == 0 ? out0 : out1)[base + c] = s;
    }
  }
}

// Column pass of the triangle on a kColH x kColW tile, with the same
// truncation. MODE 0: out0 = DC = sum / (wv[row] * wu[col]), the exact
// in-image weight. MODE 1: out0, out1 = the raw C and S sums.
template <int MODE>
__global__ void col_tri_kernel(const float* __restrict__ in0,
                               const float* __restrict__ in1,
                               float* __restrict__ out0,
                               float* __restrict__ out1,
                               const float* __restrict__ wu,
                               const float* __restrict__ wv, int h, int w,
                               int r) {
  constexpr int NF = MODE == 0 ? 1 : 2;
  extern __shared__ float sm[];
  const int nin = kColH + 4 * r, ninner = kColH + 2 * r;
  float* xin = sm;                       // NF x nin x kColW
  float* inner = sm + NF * nin * kColW;  // NF x ninner x kColW
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = blockIdx.x * kColW + tx, y0 = blockIdx.y * kColH;
  for (int lr = ty; lr < nin; lr += blockDim.y) {
    const int gy = y0 - 2 * r + lr;
    float v0 = 0.0f, v1 = 0.0f;
    if (gy >= 0 && gy < h && gx < w) {
      const size_t gi = (size_t)gy * w + gx;
      v0 = in0[gi];
      if (NF == 2) v1 = in1[gi];
    }
    xin[lr * kColW + tx] = v0;
    if (NF == 2) xin[(nin + lr) * kColW + tx] = v1;
  }
  __syncthreads();
  for (int j = ty; j < ninner; j += blockDim.y) {
    const int gj = y0 - r + j;
    for (int f = 0; f < NF; ++f) {
      float s = 0.0f;
      if (gj >= 0 && gj < h)
        for (int k = 0; k <= 2 * r; ++k) s += xin[(f * nin + j + k) * kColW + tx];
      inner[(f * ninner + j) * kColW + tx] = s;
    }
  }
  __syncthreads();
  for (int i = ty; i < kColH; i += blockDim.y) {
    const int gy = y0 + i;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    for (int f = 0; f < NF; ++f) {
      float s = 0.0f;
      for (int k = 0; k <= 2 * r; ++k)
        s += inner[(f * ninner + i + k) * kColW + tx];
      if (MODE == 0) {
        out0[gi] = s / (wv[gy] * wu[gx]);
      } else {
        (f == 0 ? out0 : out1)[gi] = s;
      }
    }
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

// Stage C's pointwise tail: the correction map, and per (band, column
// tile) the partial sums of gx*gm and gm, gx the wrapped difference of
// delta_phi between columns c-1 and c where both are ok
// (slc_tpu/ops/demod.py:204-224). Block: kFinW x 8 threads over one
// band of rows.
__global__ void finish_kernel(const uint8_t* __restrict__ frame,
                              const float* __restrict__ dc,
                              const float* __restrict__ pu,
                              const float* __restrict__ cc,
                              const float* __restrict__ ss,
                              const float* __restrict__ wu,
                              const float* __restrict__ wv,
                              float* __restrict__ corr,
                              float* __restrict__ partial, int h, int w,
                              int band, float phase_scale, float p_scale,
                              float amp_floor) {
  __shared__ float red_num[kThreads], red_den[kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = blockIdx.x * kFinW + tx, y0 = blockIdx.y * band;
  float num = 0.0f, den = 0.0f;
  for (int i = ty; i < band; i += blockDim.y) {
    const int gy = y0 + i;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    const float p = pu[gi];
    float amp, dphi;
    bool ok;
    demod_px(cc[gi], ss[gi], wv[gy] * wu[gx], p, amp_floor, &amp, &dphi,
             &ok);
    // Per-pixel arccos refinement against the window-corrected
    // prediction, blended by sin^2(phi).
    const float iac = (float)frame[gi] - dc[gi];
    const float cosp = fminf(fmaxf(iac / fmaxf(2.0f * amp, 1e-6f), -1.0f),
                             1.0f);
    const float phimag = acosf(cosp);
    const float phi_ref = phase_scale * p + dphi;
    const float d_pos = wrap_pi(phimag - phi_ref);
    const float d_neg = wrap_pi(-phimag - phi_ref);
    const float d_px = fabsf(d_pos) <= fabsf(d_neg) ? d_pos : d_neg;
    const float conf = 1.0f - cosp * cosp;
    const float dpl = (dphi + conf * d_px) * p_scale;
    corr[gi] = ok ? dpl : 0.0f;
    if (gx >= 1) {
      float amp_l, dphi_l;
      bool ok_l;
      demod_px(cc[gi - 1], ss[gi - 1], wv[gy] * wu[gx - 1], pu[gi - 1],
               amp_floor, &amp_l, &dphi_l, &ok_l);
      if (ok && ok_l) {
        num += wrap_pi(dphi - dphi_l);
        den += 1.0f;
      }
    }
  }
  const int t = ty * blockDim.x + tx;
  red_num[t] = num;
  red_den[t] = den;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      red_num[t] += red_num[t + s];
      red_den[t] += red_den[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    const size_t k = 2 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
    partial[k] = red_num[0];
    partial[k + 1] = red_den[0];
  }
}

// Stage C's gate and stage D: P = P' + correction where the band's
// amplitude-gated mean gradient is within the threshold, then
// triangulate. ``pu_in`` holds P', ``pu_out`` gets P; the locked step
// passes one buffer for both (each thread reads, then writes, its own
// pixel), the standalone lock a fresh output.
__global__ void snap_kernel(const float* pu_in, float* pu_out,
                            const float* __restrict__ corr,
                            const float* __restrict__ partial, int ntiles,
                            int gate_on, float thresh,
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
  }
  __syncthreads();
  const int gx = blockIdx.x * kFinW + tx, y0 = blockIdx.y * band;
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

size_t track_smem(int r) {
  const int eh = kTrackH + 2, ew = kTrackW + 2;
  return sizeof(int) * eh * (ew + 2 * r + 1) + sizeof(float) * eh * ew;
}

// Allow more than the default 48 KB of dynamic shared memory when asked.
template <typename K>
cudaError_t fit_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

cudaError_t launch_track(const uint8_t* frame, const float* prev_sw,
                         const float* prev_sb, const float* prev_pu,
                         float* pu, float* sw, float* sb, float* z,
                         float* x, float* y, int h, int w, int window,
                         int subpixel, int fbits, int scale_gradient,
                         int robust, const Tri& t, cudaStream_t stream) {
  const int r = window / 2;
  const dim3 grid((w + kTrackW - 1) / kTrackW, (h + kTrackH - 1) / kTrackH);
  const size_t smem = track_smem(r);
  cudaError_t err = fit_smem(track_kernel, smem);
  if (err != cudaSuccess) return err;
  track_kernel<<<grid, kThreads, smem, stream>>>(
      frame, prev_sw, prev_sb, prev_pu, pu, sw, sb, z, x, y, h, w, r,
      subpixel, fbits, scale_gradient, robust, t);
  return cudaGetLastError();
}

int n_bands(int h, int band) { return (h + band - 1) / band; }
int n_tiles(int w) { return (w + kFinW - 1) / kFinW; }

// Where the lock's launches stop: all of them, or (profiling only) after
// the DC passes or after the C/S passes.
enum LockStop { kLockAll = 0, kLockAfterDc = 2, kLockAfterCorr = 3 };

// Launches B-D of the locked step: the lock-in correction of the
// prediction ``pred`` and the re-triangulation, P into ``pu_out`` (which
// may be ``pred`` itself). Shared by the locked step, which gives it the
// P' of launch A, and by the standalone lock, which gives it the
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
  float* ta = scratch + npx;       // row pass; later the correction map
  float* tb = scratch + 2 * npx;
  float* cc = scratch + 3 * npx;
  float* ss = scratch + 4 * npx;
  float* partial = scratch + 5 * npx;
  const int ru = win_u / 2, rv = win_v / 2;
  const float two_over_t = (float)(2.0 / (double)period);
  const float phase_scale = (float)(2.0 * kPi / (double)period);
  const float p_scale = (float)((double)period / (2.0 * kPi));
  cudaError_t err;

  // B: DC = triangle(frame) / weight.
  const size_t smem_r0 = sizeof(float) * 2 * w;
  if ((err = fit_smem(row_tri_kernel<0>, smem_r0)) != cudaSuccess)
    return err;
  row_tri_kernel<0><<<h, kThreads, smem_r0, stream>>>(
      frame, nullptr, nullptr, 0.0f, ta, nullptr, w, ru);
  const dim3 cgrid((w + kColW - 1) / kColW, (h + kColH - 1) / kColH);
  const dim3 cblock(kColW, 8);
  const size_t smem_c0 = sizeof(float) * kColW * (kColH + 4 * rv + kColH + 2 * rv);
  if ((err = fit_smem(col_tri_kernel<0>, smem_c0)) != cudaSuccess)
    return err;
  col_tri_kernel<0><<<cgrid, cblock, smem_c0, stream>>>(
      ta, nullptr, dc, nullptr, wu, wv, h, w, rv);
  if (stop == kLockAfterDc) return cudaGetLastError();

  // B + C: C and S = triangle(iac * cos, iac * sin of 2*pi*pred/T).
  const size_t smem_r1 = sizeof(float) * 4 * w;
  if ((err = fit_smem(row_tri_kernel<1>, smem_r1)) != cudaSuccess)
    return err;
  row_tri_kernel<1><<<h, kThreads, smem_r1, stream>>>(
      frame, dc, pred, two_over_t, ta, tb, w, ru);
  const size_t smem_c1 = 2 * smem_c0;
  if ((err = fit_smem(col_tri_kernel<1>, smem_c1)) != cudaSuccess)
    return err;
  col_tri_kernel<1><<<cgrid, cblock, smem_c1, stream>>>(
      ta, tb, cc, ss, wu, wv, h, w, rv);
  if (stop == kLockAfterCorr) return cudaGetLastError();

  // C: correction map and gate partials; then gate, snap, triangulate.
  const dim3 fgrid(n_tiles(w), n_bands(h, band));
  const dim3 fblock(kFinW, kThreads / kFinW);
  float* corr = ta;
  finish_kernel<<<fgrid, fblock, 0, stream>>>(
      frame, dc, pred, cc, ss, wu, wv, corr, partial, h, w, band,
      phase_scale, p_scale, amp_floor);
  snap_kernel<<<fgrid, fblock, 0, stream>>>(
      pred, pu_out, corr, partial, n_tiles(w), gate_on, gate_thresh, z, x,
      y, h, w, band, t);
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

// Floats of scratch the locked step and the standalone lock need: DC, two
// row-pass buffers (the first reused for the correction map), C, S, and
// the band partials.
extern "C" long slc_dynamic_step_lock_scratch(int h, int w, int band) {
  return 5L * h * w + 2L * n_bands(h, band) * n_tiles(w);
}

// ``ablate`` (profiling only; the outputs are then garbage): 0 runs every
// launch, 1 stops after launch A (track), 2 after the DC passes, 3 after
// the C/S passes, as slc_tpu/pallas/dynamic_lock.py:316-319 truncates its
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
  // A: track and integrate; P' lands in ``pu``.
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
// phase_lock_pallas): launches B-D on the caller's prediction ``pred``,
// which is only read; P, z, x, y go to fresh outputs.
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

// One point-to-plane Gauss-Newton step over the poses of a multi-view
// registration (slc_tpu_torch/fusion.py _gn_step_p2l), in three launches.
//
// S views observe L landmarks: obs (S, L, 3) in each view's frame, mask
// (S, L), landmarks and their world normals (L, 3), poses rot (S, 3, 3)
// and trans (S, 3). For a pair (s, l): p = R_s y + t_s, the masked
// residual e = m n . (p - X).
//   1. Statistics, a grid of (blocks, S): per block the sums of p m (3),
//      of m and of |e|.
//   2. Normal equations, the same grid. Every block first reduces pass
//      1's partials: its view's centroid c = sum(p m) / max(sum m, 1) and
//      the Huber threshold delta = 3 sum|e| / max(sum m, 1) + 1e-6 over
//      all views (e does not depend on c, so one pass gives both). Then
//      per pair w = sqrt(min(delta / (|e| + 1e-12), 1)) and
//      j = [n, -(n x (p - c))] m w, in registers, and per block the sums
//      of the 21 distinct entries of j j^T and the 6 of j e w.
//   3. Solve and update, one block, a warp a view: the view's sums over
//      its blocks, the damping A_ii += damping A_ii + 1e-9, one LU solve
//      with partial pivoting of A delta = -b (its code as LAPACK's getrf
//      gives it: the first zero pivot, 1-based, else 0), view 0's delta
//      zeroed (the gauge), then R' = exp(w) R and
//      t' = exp(w) (t - c) + c + dt over the output poses, which may be
//      the input's buffers; the views' codes summed onto *info.
//
// Replaces no TPU kernel: slc_tpu runs the step as XLA einsums and a
// batched solve (slc_tpu/fusion.py:173-243). Its plain PyTorch version
// is ~100 launches a step, one of them a cuBLAS GEMM for j^T j with N = 6
// over K = L that runs one 32x32 tile a view (~16 blocks on 132 SMs).
//
// Bound: bytes. Each pass reads obs and mask (16 B a pair) and the
// landmarks and normals (24 B a landmark), ~46 MB a step at S = 16 and
// L = 81,920; j never reaches memory. Blocks grid-stride over their
// view's landmarks, the wrapper sizing the grid to about two blocks an
// SM. Every sum is taken in one fixed order (a thread's pairs in turn,
// then warp shuffles, then the warps, then the blocks in index order),
// with no atomics, so a step is bit-for-bit repeatable. Float32
// throughout, as the plain step; divisions and square roots are IEEE.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // kernels/p2l.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kStats = 5;   // sum p m (3), sum m, sum |e|
constexpr int kTerms = 27;  // j j^T's upper triangle row by row (21), j e w
constexpr int kSolveWarps = 32;

struct Pose {
  float r[9];
  float t[3];
};

__device__ __forceinline__ Pose load_pose(const float* rot,
                                          const float* trans, int s) {
  Pose p;
#pragma unroll
  for (int k = 0; k < 9; ++k) p.r[k] = rot[9 * s + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) p.t[k] = trans[3 * s + k];
  return p;
}

// Pair i of a view: p = R y + t and n, in registers; returns the
// unmasked residual n . (p - X).
__device__ __forceinline__ float predict(const Pose& P,
                                         const float* __restrict__ y,
                                         const float* __restrict__ lm,
                                         const float* __restrict__ nrm,
                                         int i, float (&p)[3],
                                         float (&n)[3]) {
  const float y0 = y[3 * i], y1 = y[3 * i + 1], y2 = y[3 * i + 2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = P.r[3 * k] * y0 + P.r[3 * k + 1] * y1 + P.r[3 * k + 2] * y2 +
           P.t[k];
    n[k] = __ldg(nrm + 3 * i + k);
  }
  return n[0] * (p[0] - __ldg(lm + 3 * i)) +
         n[1] * (p[1] - __ldg(lm + 3 * i + 1)) +
         n[2] * (p[2] - __ldg(lm + 3 * i + 2));
}

// The block's sums of v, in out[] for every thread after the call: each
// warp by shuffles (lane i takes lane i + 16, 8, 4, 2, 1), then warp 0
// over the warps' sums in the same way. ``red`` holds kWarps * N floats.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red,
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float x = lane < kWarps ? red[lane * N + k] : 0.0f;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) out[k] = x;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    p2l_stats_kernel(const float* __restrict__ obs,
                     const float* __restrict__ mask,
                     const float* __restrict__ lm,
                     const float* __restrict__ nrm,
                     const float* __restrict__ rot,
                     const float* __restrict__ trans,
                     float* __restrict__ part1, int l) {
  __shared__ float red[kWarps * kStats];
  __shared__ float tot[kStats];
  const int s = blockIdx.y, nb = gridDim.x;
  const Pose P = load_pose(rot, trans, s);
  const float* y = obs + (size_t)s * l * 3;
  const float* m = mask + (size_t)s * l;
  float acc[kStats] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < l;
       i += nb * kThreads) {
    const float mi = m[i];
    float p[3], n[3];
    const float e = predict(P, y, lm, nrm, i, p, n) * mi;
    acc[0] += p[0] * mi;
    acc[1] += p[1] * mi;
    acc[2] += p[2] * mi;
    acc[3] += mi;
    acc[4] += fabsf(e);
  }
  block_sum(acc, red, tot);
  if (threadIdx.x < kStats)
    part1[((size_t)s * nb + blockIdx.x) * kStats + threadIdx.x] =
        tot[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
    p2l_normal_kernel(const float* __restrict__ obs,
                      const float* __restrict__ mask,
                      const float* __restrict__ lm,
                      const float* __restrict__ nrm,
                      const float* __restrict__ rot,
                      const float* __restrict__ trans,
                      const float* __restrict__ part1,
                      float* __restrict__ part2,
                      float* __restrict__ center, int views, int l) {
  __shared__ float red[kWarps * kTerms];
  __shared__ float tot[kTerms];
  const int s = blockIdx.y, nb = gridDim.x, t = threadIdx.x;
  // This view's sums of p m and m; every view's sums of m and |e|.
  float st[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = t; b < nb; b += kThreads) {
    const float* q = part1 + ((size_t)s * nb + b) * kStats;
#pragma unroll
    for (int k = 0; k < 4; ++k) st[k] += q[k];
  }
  for (int i = t; i < views * nb; i += kThreads) {
    st[4] += part1[(size_t)i * kStats + 3];
    st[5] += part1[(size_t)i * kStats + 4];
  }
  block_sum(st, red, tot);
  const float nobs = fmaxf(tot[3], 1.0f);
  const float c0 = tot[0] / nobs, c1 = tot[1] / nobs, c2 = tot[2] / nobs;
  const float delta = __fadd_rn(
      __fmul_rn(3.0f, tot[5] / fmaxf(tot[4], 1.0f)), 1e-6f);
  if (blockIdx.x == 0 && t == 0) {
    center[3 * s] = c0;
    center[3 * s + 1] = c1;
    center[3 * s + 2] = c2;
  }
  __syncthreads();  // every thread has read tot before it is reused

  const Pose P = load_pose(rot, trans, s);
  const float* y = obs + (size_t)s * l * 3;
  const float* m = mask + (size_t)s * l;
  float h[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) h[k] = 0.0f;
  for (int i = blockIdx.x * kThreads + t; i < l; i += nb * kThreads) {
    const float mi = m[i];
    float p[3], n[3];
    const float e = predict(P, y, lm, nrm, i, p, n) * mi;
    const float w = sqrtf(fminf(delta / (fabsf(e) + 1e-12f), 1.0f));
    const float ew = e * w, mw = mi * w;
    const float v0 = p[0] - c0, v1 = p[1] - c1, v2 = p[2] - c2;
    float j[6];
    j[0] = n[0] * mw;
    j[1] = n[1] * mw;
    j[2] = n[2] * mw;
    j[3] = -(n[1] * v2 - n[2] * v1) * mw;
    j[4] = -(n[2] * v0 - n[0] * v2) * mw;
    j[5] = -(n[0] * v1 - n[1] * v0) * mw;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) h[k++] += j[a] * j[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) h[21 + a] += j[a] * ew;
  }
  block_sum(h, red, tot);
  if (t < kTerms)
    part2[((size_t)s * nb + blockIdx.x) * kTerms + t] = tot[t];
}

// A view's system from its sums (sys: kTerms floats), solved, and its
// pose updated; returns the solve's code (0, or the first zero pivot,
// 1-based). r_out and t_out may be r_in and t_in.
__device__ int solve_update(const float* sys, bool gauge, float damping,
                            const float* c, const float* r_in,
                            const float* t_in, float* r_out,
                            float* t_out) {
  float a[6][6], x[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      a[i][j] = sys[k];
      a[j][i] = sys[k];
      ++k;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[i][i] = a[i][i] + (damping * a[i][i] + 1e-9f);
    x[i] = -sys[21 + i];
  }
  int code = 0;
#pragma unroll
  for (int col = 0; col < 6; ++col) {
    int piv = col;
    float best = fabsf(a[col][col]);
#pragma unroll
    for (int r = col + 1; r < 6; ++r) {
      if (fabsf(a[r][col]) > best) {
        best = fabsf(a[r][col]);
        piv = r;
      }
    }
#pragma unroll
    for (int r = col + 1; r < 6; ++r) {
      if (r == piv) {
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          const float tmp = a[col][cc];
          a[col][cc] = a[r][cc];
          a[r][cc] = tmp;
        }
        const float tmp = x[col];
        x[col] = x[r];
        x[r] = tmp;
      }
    }
    if (a[col][col] == 0.0f) {
      if (code == 0) code = col + 1;
      continue;
    }
#pragma unroll
    for (int r = col + 1; r < 6; ++r) {
      const float f = a[r][col] / a[col][col];
#pragma unroll
      for (int cc = col + 1; cc < 6; ++cc) a[r][cc] -= f * a[col][cc];
      x[r] -= f * x[col];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) v -= a[i][j] * x[j];
    x[i] = v / a[i][i];
  }
  if (gauge) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  }

  // exp(w), w = x[3:6], as se3.exp_so3: I + a K + b K^2.
  const float w0 = x[3], w1 = x[4], w2 = x[5];
  const float theta = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
  const float th = fmaxf(theta, 1e-12f);
  float ca = sinf(th) / th, cb = (1.0f - cosf(th)) / (th * th);
  if (theta < 1e-6f) {
    ca = 1.0f;
    cb = 0.5f;
  }
  const float kk[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float dr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float k2 =
          kk[i][0] * kk[0][j] + kk[i][1] * kk[1][j] + kk[i][2] * kk[2][j];
      dr[i][j] = ((i == j ? 1.0f : 0.0f) + ca * kk[i][j]) + cb * k2;
    }
  }

  float r[9], v[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = r_in[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = t_in[i] - c[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r_out[3 * i + j] =
          dr[i][0] * r[j] + dr[i][1] * r[3 + j] + dr[i][2] * r[6 + j];
    t_out[i] = (dr[i][0] * v[0] + dr[i][1] * v[1] + dr[i][2] * v[2] + c[i]) +
               x[i];
  }
  return code;
}

// One block of up to kSolveWarps warps; warp w takes views w, w + warps,
// ... Lane k < kTerms sums entry k of the view's partials in block order.
__global__ void __launch_bounds__(32 * kSolveWarps)
    p2l_solve_kernel(const float* __restrict__ part2,
                     const float* __restrict__ center, const float* rot,
                     const float* trans, float* rot_out, float* trans_out,
                     long long* __restrict__ info, int views, int nb,
                     float damping) {
  __shared__ float sys[kSolveWarps][kTerms];
  __shared__ int codes[kSolveWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int code = 0;
  for (int s = warp; s < views; s += warps) {
    if (lane < kTerms) {
      float acc = 0.0f;
      for (int b = 0; b < nb; ++b)
        acc += part2[((size_t)s * nb + b) * kTerms + lane];
      sys[warp][lane] = acc;
    }
    __syncwarp();
    if (lane == 0)
      code += solve_update(sys[warp], s == 0, damping, center + 3 * s,
                           rot + 9 * s, trans + 3 * s, rot_out + 9 * s,
                           trans_out + 3 * s);
    __syncwarp();
  }
  if (lane == 0) codes[warp] = code;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int w = 0; w < warps; ++w) sum += codes[w];
    *info += sum;
  }
}

}  // namespace

// The three launches of one step on ``stream``. ``blocks`` a view in
// passes 1 and 2 (the wrapper's choice); part1 holds S * blocks * 5
// floats, part2 S * blocks * 27, center S * 3. rot_out and trans_out may
// be rot and trans.
extern "C" int slc_p2l_step(const float* obs, const float* mask,
                            const float* landmarks, const float* normals,
                            const float* rot, const float* trans,
                            float* rot_out, float* trans_out, float* part1,
                            float* part2, float* center, long long* info,
                            int views, int l, int blocks, float damping,
                            cudaStream_t stream) {
  if (views < 1 || views > 65535 || l < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, views);
  p2l_stats_kernel<<<grid, kThreads, 0, stream>>>(
      obs, mask, landmarks, normals, rot, trans, part1, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p2l_normal_kernel<<<grid, kThreads, 0, stream>>>(
      obs, mask, landmarks, normals, rot, trans, part1, part2, center, views,
      l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = views < kSolveWarps ? views : kSolveWarps;
  p2l_solve_kernel<<<1, 32 * warps, 0, stream>>>(
      part2, center, rot, trans, rot_out, trans_out, info, views, blocks,
      damping);
  return (int)cudaGetLastError();
}

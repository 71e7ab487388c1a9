// Gray + phase-shift absolute decode, one thread per pixel.
//
// Replaces slc_tpu/pallas/grayphase.py:152 grayphase_decode_pallas. Per
// pixel: Gray bits (pattern > inverse, LSB first) -> XOR-prefix
// Gray->binary -> N-step atan2 (closed form for N = 4) -> Gray-parity
// half-period merge -> optional modulation mask -> rational
// triangulation with C and D rebuilt from their six coefficients ->
// x, y back-projection. It reads 2B+N u8 planes and writes 4 f32 maps:
// 32 B/px at the reference config, so device-memory bandwidth bounds it;
// the tables are never streamed.
#include "common.cuh"

namespace {

constexpr float kTwoPi = 6.283185307179586f;

__global__ void grayphase_kernel(const uint8_t* __restrict__ gray,
                                 const uint8_t* __restrict__ phase,
                                 float* __restrict__ x_out,
                                 float* __restrict__ y_out,
                                 float* __restrict__ z_out,
                                 float* __restrict__ pu_out, int h, int w,
                                 int bits, int n, float gray_period,
                                 float phase_period, int use_mod,
                                 float min_mod_sq, Tri t) {
  const size_t npx = (size_t)h * w;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= npx) return;
  const int row = (int)(idx / w), col = (int)(idx % w);

  // Gray decode (CDecodeGray.cpp:159-171, :192-199), u8 widened to int.
  int g = 0;
  for (int k = 0; k < bits; ++k) {
    const int pat = gray[(size_t)(2 * k) * npx + idx];
    const int inv = gray[(size_t)(2 * k + 1) * npx + idx];
    if (pat > inv) g |= 1 << k;
  }
  int b = g;
  for (int shift = 1; shift < bits; shift <<= 1) b ^= b >> shift;
  const float gray_coord = (float)b * gray_period;

  // N-step phase (slc_tpu/ops/phase.py:34-48). For N = 4 the
  // coefficients are exactly {1, 0, -1, 0} / {0, 1, 0, -1}: integer
  // differences of the widened planes.
  float s = 0.0f, c = 0.0f;
  if (n == 4) {
    const int p0 = phase[idx], p1 = phase[npx + idx];
    const int p2 = phase[2 * npx + idx], p3 = phase[3 * npx + idx];
    s = (float)(p0 - p2) * 0.5f;
    c = (float)(p1 - p3) * 0.5f;
  } else {
    for (int k = 0; k < n; ++k) {
      float sk, ck;
      sincospif(2.0f * (float)k / (float)n, &sk, &ck);
      const float img = (float)phase[(size_t)k * npx + idx];
      s += img * (ck * 2.0f / (float)n);
      c += img * (sk * 2.0f / (float)n);
    }
  }
  float ang = atan2f(s, c);
  if (ang < 0.0f) ang += kTwoPi;
  float pix = ang * (phase_period / kTwoPi) + 0.5f;
  if (pix > phase_period) pix -= phase_period;

  // Gray-assisted merge (CCalculation.cpp:561-587): the Gray-bin parity
  // picks the half-period; guard bands fix adjacent-bin wraps.
  const float tp = phase_period;
  float ph;
  if ((b & 1) == 0) {
    ph = pix > 0.75f * tp ? pix - tp : pix;
  } else {
    ph = (pix < 0.25f * tp ? pix + tp : pix) - 0.5f * tp;
  }
  float pu = gray_coord + ph;
  if (use_mod && !(s * s + c * c > min_mod_sq)) pu = 0.0f;

  float z, x, y;
  triangulate_px(t, pu, row, col, &z, &x, &y);
  x_out[idx] = x;
  y_out[idx] = y;
  z_out[idx] = z;
  pu_out[idx] = pu;
}

}  // namespace

extern "C" int slc_grayphase(const uint8_t* gray, const uint8_t* phase,
                             float* x, float* y, float* z, float* pu, int h,
                             int w, int bits, int n, float gray_period,
                             float phase_period, int use_mod,
                             float min_mod_sq, const float* tri,
                             cudaStream_t stream) {
  const size_t npx = (size_t)h * w;
  const int threads = 256;
  const unsigned blocks = (unsigned)((npx + threads - 1) / threads);
  grayphase_kernel<<<blocks, threads, 0, stream>>>(
      gray, phase, x, y, z, pu, h, w, bits, n, gray_period, phase_period,
      use_mod, min_mod_sq, tri_from_host(tri));
  return (int)cudaGetLastError();
}

extern "C" const char* slc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

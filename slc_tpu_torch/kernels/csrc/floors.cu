// Access-pattern floors: a compute kernel's reads and writes with the
// compute deleted.
//
// Replaces slc_tpu/pallas/floors.py:25 halo_block_floor. Timed beside the
// kernel it stands for, it gives the "% of measured floor" of that
// kernel: the least time its pattern of device-memory traffic takes on
// this card, tile halos, launch and tail included. Each tile stages its
// pixels and halo in shared memory, as the real kernel does, then n_out
// full-size f32 maps o_k = float(img) + k are written. The patterns (the
// tile geometry and its halo re-reads, which set the bytes) are the
// port's, not the TPU kernel's row blocks:
//
//   u8 image  (the stripe kernel, csrc/stripe.cu): 128x32 tiles, halo
//             rows above and below, halo + 1 columns left, halo right.
//   f32 image (the bilateral filter, csrc/bilateral.cu): 32x8 tiles with
//             a ring of halo px.
//
// Bound by device memory (the outputs: 8 B/px of the u8 pattern's 9, 4 of
// the f32 pattern's 8). So the moving is what is designed: tile sizes
// are compile-time; rows are staged in 16-byte chunks (stage_tiles in
// common.cuh, several loads in flight per thread) where the row pitch
// allows, element by element at a ragged width; a block writes 128
// columns (one warp per row, float4 stores where w % 4 == 0). A block of
// the f32 pattern holds four tiles side by side, each with its own ring,
// on 128 threads: 1280 blocks at 1024x1280, all resident at once (the
// u8 pattern's 320 blocks of 256 threads are too).
#include "common.cuh"

namespace {

constexpr int kBlockW = 128;   // output columns of a block: 4 per lane

// The shared-memory geometry of one tile of TW x TH outputs of T: staged
// rows TH + 2 halo_y; ``lead`` columns left of the tile (halo_l rounded up
// to a 16-byte chunk), then the tile and halo_r more, in ``nchunk``
// chunks of E elements.
template <typename T, int TW, int TH>
struct FloorPlan {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int NTX = kBlockW / TW;   // tiles per block
  static_assert(TW % E == 0 && kBlockW % TW == 0, "tile geometry");
  int halo_y, rows, lead, nchunk, pitch;
  __host__ __device__ FloorPlan(int hy, int hl, int hr)
      : halo_y(hy), rows(TH + 2 * hy), lead((hl + E - 1) / E * E),
        nchunk((lead + TW + hr + E - 1) / E), pitch(nchunk * E) {}
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(T) * NTX * rows * pitch;
  }
};

__device__ __forceinline__ void load4(const uint8_t* s, float (&v)[4]) {
  const uchar4 q = *reinterpret_cast<const uchar4*>(s);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const float* s, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// One block of NT threads: the NTX tiles of columns [xb, xb + kBlockW),
// rows [y0, y0 + TH). ``vec_in``: rows staged in 16-byte chunks;
// ``vec_out``: float4 stores (w % 4 == 0, out 16-byte aligned).
template <typename T, int TW, int TH, int NT>
__global__ void __launch_bounds__(NT)
floor_kernel(const T* __restrict__ img, float* __restrict__ out,
             int n_out, int h, int w, int halo_y, int halo_l, int halo_r,
             bool vec_in, bool vec_out) {
  using Plan = FloorPlan<T, TW, TH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  const Plan pl(halo_y, halo_l, halo_r);
  const int xb = blockIdx.x * kBlockW, y0 = blockIdx.y * TH;
  const int tile_elems = pl.rows * pl.pitch;
  stage_tiles<T>(img, h, w, vec_in, y0 - halo_y, pl.rows, xb - pl.lead,
                 pl.nchunk, Plan::NTX, TW, tiles, pl.pitch, tile_elems);
  __syncthreads();

  const int c = 4 * (threadIdx.x & 31);      // the lane's first column
  const int t = c / TW;
  const T* src = tiles + t * tile_elems + halo_y * pl.pitch + pl.lead +
                 (c - t * TW);
  const int gx = xb + c;
  if (gx >= w) return;
  const size_t npx = (size_t)h * w;
  for (int i = threadIdx.x >> 5; i < TH; i += NT / 32) {
    const int gy = y0 + i;
    if (gy >= h) break;
    float v[4];
    load4(src + i * pl.pitch, v);
    float* o = out + (size_t)gy * w + gx;
    if (vec_out && gx + 4 <= w) {
      for (int k = 0; k < n_out; ++k) {
        const float f = (float)k;
        *reinterpret_cast<float4*>(o + k * npx) =
            make_float4(v[0] + f, v[1] + f, v[2] + f, v[3] + f);
      }
    } else {
      for (int k = 0; k < n_out; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (gx + m < w) o[k * npx + m] = v[m] + (float)k;
    }
  }
}

template <typename T, int TW, int TH, int NT>
cudaError_t launch_floor(const T* img, float* out, int n_out, int h, int w,
                         int halo_y, int halo_l, int halo_r,
                         cudaStream_t stream) {
  using Plan = FloorPlan<T, TW, TH>;
  const size_t smem = Plan(halo_y, halo_l, halo_r).smem_bytes();
  const cudaError_t err = fit_smem(floor_kernel<T, TW, TH, NT>, smem);
  if (err != cudaSuccess) return err;
  const bool vec_in = w % Plan::E == 0 && (uintptr_t)img % 16 == 0;
  const bool vec_out = w % 4 == 0 && (uintptr_t)out % 16 == 0;
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + TH - 1) / TH);
  floor_kernel<T, TW, TH, NT><<<grid, NT, smem, stream>>>(
      img, out, n_out, h, w, halo_y, halo_l, halo_r, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// ``out`` holds n_out contiguous (h, w) f32 maps.
extern "C" int slc_halo_block_floor_u8(const uint8_t* img, float* out,
                                       int n_out, int h, int w, int halo,
                                       cudaStream_t stream) {
  return (int)launch_floor<uint8_t, 128, 32, 256>(
      img, out, n_out, h, w, halo, halo + 1, halo, stream);
}

extern "C" int slc_halo_block_floor_f32(const float* img, float* out,
                                        int n_out, int h, int w, int halo,
                                        cudaStream_t stream) {
  return (int)launch_floor<float, 32, 8, 128>(img, out, n_out, h, w, halo,
                                              halo, halo, stream);
}

// Access-pattern floors: a compute kernel's reads and writes with the
// compute deleted.
//
// Replaces slc_tpu/pallas/floors.py:25 halo_block_floor. Timed beside the
// kernel it stands for, it gives the "% of measured floor" of that
// kernel: the least time its pattern of device-memory traffic takes on
// this card, tile halos, launch and tail included. A block stages its
// tile and halo in shared memory, as the real kernel does, then writes
// n_out full-size f32 maps o_k = float(img) + k. The patterns are the
// port's, not the TPU kernel's row blocks:
//
//   u8 image  (the stripe kernel, csrc/stripe.cu): 128x32 tiles, halo
//             rows above and below, halo + 1 columns left, halo right.
//   f32 image (the bilateral filter, csrc/bilateral.cu): 32x8 tiles with
//             a ring of halo px.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void floor_kernel(const T* __restrict__ img,
                             float* __restrict__ out, int n_out, int h,
                             int w, int tile_h, int tile_w, int halo_y,
                             int halo_l, int halo_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int x0 = blockIdx.x * tile_w, y0 = blockIdx.y * tile_h;
  const int eh = tile_h + 2 * halo_y, ew = tile_w + halo_l + halo_r;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < eh * ew; i += nthreads) {
    const int gy = y0 - halo_y + i / ew, gx = x0 - halo_l + i % ew;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? img[(size_t)gy * w + gx]
                  : T(0);
  }
  __syncthreads();
  const size_t npx = (size_t)h * w;
  for (int p = tid; p < tile_h * tile_w; p += nthreads) {
    const int rr = p / tile_w, cx = p % tile_w;
    const int gy = y0 + rr, gx = x0 + cx;
    if (gy >= h || gx >= w) continue;
    const float v = (float)tile[(rr + halo_y) * ew + cx + halo_l];
    const size_t gi = (size_t)gy * w + gx;
    for (int k = 0; k < n_out; ++k) out[k * npx + gi] = v + (float)k;
  }
}

template <typename T>
cudaError_t launch_floor(const T* img, float* out, int n_out, int h, int w,
                         int tile_h, int tile_w, int halo_y, int halo_l,
                         int halo_r, dim3 block, cudaStream_t stream) {
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
  const size_t smem =
      sizeof(T) * (tile_h + 2 * halo_y) * (tile_w + halo_l + halo_r);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        floor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  floor_kernel<T><<<grid, block, smem, stream>>>(
      img, out, n_out, h, w, tile_h, tile_w, halo_y, halo_l, halo_r);
  return cudaGetLastError();
}

}  // namespace

// ``out`` holds n_out contiguous (h, w) f32 maps.
extern "C" int slc_halo_block_floor_u8(const uint8_t* img, float* out,
                                       int n_out, int h, int w, int halo,
                                       cudaStream_t stream) {
  return (int)launch_floor<uint8_t>(img, out, n_out, h, w, 32, 128, halo,
                                    halo + 1, halo, dim3(kThreads), stream);
}

extern "C" int slc_halo_block_floor_f32(const float* img, float* out,
                                        int n_out, int h, int w, int halo,
                                        cudaStream_t stream) {
  return (int)launch_floor<float>(img, out, n_out, h, w, 8, 32, halo, halo,
                                  halo, dim3(32, 8), stream);
}

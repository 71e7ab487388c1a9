// Host-to-device staging of camera frames, queued whole on one stream.
//
// Not a port of a TPU kernel: it is the port's counterpart of
// jax.device_put, which queues a transfer and returns. The streaming
// loop's HostStager (slc_tpu_torch/streaming.py) calls it once per frame,
// or once per stack of frames, so that its thread only enqueues while the
// copies run beside the tracker's launches:
//
//   1. cudaLaunchHostFunc: a plain memcpy of each host part (a numpy
//      frame, pageable memory) into its place in a pinned buffer. The
//      function runs on CUDA's own callback thread, in stream order,
//      with no Python lock held; it makes no CUDA call (none is allowed
//      there) and frees its job.
//   2. cudaMemcpyAsync: the pinned buffer to the device, behind the
//      memcpy on the same stream.
//
// Stream order is what keeps the buffers right: a pinned buffer is
// written again only by a later call on the same stream, so after the
// device copy that read it. The caller keeps each host part alive until
// an event it records after this call has completed.
#include <cuda_runtime.h>

#include <cstdlib>
#include <cstring>

namespace {

// One call's copies into pinned memory; the n source pointers follow
// the struct in the same allocation.
struct StageJob {
  char* dst;
  size_t part_bytes;
  int n;
};

void CUDART_CB copy_parts(void* arg) {
  StageJob* job = static_cast<StageJob*>(arg);
  const void* const* src = reinterpret_cast<const void* const*>(job + 1);
  for (int i = 0; i < job->n; ++i) {
    memcpy(job->dst + (size_t)i * job->part_bytes, src[i], job->part_bytes);
  }
  free(job);
}

}  // namespace

// Copy n host parts of part_bytes each into the pinned buffer ``pinned``
// (part i at offset i * part_bytes), then ``pinned`` into the device
// buffer ``dev`` (n * part_bytes), both queued on ``stream``. Returns a
// cudaError_t (after a failed device copy the memcpy into ``pinned`` is
// still queued, and still frees its job).
extern "C" int slc_stage_h2d(const void* const* src, int n,
                             size_t part_bytes, void* pinned, void* dev,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1) return (int)cudaErrorInvalidValue;
  StageJob* job = static_cast<StageJob*>(
      malloc(sizeof(StageJob) + (size_t)n * sizeof(const void*)));
  if (job == nullptr) return (int)cudaErrorMemoryAllocation;
  job->dst = static_cast<char*>(pinned);
  job->part_bytes = part_bytes;
  job->n = n;
  const void** dst_src = reinterpret_cast<const void**>(job + 1);
  for (int i = 0; i < n; ++i) dst_src[i] = src[i];
  cudaError_t err = cudaLaunchHostFunc(stream, copy_parts, job);
  if (err != cudaSuccess) {
    free(job);
    return (int)err;
  }
  return (int)cudaMemcpyAsync(dev, pinned, (size_t)n * part_bytes,
                              cudaMemcpyHostToDevice, stream);
}

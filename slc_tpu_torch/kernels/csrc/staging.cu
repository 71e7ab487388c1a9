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
//
// A timed call (the program's spans are recording) also times its host
// function on CLOCK_MONOTONIC: the delay from the enqueue to the
// function's start, and the memcpy. The sums, the largest delay and the
// count of timed jobs are read by slc_stage_stats. An untimed call reads
// no clock and touches no counter.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <ctime>

namespace {

// One call's copies into pinned memory; the n source pointers follow
// the struct in the same allocation. t_enqueue is 0 for an untimed call.
struct StageJob {
  char* dst;
  size_t part_bytes;
  int n;
  long long t_enqueue;
};

std::atomic<long long> g_jobs{0};
std::atomic<long long> g_delay_ns{0};
std::atomic<long long> g_delay_max_ns{0};
std::atomic<long long> g_copy_ns{0};

long long now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

void CUDART_CB copy_parts(void* arg) {
  StageJob* job = static_cast<StageJob*>(arg);
  const void* const* src = reinterpret_cast<const void* const*>(job + 1);
  const long long t0 = job->t_enqueue ? now_ns() : 0;
  for (int i = 0; i < job->n; ++i) {
    memcpy(job->dst + (size_t)i * job->part_bytes, src[i], job->part_bytes);
  }
  if (job->t_enqueue) {
    const long long delay = t0 - job->t_enqueue;
    g_copy_ns.fetch_add(now_ns() - t0);
    g_delay_ns.fetch_add(delay);
    long long max = g_delay_max_ns.load();
    while (delay > max && !g_delay_max_ns.compare_exchange_weak(max, delay)) {
    }
    g_jobs.fetch_add(1);
  }
  free(job);
}

}  // namespace

// Copy n host parts of part_bytes each into the pinned buffer ``pinned``
// (part i at offset i * part_bytes), then ``pinned`` into the device
// buffer ``dev`` (n * part_bytes), both queued on ``stream``; ``timed``
// non-zero times the host function (above). Returns a cudaError_t (after
// a failed device copy the memcpy into ``pinned`` is still queued, and
// still frees its job).
extern "C" int slc_stage_h2d(const void* const* src, int n,
                             size_t part_bytes, void* pinned, void* dev,
                             int timed, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1) return (int)cudaErrorInvalidValue;
  StageJob* job = static_cast<StageJob*>(
      malloc(sizeof(StageJob) + (size_t)n * sizeof(const void*)));
  if (job == nullptr) return (int)cudaErrorMemoryAllocation;
  job->dst = static_cast<char*>(pinned);
  job->part_bytes = part_bytes;
  job->n = n;
  job->t_enqueue = timed ? now_ns() : 0;
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

// The timed jobs' totals since the last reset: out[0] jobs, out[1] the
// sum of their start delays, out[2] the largest delay, out[3] the sum of
// their memcpy times (ns). With ``reset`` non-zero they are zeroed after
// the read.
extern "C" void slc_stage_stats(long long* out, int reset) {
  if (reset) {
    out[0] = g_jobs.exchange(0);
    out[1] = g_delay_ns.exchange(0);
    out[2] = g_delay_max_ns.exchange(0);
    out[3] = g_copy_ns.exchange(0);
  } else {
    out[0] = g_jobs.load();
    out[1] = g_delay_ns.load();
    out[2] = g_delay_max_ns.load();
    out[3] = g_copy_ns.load();
  }
}

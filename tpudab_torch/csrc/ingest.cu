// A step's raw u8 IQ from host memory into a device buffer: n copies, one
// a host region (an rtl_sdr dongle's), enqueued on one stream in a single
// call (models/ingest.py::HostFeed).
//
// Replaces no TPU kernel and launches none: on the TPU the IQ was put on
// the device by jax.device_put before the step. It exists for the host's
// time: torch's Tensor.copy_ from pinned memory costs tens of microseconds
// of host time a call (dispatch, the pinned check, the host allocator's
// event); for the 32 regions of a 32-ensemble step about 1 ms (a profiler
// trace on an H100's host), on the host's path between one step's
// read-back and the next step's first kernel. One call here enqueues the
// 32 cudaMemcpyAsync, a few microseconds each. The
// copies themselves are DMA at the PCIe link's rate (201 MB in 3.8-5.0 ms
// on the H100's Gen5 x16 link), on the feed's own stream beside the step's
// kernels. Sources in pinned memory make the copies asynchronous; a
// pageable source is copied as the CUDA runtime copies one, synchronously.
// A source may start at any byte of its region: a free-running dongle's
// segment is read from its ring at its read pointer (HostFeed.feed's
// offsets).

#include <cuda_runtime.h>

extern "C" int tpudab_copy_h2d(void* const* dst, const void* const* src,
                               const long long* n_bytes, int n, void* stream) {
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = cudaMemcpyAsync(dst[i], src[i], (size_t)n_bytes[i],
                                            cudaMemcpyHostToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

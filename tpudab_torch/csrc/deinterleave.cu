// MSC time deinterleave: out[e, i, col] = buf[e, i + d(col mod 16), col],
// d the bit-reversed 0..15 delay table (EN 300 401 sec 12).
//
// Replaces tpudab/msc/interleave.py::deinterleave_pallas (K4, :97-148).
// Plain torch twin: tpudab_torch/msc/interleave.py::deinterleave_ref.
//
// What bounds it on Hopper: it moves bytes and computes nothing, so it is
// bound by device memory bandwidth: one read of the (E, c+15, S) buffer
// and one write of the (E, c, S) output. The TPU kernel staged the whole
// buffer in VMEM and summed 16 masked row-shifted slices; here each thread
// gathers its one element directly. Writes are coalesced along S; the reads
// of a warp touch 16 neighbouring rows of the same column window, which
// the neighbouring output rows read again, so they are served from L1/L2
// and device memory sees each buffer byte about once. Exact: pure copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 16;

template <typename T>
__global__ void deinterleave_kernel(const T* __restrict__ buf, T* __restrict__ out,
                                    int n_rows, int c, int s) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= s) return;
  const int d = __brev(col & (kDepth - 1)) >> 28;  // 4-bit bit reversal
  for (int r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const int e = r / c;
    const int i = r - e * c;
    out[(size_t)r * s + col] = buf[((size_t)e * (c + kDepth - 1) + i + d) * s + col];
  }
}

}  // namespace

// buf: (e, c+15, s), out: (e, c, s), elements of elem_bytes (2 or 4) bytes.
extern "C" int tpudab_deinterleave(const void* buf, void* out, int e, int c,
                                   int s, int elem_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = e * c;
  const dim3 block(256);
  const dim3 grid((s + 255) / 256, n_rows < 65535 ? n_rows : 65535);
  if (elem_bytes == 2)
    deinterleave_kernel<uint16_t><<<grid, block, 0, st>>>(
        static_cast<const uint16_t*>(buf), static_cast<uint16_t*>(out), n_rows, c, s);
  else
    deinterleave_kernel<uint32_t><<<grid, block, 0, st>>>(
        static_cast<const uint32_t*>(buf), static_cast<uint32_t*>(out), n_rows, c, s);
  return (int)cudaGetLastError();
}

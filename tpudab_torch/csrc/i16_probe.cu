// int16 elementwise probe: one of 13 int16 ops on two (rows, cols) int16
// arrays, selected by an op id.
//
// Replaces tools/exp_i16_probe.py::probe (:7, pallas_call at :13), which
// asked whether Mosaic lowers each int16 op that the int16 Viterbi
// (tools/exp_viterbi_i16.py) needs. Plain torch twin:
// tpudab_torch/ops/i16_probe.py::i16_probe_ref, which this kernel matches
// exactly. The ops follow JAX's semantics: int16 arithmetic wraps, and
// shift_right_logical shifts the 16-bit pattern in zeros.
//
// What bounds it on Hopper: nothing of the card's: the arrays are 32 KB,
// so a launch is latency (a few microseconds). One thread per element;
// the question it answers on this card is whether each op compiles and
// gives JAX's answer, which nvcc settles for every op at build time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op {
  kAdd = 0, kMax, kMul, kShiftRightLogical, kShiftRightArith, kAndOr, kCompareGt,
  kSelectBySignShift, kSub, kRepeat, kI16ToU8, kBcast1Row, kBcast1ColX1Row, kNumOps
};

__device__ __forceinline__ int16_t srl15(int16_t v) {
  return (int16_t)((uint16_t)v >> 15);
}

__global__ void i16_probe_kernel(const int16_t* __restrict__ x, const int16_t* __restrict__ y,
                                 int16_t* __restrict__ out, int rows, int cols, int op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int r = i / cols, c = i - r * cols;
  const int16_t a = x[i], b = y[i];
  int16_t o;
  switch (op) {
    case kAdd: o = (int16_t)(a + b); break;
    case kMax: o = a > b ? a : b; break;
    case kMul: o = (int16_t)(a * b); break;
    case kShiftRightLogical: o = srl15(a); break;
    case kShiftRightArith: o = (int16_t)(a >> 15); break;
    case kAndOr: o = (int16_t)((a & b) | a); break;
    case kCompareGt: o = (int16_t)(a > b); break;
    case kSelectBySignShift: o = srl15((int16_t)(a - b)) > 0 ? a : b; break;
    case kSub: o = (int16_t)(a - b); break;
    case kRepeat: o = x[(r >> 2) * cols + c]; break;            // repeat(x[0:rows/4], 4, axis=0)
    case kI16ToU8: o = (int16_t)(uint8_t)(a & 3); break;
    case kBcast1Row: o = (int16_t)(x[c] + b); break;             // x[0:1, :] + y
    case kBcast1ColX1Row: o = (int16_t)(x[r * cols] * y[c]); break;  // x[:, 0:1] * y[0:1, :]
    default: o = 0;
  }
  out[i] = o;
}

}  // namespace

// x, y, out: (rows, cols) int16, contiguous; op in [0, 13).
extern "C" int tpudab_i16_probe(const void* x, const void* y, void* out, int rows, int cols,
                                int op, void* stream) {
  if (op < 0 || op >= kNumOps) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = rows * cols;
  i16_probe_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const int16_t*>(x), static_cast<const int16_t*>(y),
      static_cast<int16_t*>(out), rows, cols, op);
  return (int)cudaGetLastError();
}

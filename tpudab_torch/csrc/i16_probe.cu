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
// What bounds it on Hopper: nothing of the card's: the tool's arrays are
// 32 KB, a few microseconds of launch latency, so a lone call's time is the
// host's (the wrapper launches through ops/_build.py::launch, the port's
// lean ctypes path). The kernel itself does as little as it can: each
// thread takes 8 consecutive int16 with one 16-byte load of each operand
// and one 16-byte store (2,048 threads for (64, 256)); the op is a template
// parameter, so each instantiation's loop body is the op alone. The ops
// that read other rows or columns (repeat, bcast_1row, bcast_1col_x_1row)
// index x and y exactly per element. A tail of rows * cols % 8 elements,
// or an operand not 16-byte aligned, takes element-wise loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op {
  kAdd = 0, kMax, kMul, kShiftRightLogical, kShiftRightArith, kAndOr, kCompareGt,
  kSelectBySignShift, kSub, kRepeat, kI16ToU8, kBcast1Row, kBcast1ColX1Row, kNumOps
};

constexpr int kVec = 8;       // int16 per thread: one 16-byte access
constexpr int kThreads = 128;

__device__ __forceinline__ int16_t srl15(int16_t v) {
  return (int16_t)((uint16_t)v >> 15);
}

// Element (r, c) of the op, a = x[r, c], b = y[r, c].
template <int kOp>
__device__ __forceinline__ int16_t apply(const int16_t* __restrict__ x,
                                         const int16_t* __restrict__ y, int16_t a, int16_t b,
                                         int r, int c, int cols) {
  switch (kOp) {
    case kAdd: return (int16_t)(a + b);
    case kMax: return a > b ? a : b;
    case kMul: return (int16_t)(a * b);
    case kShiftRightLogical: return srl15(a);
    case kShiftRightArith: return (int16_t)(a >> 15);
    case kAndOr: return (int16_t)((a & b) | a);
    case kCompareGt: return (int16_t)(a > b);
    case kSelectBySignShift: return srl15((int16_t)(a - b)) > 0 ? a : b;
    case kSub: return (int16_t)(a - b);
    case kRepeat: return x[(r >> 2) * cols + c];            // repeat(x[0:rows/4], 4, axis=0)
    case kI16ToU8: return (int16_t)(uint8_t)(a & 3);
    case kBcast1Row: return (int16_t)(x[c] + b);             // x[0:1, :] + y
    case kBcast1ColX1Row: return (int16_t)(x[r * cols] * y[c]);  // x[:, 0:1] * y[0:1, :]
    default: return 0;
  }
}

// Whether the op reads a and b at the element's own index (all but repeat).
template <int kOp>
__host__ __device__ constexpr bool reads_own() { return kOp != kRepeat; }

template <int kOp>
__global__ void __launch_bounds__(kThreads)
i16_probe_kernel(const int16_t* __restrict__ x, const int16_t* __restrict__ y,
                 int16_t* __restrict__ out, int rows, int cols, bool aligned) {
  const int n = rows * cols;
  const int i0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  int r = i0 / cols, c = i0 - r * cols;
  __align__(16) int16_t a[kVec];
  __align__(16) int16_t b[kVec];
  __align__(16) int16_t o[kVec];
  const bool whole = aligned && i0 + kVec <= n;
  if (whole) {
    if (reads_own<kOp>()) {
      *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(x + i0);
      *reinterpret_cast<uint4*>(b) = *reinterpret_cast<const uint4*>(y + i0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      a[k] = reads_own<kOp>() && i0 + k < n ? x[i0 + k] : (int16_t)0;
      b[k] = reads_own<kOp>() && i0 + k < n ? y[i0 + k] : (int16_t)0;
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    o[k] = (whole || i0 + k < n) ? apply<kOp>(x, y, a[k], b[k], r, c, cols) : (int16_t)0;
    if (++c == cols) {
      c = 0;
      ++r;
    }
  }
  if (whole) {
    *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(o);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (i0 + k < n) out[i0 + k] = o[k];
  }
}

template <int kOp>
void launch(const int16_t* x, const int16_t* y, int16_t* out, int rows, int cols, bool aligned,
            cudaStream_t st) {
  const int threads = (rows * cols + kVec - 1) / kVec;
  i16_probe_kernel<kOp><<<(threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      x, y, out, rows, cols, aligned);
}

}  // namespace

// x, y, out: (rows, cols) int16, contiguous; op in [0, 13).
extern "C" int tpudab_i16_probe(const void* x, const void* y, void* out, int rows, int cols,
                                int op, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* xp = static_cast<const int16_t*>(x);
  const int16_t* yp = static_cast<const int16_t*>(y);
  int16_t* o = static_cast<int16_t*>(out);
  if (rows * cols == 0) return (int)cudaSuccess;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  switch (op) {
#define TPUDAB_I16_CASE(OP) \
    case OP: launch<OP>(xp, yp, o, rows, cols, aligned, st); break;
    TPUDAB_I16_CASE(kAdd)
    TPUDAB_I16_CASE(kMax)
    TPUDAB_I16_CASE(kMul)
    TPUDAB_I16_CASE(kShiftRightLogical)
    TPUDAB_I16_CASE(kShiftRightArith)
    TPUDAB_I16_CASE(kAndOr)
    TPUDAB_I16_CASE(kCompareGt)
    TPUDAB_I16_CASE(kSelectBySignShift)
    TPUDAB_I16_CASE(kSub)
    TPUDAB_I16_CASE(kRepeat)
    TPUDAB_I16_CASE(kI16ToU8)
    TPUDAB_I16_CASE(kBcast1Row)
    TPUDAB_I16_CASE(kBcast1ColX1Row)
#undef TPUDAB_I16_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

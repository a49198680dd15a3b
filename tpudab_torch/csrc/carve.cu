// Carve + rotate: IQ frames -> PLL-rotated bf16 FFT windows, re/im split.
//
// Replaces tpudab/ops/carve.py::carve_rotate (K5, kernel from _make_kernel,
// :33-166). Plain torch twin: tpudab_torch/ops/carve.py::carve_rotate_ref.
//
// For frame f, symbol s and window sample k the kernel reads
// x[f, a_s + k] with a_s = null + s * (n_fft + n_cp) + n_cp - window_offset,
// and rotates it by exp(-2 pi j freq_f t_abs / fs). The rotator is the
// angle addition of the per-frame in-window ramp (ci, si: cos/sin of
// scale_f * k) and the per-(frame, symbol) window-start rotator (ca, sa:
// cos/sin of scale_f * a_s), both precomputed in f32 by the wrapper as in
// carve.py:123-136, so the kernel runs no transcendentals. The f32 products
// and sums are rounded one by one (no FMA contraction), as the TPU kernel
// computes them, then converted with __float2bfloat16 (round to nearest).
//
// What bounds it on Hopper: memory bandwidth — per output sample it reads
// one IQ pair (bf16 or f32) and writes two bf16 values; the tables are
// small and stay in L1/L2. On the TPU the misaligned window start (the
// symbol stride is not a multiple of 128 lanes) needed lane rotates; here
// one thread per output sample reads x[a_s + k], so neighbouring threads
// read neighbouring addresses whatever the alignment of a_s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void carve_kernel(const T* __restrict__ re, const T* __restrict__ im,
                             const float* __restrict__ ca, const float* __restrict__ sa,
                             const float* __restrict__ ci, const float* __restrict__ si,
                             __nv_bfloat16* __restrict__ xr, __nv_bfloat16* __restrict__ xi,
                             int n_win, int frame_len, int n_sym, int n_fft,
                             int sym_stride, int first) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_fft) return;
  for (int w = blockIdx.y; w < n_win; w += gridDim.y) {  // w = f * n_sym + s
    const int f = w / n_sym;
    const int s = w - f * n_sym;
    const size_t src = (size_t)f * frame_len + first + (size_t)s * sym_stride + k;
    const float wr = to_f32(re[src]);
    const float wi = to_f32(im[src]);
    const float c_a = ca[w], s_a = sa[w];
    const float c_i = ci[(size_t)f * n_fft + k], s_i = si[(size_t)f * n_fft + k];
    const float c = __fsub_rn(__fmul_rn(c_a, c_i), __fmul_rn(s_a, s_i));
    const float sn = __fadd_rn(__fmul_rn(s_a, c_i), __fmul_rn(c_a, s_i));
    const size_t dst = (size_t)w * n_fft + k;
    xr[dst] = __float2bfloat16(__fsub_rn(__fmul_rn(wr, c), __fmul_rn(wi, sn)));
    xi[dst] = __float2bfloat16(__fadd_rn(__fmul_rn(wr, sn), __fmul_rn(wi, c)));
  }
}

}  // namespace

// re, im: (f, frame_len) bf16 (in_bf16=1) or f32; ca, sa: (f, n_sym) f32;
// ci, si: (f, n_fft) f32; xr, xi: (f, n_sym, n_fft) bf16.
extern "C" int tpudab_carve_rotate(const void* re, const void* im, int in_bf16,
                                   const void* ca, const void* sa,
                                   const void* ci, const void* si,
                                   void* xr, void* xi, int f, int frame_len,
                                   int n_sym, int n_fft, int sym_stride,
                                   int first, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_win = f * n_sym;
  const dim3 block(256);
  const dim3 grid((n_fft + 255) / 256, n_win < 65535 ? n_win : 65535);
  const float* fca = static_cast<const float*>(ca);
  const float* fsa = static_cast<const float*>(sa);
  const float* fci = static_cast<const float*>(ci);
  const float* fsi = static_cast<const float*>(si);
  __nv_bfloat16* oxr = static_cast<__nv_bfloat16*>(xr);
  __nv_bfloat16* oxi = static_cast<__nv_bfloat16*>(xi);
  if (in_bf16)
    carve_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(re), static_cast<const __nv_bfloat16*>(im),
        fca, fsa, fci, fsi, oxr, oxi, n_win, frame_len, n_sym, n_fft, sym_stride, first);
  else
    carve_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        fca, fsa, fci, fsi, oxr, oxi, n_win, frame_len, n_sym, n_fft, sym_stride, first);
  return (int)cudaGetLastError();
}

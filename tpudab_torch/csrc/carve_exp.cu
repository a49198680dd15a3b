// Carve + rotate ablations: K5 (csrc/carve.cu) with frames per block fb and
// the window roll and the PLL rotation each switchable.
//
// Replaces tools/exp_carve.py::make_variant (:33, pallas_call at :94), the
// round-3 ablation of tpudab/ops/carve.py::carve_rotate (K5). Plain torch
// twin: tpudab_torch/ops/carve_exp.py::carve_variant_ref.
//
//   roll    on: the window starts at a_s = first + s * sym_stride (K5);
//           off: it starts at the 128-aligned row start 128 * (a_s / 128),
//           tpudab's r0, which is wrong numerics by design;
//   rotate  on: the PLL rotation by angle addition of the f32 tables, each
//           product and sum rounded alone as in K5; off: a cast copy.
// copy-only is both off.
//
// What bounds it on Hopper: memory bandwidth, as K5: per output sample one
// IQ pair read and two bf16 values written. On the TPU fb set how many
// frames one program staged in VMEM; here a block of 256 threads walks fb
// frames x n_sym windows for its 256 window samples, so fb sets the work
// per block (and the blocks in flight: n_fft / 256 x f / fb).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, bool kRoll, bool kRotate>
__global__ void carve_variant_kernel(const T* __restrict__ re, const T* __restrict__ im,
                                     const float* __restrict__ ca, const float* __restrict__ sa,
                                     const float* __restrict__ ci, const float* __restrict__ si,
                                     __nv_bfloat16* __restrict__ xr,
                                     __nv_bfloat16* __restrict__ xi, int f, int fb,
                                     int frame_len, int n_sym, int n_fft, int sym_stride,
                                     int first) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_fft) return;
  const int f0 = (int)blockIdx.y * fb;
  const int f_end = min(f, f0 + fb);
  for (int fr = f0; fr < f_end; ++fr) {
    float c_i = 0.f, s_i = 0.f;
    if (kRotate) {
      c_i = ci[(size_t)fr * n_fft + k];
      s_i = si[(size_t)fr * n_fft + k];
    }
    for (int s = 0; s < n_sym; ++s) {
      const int a = first + s * sym_stride;
      const int start = kRoll ? a : (a / 128) * 128;
      const size_t src = (size_t)fr * frame_len + start + k;
      const float wr = to_f32(re[src]);
      const float wi = to_f32(im[src]);
      const size_t w = (size_t)fr * n_sym + s;
      const size_t dst = w * n_fft + k;
      if (kRotate) {
        const float c_a = ca[w], s_a = sa[w];
        const float c = __fsub_rn(__fmul_rn(c_a, c_i), __fmul_rn(s_a, s_i));
        const float sn = __fadd_rn(__fmul_rn(s_a, c_i), __fmul_rn(c_a, s_i));
        xr[dst] = __float2bfloat16(__fsub_rn(__fmul_rn(wr, c), __fmul_rn(wi, sn)));
        xi[dst] = __float2bfloat16(__fadd_rn(__fmul_rn(wr, sn), __fmul_rn(wi, c)));
      } else {
        xr[dst] = __float2bfloat16(wr);
        xi[dst] = __float2bfloat16(wi);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* re, const void* im, const float* ca, const float* sa,
                   const float* ci, const float* si, __nv_bfloat16* xr, __nv_bfloat16* xi,
                   int f, int fb, int frame_len, int n_sym, int n_fft, int sym_stride,
                   int first, int roll, int rotate, cudaStream_t st) {
  const dim3 block(256);
  const dim3 grid((n_fft + 255) / 256, (f + fb - 1) / fb);
  const T* r = static_cast<const T*>(re);
  const T* i = static_cast<const T*>(im);
#define TPUDAB_CARVE(R, O)                                                            \
  carve_variant_kernel<T, R, O><<<grid, block, 0, st>>>(r, i, ca, sa, ci, si, xr, xi, f, \
                                                        fb, frame_len, n_sym, n_fft,   \
                                                        sym_stride, first)
  if (roll && rotate) TPUDAB_CARVE(true, true);
  else if (roll) TPUDAB_CARVE(true, false);
  else if (rotate) TPUDAB_CARVE(false, true);
  else TPUDAB_CARVE(false, false);
#undef TPUDAB_CARVE
  return cudaGetLastError();
}

}  // namespace

// re, im: (f, frame_len) bf16 (in_bf16=1) or f32; ca, sa: (f, n_sym) f32;
// ci, si: (f, n_fft) f32 (read only when rotate); xr, xi: (f, n_sym, n_fft)
// bf16. fb >= 1 frames per block.
extern "C" int tpudab_carve_variant(const void* re, const void* im, int in_bf16,
                                    const void* ca, const void* sa, const void* ci,
                                    const void* si, void* xr, void* xi, int f, int fb,
                                    int frame_len, int n_sym, int n_fft, int sym_stride,
                                    int first, int roll, int rotate, void* stream) {
  if (fb < 1 || (f + fb - 1) / fb > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fca = static_cast<const float*>(ca);
  const float* fsa = static_cast<const float*>(sa);
  const float* fci = static_cast<const float*>(ci);
  const float* fsi = static_cast<const float*>(si);
  __nv_bfloat16* oxr = static_cast<__nv_bfloat16*>(xr);
  __nv_bfloat16* oxi = static_cast<__nv_bfloat16*>(xi);
  cudaError_t err;
  if (in_bf16)
    err = launch<__nv_bfloat16>(re, im, fca, fsa, fci, fsi, oxr, oxi, f, fb, frame_len, n_sym,
                                n_fft, sym_stride, first, roll, rotate, st);
  else
    err = launch<float>(re, im, fca, fsa, fci, fsi, oxr, oxi, f, fb, frame_len, n_sym, n_fft,
                        sym_stride, first, roll, rotate, st);
  return (int)err;
}

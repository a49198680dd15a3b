// Carve + rotate: IQ frames -> PLL-rotated bf16 FFT windows, re/im split,
// and optionally their bf16 sum, the A operand of the demod's first
// Karatsuba product.
//
// Replaces tpudab/ops/carve.py::carve_rotate (K5, kernel from _make_kernel,
// :33-166) and the `(ar + ai).astype(dt)` beside it (tpudab/ofdm/demod.py:214).
// Plain torch twins: tpudab_torch/ops/carve.py::carve_rotate_tables_ref
// (the same f32 arithmetic, held equal bit for bit) and ::carve_rotate_ref
// (phase from the absolute sample time, within 1 bf16 ulp).
//
// For frame f, symbol s and window sample k the kernel reads
// x[f, a_s + k] with a_s = null + s * (n_fft + n_cp) + n_cp - window_offset,
// and rotates it by exp(-2 pi j freq_f t_abs / fs). The rotator is the
// angle addition of the per-frame in-window ramp (ci, si: cos/sin of
// scale_f * k) and the per-(frame, symbol) window-start rotator (ca, sa:
// cos/sin of scale_f * a_s), both precomputed in f32 by the wrapper as in
// carve.py:123-136, so the kernel runs no transcendentals. The f32 products
// and sums are rounded one by one (no FMA contraction), as the TPU kernel
// computes them, then converted with __float2bfloat16 (round to nearest);
// xs = bf16(float(xr) + float(xi)) is what torch's bf16 add gives.
//
// What bounds it on Hopper: bytes. At the bench step's (512, 1536, 128)
// bf16 frames it must read the 76 windows' re and im samples (319 MB) and
// write xr, xi and xs (478 MB): 0.238 ms at 3.35 TB/s. The first version
// ran one thread per sample with 2-byte accesses and re-read the (F, n_fft)
// f32 ramp tables for every window: 8 bytes of table traffic through L1/L2
// per 4 bytes of input. Here a block owns one frame and a share of its
// symbols; each thread owns 8 consecutive samples k, loads its 8 (ci, si)
// once and walks the symbols with them, storing 16-byte vectors of 8 bf16.
// A window starts at any element (mode I at 4 mod 8, mode II at 2 mod 8 and
// moving), so a thread loads the aligned 16-byte vectors that cover its 8
// samples and shifts them into place in registers; the shift is the same
// for the whole block, so it costs no divergence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPer = 8;       // window samples per thread
constexpr int kChunks = 4;    // blocks per frame, each a share of the symbols

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// 8 consecutive samples starting at row[a], for any a.
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int a, float (&w)[kPer]) {
  const int r = a & 7;
  const uint4* p = reinterpret_cast<const uint4*>(row + (a - r));
  const uint4 lo = p[0];
  const uint4 hi = r ? p[1] : make_uint4(0, 0, 0, 0);
  uint32_t x[5];   // words r/2 .. r/2 + 4 of the 8 loaded
  switch (r >> 1) {
    case 0: x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w; x[4] = hi.x; break;
    case 1: x[0] = lo.y; x[1] = lo.z; x[2] = lo.w; x[3] = hi.x; x[4] = hi.y; break;
    case 2: x[0] = lo.z; x[1] = lo.w; x[2] = hi.x; x[3] = hi.y; x[4] = hi.z; break;
    default: x[0] = lo.w; x[1] = hi.x; x[2] = hi.y; x[3] = hi.z; x[4] = hi.w; break;
  }
  const int sh = (r & 1) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = __funnelshift_r(x[i], x[i + 1], sh);
    w[2 * i] = bf16_lo(v);
    w[2 * i + 1] = bf16_hi(v);
  }
}

template <int R>
__device__ __forceinline__ void pick(const float (&x)[12], float (&w)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) w[i] = x[R + i];
}

__device__ __forceinline__ void load8(const float* row, int a, float (&w)[kPer]) {
  const int r = a & 3;
  const float4* p = reinterpret_cast<const float4*>(row + (a - r));
  const float4 v0 = p[0], v1 = p[1];
  const float4 v2 = r ? p[2] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float x[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                       v2.x, v2.y, v2.z, v2.w};
  switch (r) {
    case 0: pick<0>(x, w); break;
    case 1: pick<1>(x, w); break;
    case 2: pick<2>(x, w); break;
    default: pick<3>(x, w); break;
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[kPer]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
}

// block (f, chunk): n_fft / 8 threads, thread t owns samples 8t .. 8t + 7
template <typename T>
__global__ void carve_kernel(const T* __restrict__ re, const T* __restrict__ im,
                             const float* __restrict__ ca, const float* __restrict__ sa,
                             const float* __restrict__ ci, const float* __restrict__ si,
                             __nv_bfloat16* __restrict__ xr, __nv_bfloat16* __restrict__ xi,
                             __nv_bfloat16* __restrict__ xs, int frame_len, int n_sym,
                             int n_fft, int sym_stride, int first) {
  const int f = blockIdx.x;
  const int k0 = threadIdx.x * kPer;
  const int per = (n_sym + gridDim.y - 1) / gridDim.y;
  const int s0 = blockIdx.y * per;
  const int s1 = min(n_sym, s0 + per);
  float c_i[kPer], s_i[kPer];
  {
    const float4* pc = reinterpret_cast<const float4*>(ci + (size_t)f * n_fft + k0);
    const float4* ps = reinterpret_cast<const float4*>(si + (size_t)f * n_fft + k0);
    const float4 c0 = pc[0], c1 = pc[1], q0 = ps[0], q1 = ps[1];
    const float cc[kPer] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float ss[kPer] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int i = 0; i < kPer; ++i) { c_i[i] = cc[i]; s_i[i] = ss[i]; }
  }
  const T* fr = re + (size_t)f * frame_len;
  const T* fi = im + (size_t)f * frame_len;
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    const int a = first + s * sym_stride + k0;
    float wr[kPer], wi[kPer];
    load8(fr, a, wr);
    load8(fi, a, wi);
    const int w = f * n_sym + s;
    const float c_a = ca[w], s_a = sa[w];
    float vr[kPer], vi[kPer], vs[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float c = __fsub_rn(__fmul_rn(c_a, c_i[i]), __fmul_rn(s_a, s_i[i]));
      const float sn = __fadd_rn(__fmul_rn(s_a, c_i[i]), __fmul_rn(c_a, s_i[i]));
      vr[i] = __fsub_rn(__fmul_rn(wr[i], c), __fmul_rn(wi[i], sn));
      vi[i] = __fadd_rn(__fmul_rn(wr[i], sn), __fmul_rn(wi[i], c));
      vs[i] = __fadd_rn(__bfloat162float(__float2bfloat16(vr[i])),
                        __bfloat162float(__float2bfloat16(vi[i])));
    }
    const size_t dst = (size_t)w * n_fft + k0;
    store8(xr + dst, vr);
    store8(xi + dst, vi);
    if (xs) store8(xs + dst, vs);
  }
}

}  // namespace

// re, im: (f, frame_len) bf16 (in_bf16=1) or f32, 16-byte aligned; ca, sa:
// (f, n_sym) f32; ci, si: (f, n_fft) f32; xr, xi and xs (null: not
// written): (f, n_sym, n_fft) bf16. n_fft a multiple of 256.
extern "C" int tpudab_carve_rotate(const void* re, const void* im, int in_bf16,
                                   const void* ca, const void* sa,
                                   const void* ci, const void* si,
                                   void* xr, void* xi, void* xs, int f, int frame_len,
                                   int n_sym, int n_fft, int sym_stride,
                                   int first, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(f, kChunks < n_sym ? kChunks : n_sym);
  const dim3 block(n_fft / kPer);
  const float* fca = static_cast<const float*>(ca);
  const float* fsa = static_cast<const float*>(sa);
  const float* fci = static_cast<const float*>(ci);
  const float* fsi = static_cast<const float*>(si);
  __nv_bfloat16* oxr = static_cast<__nv_bfloat16*>(xr);
  __nv_bfloat16* oxi = static_cast<__nv_bfloat16*>(xi);
  __nv_bfloat16* oxs = static_cast<__nv_bfloat16*>(xs);
  if (in_bf16)
    carve_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(re), static_cast<const __nv_bfloat16*>(im),
        fca, fsa, fci, fsi, oxr, oxi, oxs, frame_len, n_sym, n_fft, sym_stride, first);
  else
    carve_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        fca, fsa, fci, fsi, oxr, oxi, oxs, frame_len, n_sym, n_fft, sym_stride, first);
  return (int)cudaGetLastError();
}

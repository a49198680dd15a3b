// Carve + rotate: IQ frames -> PLL-rotated bf16 FFT windows, re/im split,
// and optionally their bf16 sum, the A operand of the demod's first
// Karatsuba product.
//
// Replaces tpudab/ops/carve.py::carve_rotate (K5, kernel from _make_kernel,
// :33-166) and the `(ar + ai).astype(dt)` beside it (tpudab/ofdm/demod.py:214),
// and tools/exp_carve.py::make_variant (X7, :33, pallas_call at :94), the
// ablations of K5, as instantiations of the same kernel. Plain torch twins:
// tpudab_torch/ops/carve.py::carve_rotate_tables_ref (the same f32
// arithmetic, held equal bit for bit), ::carve_rotate_ref (phase from the
// absolute sample time, within 1 bf16 ulp) and
// tpudab_torch/ops/carve_exp.py::carve_variant_ref (the ablations, bit for
// bit).
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
//
// The ablations switch two template flags and tile by frames per block:
//   kRoll    off: each window starts at the 128-aligned row start
//            128 * (a_s / 128) below a_s (tpudab's r0), wrong numerics by
//            design; those starts are 16-byte aligned, so no shift;
//   kRotate  off: a cast copy, with no table read and no product;
//   fb       frames per block. On the TPU it was the number of frames one
//            program staged in VMEM; here a block's tile is fb frames x
//            `per` symbols, and the wrapper (ops/carve_exp.py::carve_tiling)
//            shrinks `per` as fb grows, so a block holds about as many
//            samples as K5's and the grid keeps several blocks an SM.
// K5's kernel (carve_kernel) runs the body at <T, true, true> for one
// frame a block on K5's own grid, with the same registers as before the
// ablations shared it; X7's (carve_tile_kernel) loops it over fb frames.
//
// rtl_sdr's raw IQ (T = uint8_t): a frame is frame_len interleaved
// offset-binary pairs (I, Q), one pointer for both parts. A sample is two
// bytes, as a bf16 element is, so a thread loads the same aligned 16-byte
// vectors as the bf16 body and shifts them the same way, then converts each
// byte in registers to (x - 127.5) / 128 in f32, which is exact (9
// significant bits; not exact in bf16). The rotation after it is the f32
// one, so the u8 kernel gives the f32 kernel's outputs on the converted
// frames bit for bit (ops/carve.py::u8_parts). It reads 2 bytes a window
// sample instead of bf16's 4.
//
// Frames at per-frame starts (a tracked stream, ofdm/track.py): K5 may be
// handed `starts`, frame f's first sample as an offset into the buffer (any
// sample, not only f * frame_len), so that it carves each frame where the
// tracker put it inside one dongle's segment of the stream. The block
// rounds its frame's start down to the 16-byte vector below it and adds the
// rest to every window's start, which the loads shift into place as they
// shift any window; without `starts` the start is f * frame_len, a
// multiple of 128, the rest 0, and the loads and the arithmetic are those
// of the aligned frames.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPer = 8;       // window samples per thread
constexpr int kChunks = 4;    // K5's blocks per frame, each a share of the symbols

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// 8 consecutive samples starting at row[a]: for any a (kShift), or for a
// multiple of 8 (16-byte aligned, one load).
template <bool kShift>
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int a, float (&w)[kPer]) {
  const int r = kShift ? a & 7 : 0;
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

template <bool kShift>
__device__ __forceinline__ void load8(const float* row, int a, float (&w)[kPer]) {
  const int r = kShift ? a & 3 : 0;
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

// rtl_sdr's byte x as (x - 127.5) / 128, exact in f32
__device__ __forceinline__ float u8_sample(uint32_t x) {
  return __fmul_rn(__fsub_rn(__uint2float_rn(x & 0xFFu), 127.5f), 0.0078125f);
}

// The re and im parts of 8 consecutive samples starting at sample a of
// interleaved u8 pairs: one 2-byte word a sample, shifted as bf16's load8
// shifts its elements, then each byte converted.
template <bool kShift>
__device__ __forceinline__ void load8_u8(const uint8_t* iq, int a, float (&wr)[kPer],
                                         float (&wi)[kPer]) {
  const int r = kShift ? a & 7 : 0;
  const uint4* p = reinterpret_cast<const uint4*>(iq + 2 * (a - r));
  const uint4 lo = p[0];
  const uint4 hi = r ? p[1] : make_uint4(0, 0, 0, 0);
  uint32_t x[5];
  switch (r >> 1) {
    case 0: x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w; x[4] = hi.x; break;
    case 1: x[0] = lo.y; x[1] = lo.z; x[2] = lo.w; x[3] = hi.x; x[4] = hi.y; break;
    case 2: x[0] = lo.z; x[1] = lo.w; x[2] = hi.x; x[3] = hi.y; x[4] = hi.z; break;
    default: x[0] = lo.w; x[1] = hi.x; x[2] = hi.y; x[3] = hi.z; x[4] = hi.w; break;
  }
  const int sh = (r & 1) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bytes I, Q of sample 2i, then of 2i + 1
    const uint32_t v = __funnelshift_r(x[i], x[i + 1], sh);
    wr[2 * i] = u8_sample(v);
    wi[2 * i] = u8_sample(v >> 8);
    wr[2 * i + 1] = u8_sample(v >> 16);
    wi[2 * i + 1] = u8_sample(v >> 24);
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

// The one body: frame f, symbols s0 .. s1 - 1, thread t owning samples
// 8t .. 8t + 7 of each window.
template <typename T, bool kRoll, bool kRotate>
__device__ __forceinline__ void carve_frame(
    const T* __restrict__ re, const T* __restrict__ im, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ ci, const float* __restrict__ si,
    __nv_bfloat16* __restrict__ xr, __nv_bfloat16* __restrict__ xi,
    __nv_bfloat16* __restrict__ xs, int f, size_t base, int s0, int s1, int n_sym, int n_fft,
    int sym_stride, int first) {
  const int k0 = threadIdx.x * kPer;
  float c_i[kPer], s_i[kPer];
  if (kRotate) {
    const float4* pc = reinterpret_cast<const float4*>(ci + (size_t)f * n_fft + k0);
    const float4* ps = reinterpret_cast<const float4*>(si + (size_t)f * n_fft + k0);
    const float4 c0 = pc[0], c1 = pc[1], q0 = ps[0], q1 = ps[1];
    const float cc[kPer] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float ss[kPer] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int i = 0; i < kPer; ++i) { c_i[i] = cc[i]; s_i[i] = ss[i]; }
  }
  // elements a sample: u8's I and Q interleaved, one of each split part;
  // samples a 16-byte vector
  constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  constexpr size_t kElems = kU8 ? 2 : 1;
  constexpr size_t kVec = 16 / (sizeof(T) * kElems);
  const int rest = kU8 ? (int)(base % kVec) : 0;     // the split parts' frames are aligned
  const T* fr = re + (base - rest) * kElems;
  const T* fi = im + (base - rest) * kElems;
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    const int a_s = first + s * sym_stride;
    const int a = (kRoll ? a_s : a_s / 128 * 128) + k0 + rest;
    float wr[kPer], wi[kPer];
    if constexpr (std::is_same<T, uint8_t>::value) {
      load8_u8<kRoll>(fr, a, wr, wi);
    } else {
      load8<kRoll>(fr, a, wr);
      load8<kRoll>(fi, a, wi);
    }
    const int w = f * n_sym + s;
    float vr[kPer], vi[kPer], vs[kPer];
    float c_a = 0.f, s_a = 0.f;
    if (kRotate) { c_a = ca[w]; s_a = sa[w]; }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (kRotate) {
        const float c = __fsub_rn(__fmul_rn(c_a, c_i[i]), __fmul_rn(s_a, s_i[i]));
        const float sn = __fadd_rn(__fmul_rn(s_a, c_i[i]), __fmul_rn(c_a, s_i[i]));
        vr[i] = __fsub_rn(__fmul_rn(wr[i], c), __fmul_rn(wi[i], sn));
        vi[i] = __fadd_rn(__fmul_rn(wr[i], sn), __fmul_rn(wi[i], c));
      } else {
        vr[i] = wr[i];
        vi[i] = wi[i];
      }
      vs[i] = __fadd_rn(__bfloat162float(__float2bfloat16(vr[i])),
                        __bfloat162float(__float2bfloat16(vi[i])));
    }
    const size_t dst = (size_t)w * n_fft + k0;
    store8(xr + dst, vr);
    store8(xi + dst, vi);
    if (xs) store8(xs + dst, vs);
  }
}

// K5: block (f, chunk), one frame and a share of its symbols; frame f
// starts at sample starts[f] of the buffer (u8 frames), or at f * frame_len
// where starts is null.
template <typename T>
__global__ void carve_kernel(const T* __restrict__ re, const T* __restrict__ im,
                             const float* __restrict__ ca, const float* __restrict__ sa,
                             const float* __restrict__ ci, const float* __restrict__ si,
                             __nv_bfloat16* __restrict__ xr, __nv_bfloat16* __restrict__ xi,
                             __nv_bfloat16* __restrict__ xs, const long long* __restrict__ starts,
                             int frame_len, int n_sym, int n_fft, int sym_stride, int first) {
  const int per = (n_sym + gridDim.y - 1) / gridDim.y;
  const int s0 = blockIdx.y * per;
  const int f = blockIdx.x;
  const size_t base = std::is_same<T, uint8_t>::value && starts ? (size_t)starts[f]
                                                                 : (size_t)f * frame_len;
  carve_frame<T, true, true>(re, im, ca, sa, ci, si, xr, xi, xs, f, base, s0,
                             min(n_sym, s0 + per), n_sym, n_fft, sym_stride, first);
}

// X7: block (x, y) carves frames fb * x .. fb * x + fb - 1 and symbols
// per * y .. per * y + per - 1, each range cut at its end (f, n_sym).
template <typename T, bool kRoll, bool kRotate>
__global__ void carve_tile_kernel(const T* __restrict__ re, const T* __restrict__ im,
                                  const float* __restrict__ ca, const float* __restrict__ sa,
                                  const float* __restrict__ ci, const float* __restrict__ si,
                                  __nv_bfloat16* __restrict__ xr,
                                  __nv_bfloat16* __restrict__ xi, int n_frames, int fb, int per,
                                  int frame_len, int n_sym, int n_fft, int sym_stride,
                                  int first) {
  const int f0 = blockIdx.x * fb;
  const int f1 = min(n_frames, f0 + fb);
  const int s0 = blockIdx.y * per;
  const int s1 = min(n_sym, s0 + per);
  for (int f = f0; f < f1; ++f)
    carve_frame<T, kRoll, kRotate>(re, im, ca, sa, ci, si, xr, xi, nullptr, f,
                                   (size_t)f * frame_len, s0, s1, n_sym, n_fft, sym_stride,
                                   first);
}

template <typename T, bool kRoll, bool kRotate>
void launch_tile(const void* re, const void* im, const float* ca, const float* sa,
                 const float* ci, const float* si, __nv_bfloat16* xr, __nv_bfloat16* xi,
                 dim3 grid, int f, int fb, int per, int frame_len, int n_sym, int n_fft,
                 int sym_stride, int first, cudaStream_t st) {
  carve_tile_kernel<T, kRoll, kRotate><<<grid, dim3(n_fft / kPer), 0, st>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), ca, sa, ci, si, xr, xi, f, fb, per,
      frame_len, n_sym, n_fft, sym_stride, first);
}

}  // namespace

// K5. re, im: (f, frame_len) f32 (in_dtype 0) or bf16 (1), or re the
// (f, frame_len, 2) interleaved u8 I/Q (2, im not read), 16-byte aligned; ca,
// sa: (f, n_sym) f32; ci, si: (f, n_fft) f32; xr, xi and xs (null: not
// written): (f, n_sym, n_fft) bf16. n_fft a multiple of 256. starts (null:
// frame f at f * frame_len): (f,) int64, frame f's first sample in re and im,
// every frame inside the buffers.
extern "C" int tpudab_carve_rotate(const void* re, const void* im, int in_dtype,
                                   const void* ca, const void* sa,
                                   const void* ci, const void* si,
                                   void* xr, void* xi, void* xs, const void* starts, int f,
                                   int frame_len, int n_sym, int n_fft, int sym_stride,
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
  const long long* st8 = static_cast<const long long*>(starts);
  if (in_dtype == 2)
    carve_kernel<uint8_t><<<grid, block, 0, st>>>(
        static_cast<const uint8_t*>(re), static_cast<const uint8_t*>(re),
        fca, fsa, fci, fsi, oxr, oxi, oxs, st8, frame_len, n_sym, n_fft, sym_stride, first);
  else if (in_dtype == 1)
    carve_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(re), static_cast<const __nv_bfloat16*>(im),
        fca, fsa, fci, fsi, oxr, oxi, oxs, st8, frame_len, n_sym, n_fft, sym_stride, first);
  else
    carve_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        fca, fsa, fci, fsi, oxr, oxi, oxs, st8, frame_len, n_sym, n_fft, sym_stride, first);
  return (int)cudaGetLastError();
}

// X7. As K5 without xs; ca, sa, ci, si are read only when rotate (null
// otherwise). The tiling is the caller's (ops/carve_exp.py::carve_tiling):
// a grid of (grid_x, grid_y) blocks of fb frames and per symbols, which must
// cover the f frames and n_sym symbols with no block left empty.
extern "C" int tpudab_carve_variant(const void* re, const void* im, int in_bf16,
                                    const void* ca, const void* sa, const void* ci,
                                    const void* si, void* xr, void* xi, int f, int fb, int per,
                                    int grid_x, int grid_y, int frame_len, int n_sym, int n_fft,
                                    int sym_stride, int first, int roll, int rotate,
                                    void* stream) {
  if (fb < 1 || per < 1 || grid_y > 65535 || (long long)(grid_x - 1) * fb >= f
      || (long long)grid_x * fb < f || (grid_y - 1) * per >= n_sym || grid_y * per < n_sym)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
#define TPUDAB_TILE(T, R, O)                                                                 \
  launch_tile<T, R, O>(re, im, static_cast<const float*>(ca), static_cast<const float*>(sa), \
                       static_cast<const float*>(ci), static_cast<const float*>(si),         \
                       static_cast<__nv_bfloat16*>(xr), static_cast<__nv_bfloat16*>(xi), grid, \
                       f, fb, per, frame_len, n_sym, n_fft, sym_stride, first, st)
#define TPUDAB_TILES(T)                        \
  if (roll && rotate) TPUDAB_TILE(T, true, true); \
  else if (roll) TPUDAB_TILE(T, true, false);     \
  else if (rotate) TPUDAB_TILE(T, false, true);   \
  else TPUDAB_TILE(T, false, false)
  if (in_bf16) { TPUDAB_TILES(__nv_bfloat16); }
  else { TPUDAB_TILES(float); }
#undef TPUDAB_TILES
#undef TPUDAB_TILE
  return (int)cudaGetLastError();
}

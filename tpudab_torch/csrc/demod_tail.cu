// The demod's tail after the three bf16 Karatsuba DFT products m1, m2, m3
// ((F, n_sym, K) each): the combine cr = m1 - m2, ci = m3 + m1, the DQPSK
// demap z_l * conj(z_{l-1}), the per-frame normalisation to unit mean
// magnitude, and the stats (mean_power of the IQ frames, the constellation
// tap of the last frame), in three launches.
//
// Replaces no Pallas kernel: on the TPU this tail is XLA's elementwise and
// reduce code after the products (tpudab/ofdm/demod.py:217-278), which XLA
// fuses. In the port it was eager ATen (ofdm/demod.py), which wrote every
// bf16 intermediate and an f32 copy of it to device memory and read it back
// once. Plain torch twins, held equal bit for bit:
// tpudab_torch/ops/demod_tail.py::demap_ref, norm_ref, stats_ref.
//
// Rounding: the eager chain is torch's bf16 arithmetic, each op computed in
// f32 from its bf16 operands and rounded to bf16 (round to nearest even).
// The kernels round at exactly those points: the combine's sum and
// difference, each demap product, the demap's sum and difference. The f32
// operations are the _rn intrinsics, so nvcc contracts none into an FMA.
// dr and di are then bit-equal to the eager chain's; the soft bits differ
// from it only where the f32 sum behind the frame's mean is taken in
// another order (within 1 bf16 ulp). Every reduction here runs in a fixed
// order with no atomics, so runs repeat bit for bit.
//
// What bounds it on Hopper: bytes. At the bench step's F = 512 (mode I,
// n_sym 76, K 1536) the products are 3 x 119.5 MB, the soft bits 235.9 MB
// and the frames 402.7 MB (bf16 re and im): demap_kernel reads the products
// once (0.107 ms at 3.35 TB/s), norm_kernel reads them again and writes the
// soft bits (0.177 ms), stats_kernel reads the frames once (0.120 ms).
// A thread owns 8 consecutive carriers (16-byte loads and stores) and walks
// its column strip down a chunk of the symbols, keeping symbol l - 1 in
// registers, so a chunk reads each element once and one row more than it
// demaps. Pass 2 recomputes the demap instead of reading back a stored dr,
// di: 358.6 MB read against 236 MB written and read again.
//
// demap_kernel  grid (chunks, F), block K/8: |dr| and |di| summed per frame
//               chunk, written as two f32 partials a block.
// norm_kernel   grid (chunks, F), block K/8: the frame's denominator from
//               its partials in chunk order, then dr / denom and di / denom
//               into row l of the (F, n_sym - 1, 2K) soft bits as
//               [dr | di], the concat's layout, in bf16 or f32.
// stats_kernel  grid F, block 256: sum of re^2 + im^2 over the frame, then
//               / frame_len; block 0 also forms the 480 tap points of the
//               last frame from the products and scales them to unit RMS.
//               Its u8 instantiation reads rtl_sdr's raw interleaved I/Q
//               (2 bytes a sample, one 16-byte load for 8 samples) and
//               converts each byte to (x - 127.5) / 128 in f32, exactly, so
//               it gives the f32 instantiation's sums on the converted
//               frames bit for bit (201.3 MB at F = 512: 0.060 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPer = 8;            // carriers (or samples) per thread
constexpr int kMaxThreads = 1024;  // K / 8 <= 1024
constexpr int kStatsThreads = 256;
constexpr int kTap = 480;          // N_CONST_POINTS
constexpr int kTapPad = 512;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// f32 -> bf16 (round to nearest even) -> f32: the rounding of one torch bf16 op
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[kPer]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = bf16_lo(v.x); w[1] = bf16_hi(v.x); w[2] = bf16_lo(v.y); w[3] = bf16_hi(v.y);
  w[4] = bf16_lo(v.z); w[5] = bf16_hi(v.z); w[6] = bf16_lo(v.w); w[7] = bf16_hi(v.w);
}

__device__ __forceinline__ void load8(const float* p, float (&w)[kPer]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w; w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// rtl_sdr's byte x as (x - 127.5) / 128, exact in f32
__device__ __forceinline__ float u8_sample(uint32_t x) {
  return __fmul_rn(__fsub_rn(__uint2float_rn(x & 0xFFu), 127.5f), 0.0078125f);
}

// 8 interleaved u8 pairs (I, Q) at p, 16-byte aligned -> their re and im
// parts: one 16-byte load; with kShift, the 8 pairs start `sh` pairs (1..7)
// past p, from two loads shifted into place (a 2-byte word a pair, as K5's
// load8_u8 shifts)
template <bool kShift>
__device__ __forceinline__ void load8_u8(const uint8_t* p, int sh, float (&re)[kPer],
                                         float (&im)[kPer]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (kShift) {
    const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
    uint32_t x[5];
    switch (sh >> 1) {
      case 0: x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w; x[4] = hi.x; break;
      case 1: x[0] = v.y; x[1] = v.z; x[2] = v.w; x[3] = hi.x; x[4] = hi.y; break;
      case 2: x[0] = v.z; x[1] = v.w; x[2] = hi.x; x[3] = hi.y; x[4] = hi.z; break;
      default: x[0] = v.w; x[1] = hi.x; x[2] = hi.y; x[3] = hi.z; x[4] = hi.w; break;
    }
    const int b = (sh & 1) * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], b);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bytes I, Q of sample 2i, then of 2i + 1
    re[2 * i] = u8_sample(w[i]);
    im[2 * i] = u8_sample(w[i] >> 8);
    re[2 * i + 1] = u8_sample(w[i] >> 16);
    im[2 * i + 1] = u8_sample(w[i] >> 24);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[kPer]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[kPer]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// cr = bf16(m1 - m2), ci = bf16(m3 + m1) for the 8 carriers at `off`
__device__ __forceinline__ void spectrum8(const __nv_bfloat16* __restrict__ m1,
                                          const __nv_bfloat16* __restrict__ m2,
                                          const __nv_bfloat16* __restrict__ m3, size_t off,
                                          float (&cr)[kPer], float (&ci)[kPer]) {
  float a[kPer], b[kPer], c[kPer];
  load8(m1 + off, a);
  load8(m2 + off, b);
  load8(m3 + off, c);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    cr[i] = rnd(__fsub_rn(a[i], b[i]));
    ci[i] = rnd(__fadd_rn(c[i], a[i]));
  }
}

// dr = bf16(bf16(cr1 cr0) + bf16(ci1 ci0)), di = bf16(bf16(ci1 cr0) - bf16(cr1 ci0))
__device__ __forceinline__ void demap1(float cr1, float ci1, float cr0, float ci0, float& dr,
                                       float& di) {
  dr = rnd(__fadd_rn(rnd(__fmul_rn(cr1, cr0)), rnd(__fmul_rn(ci1, ci0))));
  di = rnd(__fsub_rn(rnd(__fmul_rn(ci1, cr0)), rnd(__fmul_rn(cr1, ci0))));
}

// ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7))
__device__ __forceinline__ float lane_sum(const float (&a)[kPer]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                   __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
}

// Sum of one value a thread over the block: the values padded with zeros to
// the next power of two p, then s[t] += s[t + h] for h = p/2 .. 1. Thread 0
// gets the sum. s holds at least p floats.
__device__ __forceinline__ float block_sum(float v, float* s) {
  const int t = threadIdx.x, n = blockDim.x;
  int p = 1;
  while (p < n) p <<= 1;
  s[t] = v;
  if (t + n < p) s[t + n] = 0.f;
  __syncthreads();
  for (int h = p >> 1; h > 0; h >>= 1) {
    if (t < h) s[t] = __fadd_rn(s[t], s[t + h]);
    __syncthreads();
  }
  return s[0];
}

// Pass 1: frame f = blockIdx.y, demapped rows r0 .. r1 - 1 (row r is
// symbol r + 1 times the conjugate of symbol r), carriers 8t .. 8t + 7.
__global__ void demap_kernel(const __nv_bfloat16* __restrict__ m1,
                             const __nv_bfloat16* __restrict__ m2,
                             const __nv_bfloat16* __restrict__ m3, float* __restrict__ partials,
                             int n_sym, int k, int rows) {
  __shared__ float s[kMaxThreads];
  const int f = blockIdx.y, c = blockIdx.x;
  const int r0 = c * rows, r1 = min(r0 + rows, n_sym - 1);
  const size_t col = (size_t)f * n_sym * k + threadIdx.x * kPer;
  float acc_r[kPer], acc_i[kPer], cr0[kPer], ci0[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc_r[i] = acc_i[i] = 0.f;
  spectrum8(m1, m2, m3, col + (size_t)r0 * k, cr0, ci0);
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    float cr1[kPer], ci1[kPer];
    spectrum8(m1, m2, m3, col + (size_t)(r + 1) * k, cr1, ci1);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float dr, di;
      demap1(cr1[i], ci1[i], cr0[i], ci0[i], dr, di);
      acc_r[i] = __fadd_rn(acc_r[i], fabsf(dr));
      acc_i[i] = __fadd_rn(acc_i[i], fabsf(di));
      cr0[i] = cr1[i];
      ci0[i] = ci1[i];
    }
  }
  const float sr = block_sum(lane_sum(acc_r), s);
  __syncthreads();
  const float si = block_sum(lane_sum(acc_i), s);
  if (threadIdx.x == 0) {
    float* p = partials + ((size_t)f * gridDim.x + c) * 2;
    p[0] = sr;
    p[1] = si;
  }
}

// Pass 2: the same rows as pass 1's grid at `rows` a block (its own
// chunking; the partials come in `chunks` a frame), written normalised.
template <typename Out>
__global__ void norm_kernel(const __nv_bfloat16* __restrict__ m1,
                            const __nv_bfloat16* __restrict__ m2,
                            const __nv_bfloat16* __restrict__ m3,
                            const float* __restrict__ partials, Out* __restrict__ soft, int n_sym,
                            int k, int rows, int chunks) {
  const int f = blockIdx.y;
  const int r0 = blockIdx.x * rows, r1 = min(r0 + rows, n_sym - 1);
  // denom = max(0.5 (sum|dr| / n + sum|di| / n), 1e-20), NaN kept as torch's clamp_min
  const float* p = partials + (size_t)f * chunks * 2;
  float sr = p[0], si = p[1];
  for (int c = 1; c < chunks; ++c) {
    sr = __fadd_rn(sr, p[2 * c]);
    si = __fadd_rn(si, p[2 * c + 1]);
  }
  const float n = (float)((n_sym - 1) * k);
  const float mean = __fmul_rn(0.5f, __fadd_rn(__fdiv_rn(sr, n), __fdiv_rn(si, n)));
  const float denom = mean < 1e-20f ? 1e-20f : mean;

  const int k0 = threadIdx.x * kPer;
  const size_t col = (size_t)f * n_sym * k + k0;
  Out* out = soft + (size_t)f * (n_sym - 1) * 2 * k + k0;
  float cr0[kPer], ci0[kPer];
  spectrum8(m1, m2, m3, col + (size_t)r0 * k, cr0, ci0);
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    float cr1[kPer], ci1[kPer], dr[kPer], di[kPer];
    spectrum8(m1, m2, m3, col + (size_t)(r + 1) * k, cr1, ci1);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float a, b;
      demap1(cr1[i], ci1[i], cr0[i], ci0[i], a, b);
      dr[i] = __fdiv_rn(a, denom);
      di[i] = __fdiv_rn(b, denom);
      cr0[i] = cr1[i];
      ci0[i] = ci1[i];
    }
    store8(out + (size_t)r * 2 * k, dr);
    store8(out + (size_t)r * 2 * k + k, di);
  }
}

__device__ __forceinline__ float sq_sum(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// The tap: point q is element q * stride of the last frame's flattened
// (n_sym - 1, K) dr and di; scaled by 1 / sqrt(mean(dr^2 + di^2) + 1e-20)
// over the n_tap points (their sum padded to kTapPad, halving tree).
__device__ void tap(const __nv_bfloat16* __restrict__ m1, const __nv_bfloat16* __restrict__ m2,
                    const __nv_bfloat16* __restrict__ m3, float* __restrict__ out, int n_frames,
                    int n_sym, int k, int stride, int n_tap) {
  __shared__ float s[kTapPad];
  const int t = threadIdx.x;
  const size_t base = (size_t)(n_frames - 1) * n_sym * k;
  float pr[kTapPad / kStatsThreads], pi[kTapPad / kStatsThreads];
#pragma unroll
  for (int j = 0; j < kTapPad / kStatsThreads; ++j) {
    const int q = t + j * kStatsThreads;
    pr[j] = pi[j] = 0.f;
    if (q < n_tap) {
      const int e = q * stride, r = e / k, col = e - r * k;
      const size_t o0 = base + (size_t)r * k + col, o1 = o0 + k;
      const float a0 = __bfloat162float(m1[o0]), b0 = __bfloat162float(m2[o0]),
                  c0 = __bfloat162float(m3[o0]);
      const float a1 = __bfloat162float(m1[o1]), b1 = __bfloat162float(m2[o1]),
                  c1 = __bfloat162float(m3[o1]);
      demap1(rnd(__fsub_rn(a1, b1)), rnd(__fadd_rn(c1, a1)), rnd(__fsub_rn(a0, b0)),
             rnd(__fadd_rn(c0, a0)), pr[j], pi[j]);
    }
    s[q] = sq_sum(pr[j], pi[j]);
  }
  __syncthreads();
  for (int h = kTapPad >> 1; h > 0; h >>= 1) {
    for (int q = t; q < h; q += kStatsThreads) s[q] = __fadd_rn(s[q], s[q + h]);
    __syncthreads();
  }
  const float mean = __fdiv_rn(s[0], (float)n_tap);
  const float scale = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, 1e-20f)));
#pragma unroll
  for (int j = 0; j < kTapPad / kStatsThreads; ++j) {
    const int q = t + j * kStatsThreads;
    if (q < n_tap) {
      out[q] = __fmul_rn(pr[j], scale);
      out[kTap + q] = __fmul_rn(pi[j], scale);
    }
  }
}

// Thread t's 8 lane sums of re^2 + im^2 over a frame's samples 8v .. 8v + 7,
// v = t, t + 256, ...; kShift: u8 pairs starting sh pairs past fr.
template <typename T, bool kShift>
__device__ __forceinline__ void frame_sums(const T* __restrict__ fr, const T* __restrict__ fi,
                                           int sh, int n_vec, float (&acc)[kPer]) {
#pragma unroll 4
  for (int v = threadIdx.x; v < n_vec; v += kStatsThreads) {
    float a[kPer], b[kPer];
    if constexpr (std::is_same<T, uint8_t>::value) {
      load8_u8<kShift>(fr + (size_t)v * kPer * 2, sh, a, b);
    } else {
      load8(fr + (size_t)v * kPer, a);
      load8(fi + (size_t)v * kPer, b);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = __fadd_rn(acc[i], sq_sum(a[i], b[i]));
  }
}

// mean_power of frame f = blockIdx.x: thread t sums samples 8v .. 8v + 7
// for v = t, t + 256, ... into 8 lane sums, then lanes and block in a fixed
// tree, then / frame_len. T = uint8_t: re is the interleaved u8 I/Q (im
// not read), 2 frame_len bytes a frame, frame f starting at pair starts[f]
// of the buffer (any pair: a tracked stream's frames, as K5 carves them)
// or, where starts is null, at f * frame_len; the split parts' frames are
// always at f * frame_len.
template <typename T>
__global__ void __launch_bounds__(kStatsThreads) stats_kernel(
    const T* __restrict__ re, const T* __restrict__ im, const __nv_bfloat16* __restrict__ m1,
    const __nv_bfloat16* __restrict__ m2, const __nv_bfloat16* __restrict__ m3,
    float* __restrict__ mean_power, float* __restrict__ tap_out,
    const long long* __restrict__ starts, int frame_len, int n_sym, int k, int stride,
    int n_tap) {
  __shared__ float s[kStatsThreads];
  const int f = blockIdx.x;
  constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  constexpr size_t kElems = kU8 ? 2 : 1;
  const size_t base = kU8 && starts ? (size_t)starts[f] : (size_t)f * frame_len;
  const int sh = kU8 ? (int)(base % kPer) : 0;
  const T* fr = re + (base - sh) * kElems;
  const T* fi = im + (base - sh) * kElems;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  const int n_vec = frame_len / kPer;
  // the loop for aligned frames is the one without starts, its loads not
  // held back by a branch on the shift
  if (kU8 && sh)
    frame_sums<T, true>(fr, fi, sh, n_vec, acc);
  else
    frame_sums<T, false>(fr, fi, sh, n_vec, acc);
  const float sum = block_sum(lane_sum(acc), s);
  if (threadIdx.x == 0) mean_power[f] = __fdiv_rn(sum, (float)frame_len);
  if (f == 0) tap(m1, m2, m3, tap_out, gridDim.x, n_sym, k, stride, n_tap);
}

}  // namespace

extern "C" {

// m1, m2, m3: (F, n_sym, K) bf16, contiguous, 16-byte aligned; K % 8 == 0,
// K / 8 <= 1024. partials: (F, ceil((n_sym - 1) / rows), 2) f32.
int tpudab_demod_demap(const void* m1, const void* m2, const void* m3, void* partials, int f,
                       int n_sym, int k, int rows, void* stream) {
  const int chunks = (n_sym - 1 + rows - 1) / rows;
  demap_kernel<<<dim3(chunks, f), k / kPer, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)m1, (const __nv_bfloat16*)m2, (const __nv_bfloat16*)m3,
      (float*)partials, n_sym, k, rows);
  return (int)cudaGetLastError();
}

// soft: (F, (n_sym - 1) * 2K), bf16 (out_bf16) or f32; partials as
// tpudab_demod_demap wrote them, `chunks` a frame.
int tpudab_demod_norm(const void* m1, const void* m2, const void* m3, const void* partials,
                      void* soft, int out_bf16, int f, int n_sym, int k, int rows, int chunks,
                      void* stream) {
  const dim3 grid((n_sym - 1 + rows - 1) / rows, f);
  const cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16 *a = (const __nv_bfloat16*)m1, *b = (const __nv_bfloat16*)m2,
                      *c = (const __nv_bfloat16*)m3;
  if (out_bf16)
    norm_kernel<__nv_bfloat16><<<grid, k / kPer, 0, st>>>(
        a, b, c, (const float*)partials, (__nv_bfloat16*)soft, n_sym, k, rows, chunks);
  else
    norm_kernel<float><<<grid, k / kPer, 0, st>>>(a, b, c, (const float*)partials,
                                                  (float*)soft, n_sym, k, rows, chunks);
  return (int)cudaGetLastError();
}

// re, im: (F, frame_len) f32 (frames_dtype 0) or bf16 (1), or re the
// (F, frame_len, 2) interleaved u8 I/Q (2, im not read); contiguous, 16-byte
// aligned, frame_len % 8 == 0. mean_power: (F,) f32; tap: (2, 480) f32,
// rows 0 and 1 the tap's real and imaginary parts (n_tap <= 480 points).
// starts (null: frame f at f * frame_len; u8 frames only): (F,) int64,
// frame f's first I/Q pair in re, every frame inside the buffer.
int tpudab_demod_stats(const void* re, const void* im, int frames_dtype, const void* m1,
                       const void* m2, const void* m3, void* mean_power, void* tap,
                       const void* starts, int f, int frame_len, int n_sym, int k, int stride,
                       int n_tap, void* stream) {
  const long long* st8 = (const long long*)starts;
  const cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16 *a = (const __nv_bfloat16*)m1, *b = (const __nv_bfloat16*)m2,
                      *c = (const __nv_bfloat16*)m3;
  if (frames_dtype == 2)
    stats_kernel<uint8_t><<<f, kStatsThreads, 0, st>>>(
        (const uint8_t*)re, (const uint8_t*)re, a, b, c, (float*)mean_power, (float*)tap, st8,
        frame_len, n_sym, k, stride, n_tap);
  else if (frames_dtype == 1)
    stats_kernel<__nv_bfloat16><<<f, kStatsThreads, 0, st>>>(
        (const __nv_bfloat16*)re, (const __nv_bfloat16*)im, a, b, c, (float*)mean_power,
        (float*)tap, nullptr, frame_len, n_sym, k, stride, n_tap);
  else
    stats_kernel<float><<<f, kStatsThreads, 0, st>>>((const float*)re, (const float*)im, a, b,
                                                     c, (float*)mean_power, (float*)tap,
                                                     nullptr, frame_len, n_sym, k, stride,
                                                     n_tap);
  return (int)cudaGetLastError();
}

}  // extern "C"

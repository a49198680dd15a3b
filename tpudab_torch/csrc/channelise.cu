// The wideband front end's channeliser: each receiver's s8 I/Q stream at
// 16.384 MS/s split into its 8 ensembles at 2.048 MS/s, written as the bf16
// split, lane-tiled frames that K5 (carve.cu) takes
// (ofdm/channelise.py::Channeliser; the plain version is channelise_ref there).
//
// Replaces no TPU kernel: tpudab's inputs are one ensemble at 2.048 MS/s, and
// the stage it adds is the reference's VFO (SDR++ cuts one source's stream
// into channels). For block b at offset f_b from the receiver's centre,
//
//   y_b[m] = sum_k h[k] x[8m - k] exp(-j 2 pi f_b (8m - k) / fs)
//          = exp(-j 2 pi f_b 8m / fs) * sum_k g_b[k] x[8m - k],
//   g_b[k] = h[k] exp(+j 2 pi f_b k / fs),
//
// h the 120-tap low-pass. As a real product, the window of output m (the 120
// interleaved samples x[8m - 119 .. 8m], 240 values) times a 240 x 16 matrix
// of the 8 blocks' complex taps (ofdm/channelise.py::gemm_taps) gives the 8
// blocks' real and imaginary parts at once. Window m + 1 starts 16 values
// after window m, so with the samples in shared memory as rows of 8 (16
// halfs), the A operand of output tile [m, m + 16) and k-step kk is rows
// m + kk .. m + kk + 15: one ldmatrix.x4, no copy of the windows.
//
// Bound: 8 flop x 120 taps a complex output, 96.6 GFLOP a step of 32
// ensembles x 16 frames, and 629 MB (the s8 read once, the tail read and
// written once, the bf16 frames written): 0.188 ms at 3.35 TB/s against
// 1.44 ms at the CUDA cores' 67 TFLOP/s. So the taps run on the tensor cores
// (mma.sync m16n8k16, f16 in, f32 accumulate: an s8 sample is exact in f16,
// an f16 tap keeps 11 significant bits), where the work takes 0.098 ms at
// 989 TFLOP/s and the bytes bound it. The A operand comes from shared memory
// (15 ldmatrix.x4 a 16-row tile feed 30 mma), the taps stay in 60 registers a
// thread for the block's life, and each block's rows are swizzled so that
// the 8 rows of an ldmatrix fall in 8 bank groups. The exact rotation after
// decimation (every offset a whole number of kHz, so it repeats every 2048
// outputs: its phase is an integer index) is __sincosf in the epilogue, which
// also applies the 1/128 scale and the block's gain. Output m of block b goes
// to frame sample m - d_e of ensemble e = 8 s + b, where d_e is its frame
// offset, or nowhere; each warp stages its 32 outputs of the 16 block parts
// in shared memory so that each store instruction writes 64 contiguous
// bytes of one part of one ensemble (written from the mma layout, 4 blocks'
// 16 bytes each, the stores took half the kernel's time).
//
// The stream a step reads is the receiver's tail (its last 8 x frame_len +
// 119 samples, carried from the step before) then its new samples; the
// blocks that own the last n_tail of those write them as the next tail.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 120;
constexpr int DEC = 8;                     // decimation; also samples a shared-memory row
constexpr int KSTEPS = TAPS / DEC;         // 15 k-steps of 16 halfs
constexpr int BLOCKS = 8;                  // ensembles a receiver: 16 output columns
constexpr int WARPS = 4;
constexpr int TILES = 16;                  // 16-row output tiles a warp
constexpr int ROWS = WARPS * TILES * 16;   // 1024 outputs a thread block
constexpr int SROWS = ROWS + KSTEPS;       // shared-memory rows of 8 samples
constexpr int SAMPLES = SROWS * DEC;       // samples a thread block stages
constexpr int PHASES = 2048;               // the rotation's period in outputs
constexpr int PART_PITCH = 34;             // bf16 a staged row of outputs (32 + 2: no bank conflicts)

// Byte offset of 16-byte chunk `chunk` (0 or 1) of shared-memory row `row`:
// rows are 32 bytes, and the two chunks swap in rows whose bit 2 is set, so
// any 8 consecutive rows of one chunk lie in 8 distinct groups of 4 banks.
__device__ __forceinline__ unsigned smem_offset(int row, int chunk) {
  return (unsigned)(row * 32 + ((chunk ^ ((row >> 2) & 1)) << 4));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint4 load16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Two s8 bytes of a word to an f16 pair: byte b ^ 0x80 is b + 128 as an
// unsigned byte; under a high byte of 0x64 it is the f16 1024 + b + 128
// (exact), so less 1152 it is b. sel 0x5140 takes bytes 0 and 1 of the
// word, 0x7362 bytes 2 and 3.
__device__ __forceinline__ unsigned s8_pair(unsigned flipped, unsigned sel) {
  const unsigned h = __byte_perm(flipped, 0x64646464u, sel);
  const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h), __float2half2_rn(1152.f));
  return *reinterpret_cast<const unsigned*>(&v);
}

// One shared-memory row (8 samples) from its 16 raw bytes of I/Q pairs.
__device__ __forceinline__ void stage_row(unsigned char* sm, int row, uint4 raw) {
  const unsigned w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
  const uint4 c0 = make_uint4(s8_pair(w[0], 0x5140), s8_pair(w[0], 0x7362),
                              s8_pair(w[1], 0x5140), s8_pair(w[1], 0x7362));
  const uint4 c1 = make_uint4(s8_pair(w[2], 0x5140), s8_pair(w[2], 0x7362),
                              s8_pair(w[3], 0x5140), s8_pair(w[3], 0x7362));
  *reinterpret_cast<uint4*>(sm + smem_offset(row, 0)) = c0;
  *reinterpret_cast<uint4*>(sm + smem_offset(row, 1)) = c1;
}

// grid (ceil(rows / ROWS), receivers), WARPS x 32 threads. frag holds the
// taps as mma B fragments, (receivers, KSTEPS, 2, 32) uint2: for k-step kk,
// n-tile nt and lane 4 g + t, the f16 pairs (B[16kk + 2t, 8nt + g],
// B[16kk + 2t + 1, .]) and (B[16kk + 2t + 8, .], B[16kk + 2t + 9, .]).
// phase_step (receivers, BLOCKS): f_b in kHz mod PHASES; scale (receivers,
// BLOCKS): 1/128 times the f32 gain that gives each block's f16 taps the
// design's power over the active carriers. offsets: (receivers x BLOCKS)
// frame offsets. out_re / out_im: (receivers x BLOCKS, frame_samples).
// n_tail = 7 mod 8 (8 frame_len + TAPS - 1), so the new samples start 7
// samples into a row.
__global__ void __launch_bounds__(WARPS * 32, 4)
channelise_kernel(const int8_t* __restrict__ tail, long long tail_stride, long long n_tail,
                  const int8_t* __restrict__ x, long long x_stride, long long n_new,
                  const uint2* __restrict__ frag, const int* __restrict__ phase_step,
                  const float* __restrict__ scale, const int* __restrict__ offsets,
                  __nv_bfloat16* __restrict__ out_re, __nv_bfloat16* __restrict__ out_im,
                  long long frame_samples,
                  int8_t* __restrict__ new_tail, long long new_tail_stride) {
  __shared__ __align__(128) unsigned char sm[SROWS * 32];
  // each warp's 32 outputs of a tile pair, by block and part, before they go out
  __shared__ __nv_bfloat16 staged[WARPS][2 * BLOCKS][PART_PITCH];
  __shared__ long long first[BLOCKS];        // each block's output at frame sample 0
  const int s = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * ROWS;
  const long long v0 = m0 * DEC;                  // the first stream sample staged
  const long long n_total = n_tail + n_new;
  const long long keep = n_total - n_tail;        // the first sample of the next tail
  const long long own_end = blockIdx.x + 1 == gridDim.x ? n_total : v0 + ROWS * DEC;
  const int8_t* tail_s = tail + s * tail_stride;
  const int8_t* x_s = x + s * x_stride;
  int8_t* new_tail_s = new_tail + s * new_tail_stride;

  // 1. Stage samples v0 .. v0 + SAMPLES as f16 (I, Q) pairs, a row of 8 at
  // a time, zero past the stream's end; write the next tail's samples this
  // block owns. A row wholly in the tail is one aligned 16-byte load; a row
  // wholly in the new samples starts 2 bytes into a 16-byte chunk: that
  // chunk and the next one's first word, shifted. Rows across either edge
  // go a sample at a time.
  for (int r = threadIdx.x; r < SROWS; r += blockDim.x) {
    const long long v = v0 + 8 * r;
    uint4 raw;
    bool whole = true;
    if (v + 8 <= n_tail) {
      raw = load16(tail_s + 2 * v);
    } else if (v >= n_tail && v + 8 <= n_total) {
      const long long c = (v - n_tail) >> 3;      // v - n_tail = 8 c + 1
      const uint4 a = load16(x_s + 16 * c);
      const unsigned b = __ldg(reinterpret_cast<const unsigned*>(x_s + 16 * (c + 1)));
      raw = make_uint4(__funnelshift_r(a.x, a.y, 16), __funnelshift_r(a.y, a.z, 16),
                       __funnelshift_r(a.z, a.w, 16), __funnelshift_r(a.w, b, 16));
    } else {
      whole = false;
      union { uint4 v; char2 p[8]; } row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long vj = v + j;
        row.p[j] = make_char2(0, 0);
        if (vj < n_tail) row.p[j] = *reinterpret_cast<const char2*>(tail_s + 2 * vj);
        else if (vj < n_total)
          row.p[j] = *reinterpret_cast<const char2*>(x_s + 2 * (vj - n_tail));
        if (vj >= keep && vj < own_end && vj < n_total)
          *reinterpret_cast<char2*>(new_tail_s + 2 * (vj - keep)) = row.p[j];
      }
      raw = row.v;
    }
    stage_row(sm, r, raw);
    if (whole && v >= keep && v + 8 <= own_end)
      *reinterpret_cast<uint4*>(new_tail_s + 2 * (v - keep)) = raw;
  }
  __syncthreads();

  // 2. Whether any ensemble keeps an output of this block's rows.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bool needed = false;
#pragma unroll
  for (int b = 0; b < BLOCKS; ++b) {
    const long long d = offsets[s * BLOCKS + b];
    needed |= d < m0 + ROWS && d + frame_samples > m0;
  }
  if (!needed) return;
  if (threadIdx.x < BLOCKS) first[threadIdx.x] = offsets[s * BLOCKS + threadIdx.x];
  __syncthreads();

  uint2 bf[KSTEPS][2];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      bf[kk][nt] = __ldg(frag + ((s * KSTEPS + kk) * 2 + nt) * 32 + lane);
  }
  // this thread's two blocks in the epilogue: t and 4 + t
  int q[2];
  float gn[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    q[nt] = phase_step[s * BLOCKS + nt * 4 + t];
    gn[nt] = scale[s * BLOCKS + nt * 4 + t];
  }

  // 3. Two 16-row tiles at a time: 15 k-steps of two ldmatrix and four mma.
  const unsigned base = (unsigned)__cvta_generic_to_shared(sm);
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;
  for (int it = 0; it < TILES / 2; ++it) {
    const int r0 = warp * TILES * 16 + it * 32;
    float acc[2][2][4];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[tt][nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
        ldmatrix_x4(base + smem_offset(r0 + tt * 16 + kk + lrow, lchunk), a[tt]);
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        mma_f16(acc[tt][0], a[tt], bf[kk][0]);
        mma_f16(acc[tt][1], a[tt], bf[kk][1]);
      }
    }
    // 4. Rotate and scale each output to bf16 in shared memory, then write
    // the 32 outputs of each block and part as 64 contiguous bytes of its
    // ensemble's frames, where they fall inside them.
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = tt * 16 + g + 8 * h;
          // the rotation's phase, reduced to [-pi, pi): __sincosf errs there by
          // under 4e-7, far below a bf16 output's rounding
          const int idx = (q[nt] * (int)((m0 + r0 + row) & (PHASES - 1))) & (PHASES - 1);
          float sn, c;
          __sincosf((idx - (idx >= PHASES / 2 ? PHASES : 0)) * (6.283185307179586f / PHASES),
                    &sn, &c);
          c *= gn[nt];
          sn *= gn[nt];
          const float yr = acc[tt][nt][2 * h], yi = acc[tt][nt][2 * h + 1];
          staged[warp][2 * (nt * 4 + t)][row] = __float2bfloat16_rn(yr * c + yi * sn);
          staged[warp][2 * (nt * 4 + t) + 1][row] = __float2bfloat16_rn(yi * c - yr * sn);
        }
      }
    }
    __syncwarp();
    const long long m = m0 + r0 + lane;
#pragma unroll
    for (int i = 0; i < 2 * BLOCKS; ++i) {
      const long long p = m - first[i >> 1];
      if (p >= 0 && p < frame_samples)
        ((i & 1) ? out_im : out_re)[((long long)s * BLOCKS + (i >> 1)) * frame_samples + p] =
            staged[warp][i][lane];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int tpudab_channelise(const void* tail, long long tail_stride, long long n_tail,
                                 const void* x, long long x_stride, long long n_new,
                                 const void* frag, const void* phase_step, const void* scale,
                                 const void* offsets, void* out_re, void* out_im,
                                 long long frame_samples, void* new_tail,
                                 long long new_tail_stride, int receivers, long long rows,
                                 void* stream) {
  if (n_tail % 8 != 7 || n_new % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((rows + ROWS - 1) / ROWS), (unsigned)receivers);
  channelise_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(tail), tail_stride, n_tail, static_cast<const int8_t*>(x),
      x_stride, n_new, static_cast<const uint2*>(frag), static_cast<const int*>(phase_step),
      static_cast<const float*>(scale), static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out_re), static_cast<__nv_bfloat16*>(out_im), frame_samples,
      static_cast<int8_t*>(new_tail), new_tail_stride);
  return (int)cudaGetLastError();
}

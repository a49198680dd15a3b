// Viterbi decoder for the K=7 rate-1/4 DAB mother code: forward ACS pass
// and traceback fused in one launch, in two kernels that share both.
//
// viterbi_kernel replaces tpudab/ops/viterbi_pallas.py::_fwd_kernel (K1,
// :60-109) and ::_tb_kernel_packed (K2, :124-150) on the transposed path
// viterbi_decode_pallas_bytes_t: soft bits (T2p, 8, B) in, MSB-first packed
// bytes out. viterbi_bits_kernel replaces K1 and ::_tb_kernel (K3,
// :153-177) on the bit-level path viterbi_decode_pallas: mother soft bits
// (B, T, 4) in, one 0/1 byte per decoded bit out (K3's unpack at :308-311
// is fused into the traceback). Plain torch twins:
// tpudab_torch/ops/viterbi.py::viterbi_decode_bytes_t_ref and
// ::viterbi_decode_ref, which these kernels match bit for bit (same
// branch-metric summation order, same pairwise strict-> selects, same
// rebase schedule).
//
// What bounds it on Hopper: the trellis is sequential in time, so a
// codeword is a chain of T2p dependent ACS steps; the work is ~40 f32 adds
// and selects per state per super-step with a block-wide barrier between
// steps. Memory traffic is small (8 soft values in, 16 B of decisions out
// per super-step and codeword), so the kernel is bound by instruction
// throughput and barrier latency, and throughput comes from running many
// codewords at once.
//
// Design: one block of 64 threads (one per destination state) per codeword;
// on the TPU the batch lay on lanes and the grid walked time, here blocks
// run in parallel and each walks its codeword's time axis in a loop. Path
// metrics are double-buffered in shared memory (one barrier per step); the
// 16 super-steps of soft values between rebases are staged in shared memory
// per codeword by a loader, the only part that differs between the layouts:
// the transposed layout reads one value per codeword from each (8, B) row;
// the (B, T, 4) layout reads 128 contiguous values per codeword (coalesced)
// and loads +1.0, the zero-input flush, at mother steps >= T, so no padded
// or transposed copy is made. Each thread packs 4 super-steps of 2-bit
// decisions per byte (step q in bits [6-2q, 8-2q)), written as a coalesced
// 64-byte row to a global scratch (B, T2p/4, 64). After the forward pass
// warp 0 walks the traceback from state 0: rows are fetched 8 at a time
// into lanes (their addresses do not depend on the state), and the state's
// byte is picked with a warp shuffle, so the dependent chain costs
// shuffles, not loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr int kRebase = 16;  // super-steps between rebases (the _t path's chunk)
constexpr int kSoft = 8;     // mother soft bits per radix-2 super-step
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Bit (j*8 + i) of the mask: signs[i][(j << 6) | s] is -1.
__device__ __forceinline__ uint32_t sign_mask(const float* __restrict__ signs, int s) {
  uint32_t neg = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < kSoft; ++i)
      if (signs[i * 4 * kStates + (j << 6) + s] < 0.f) neg |= 1u << (j * kSoft + i);
  return neg;
}

// Soft value k (0..127) of the 16 super-steps from t0, transposed layout
// (t2p, 8, b): one value per codeword in each row.
template <typename T>
struct TransposedSoft {
  const T* soft;
  int b, cw;
  __device__ float operator()(int t0, int k) const {
    return to_f32(soft[((size_t)t0 * kSoft + k) * b + cw]);
  }
};

// The same from one codeword's (T, 4) mother soft bits; +1.0 past T.
template <typename T>
struct MotherSoft {
  const T* row;
  int n_vals;  // 4 * T
  __device__ float operator()(int t0, int k) const {
    const int idx = t0 * kSoft + k;
    return idx < n_vals ? to_f32(row[idx]) : 1.f;
  }
};

// Forward ACS over t2p super-steps (t2p % 16 == 0) by the block's 64
// threads; writes the packed decision rows of this codeword to dcw.
template <typename Loader>
__device__ void forward_acs(const Loader& load, const float* __restrict__ signs,
                            int t2p, uint8_t* __restrict__ dcw) {
  const int s = threadIdx.x;
  __shared__ float pm_a[kStates];
  __shared__ float pm_b[kStates];
  __shared__ float xs[kRebase * kSoft];
  const uint32_t neg = sign_mask(signs, s);
  const int pred_lo = s >> 2;

  float* cur = pm_a;
  float* nxt = pm_b;
  cur[s] = (s == 0) ? 0.f : kNeg;
  uint32_t acc = 0;

  for (int t0 = 0; t0 < t2p; t0 += kRebase) {
    __syncthreads();  // last chunk's reads of xs are done
    for (int k = s; k < kRebase * kSoft; k += kStates) xs[k] = load(t0, k);
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < kRebase; ++q) {
      const float* x = xs + q * kSoft;
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // f32 sum in index order i = 0..7; +-x is exact, so this equals
        // the plain version's sum of signs * soft
        float bm = ((neg >> (j * kSoft)) & 1) ? -x[0] : x[0];
#pragma unroll
        for (int i = 1; i < kSoft; ++i)
          bm = __fadd_rn(bm, ((neg >> (j * kSoft + i)) & 1) ? -x[i] : x[i]);
        c[j] = __fadd_rn(cur[pred_lo | (j << 4)], bm);
      }
      const bool d01 = c[1] > c[0];
      const float m01 = d01 ? c[1] : c[0];
      const bool d23 = c[3] > c[2];
      const float m23 = d23 ? c[3] : c[2];
      const bool dh = m23 > m01;
      float v = dh ? m23 : m01;
      const uint32_t d = dh ? (2u | (uint32_t)d23) : (uint32_t)d01;
      const int t = t0 + q;
      acc |= d << (6 - 2 * (t & 3));
      if ((t & 3) == 3) {
        dcw[(size_t)(t >> 2) * kStates + s] = (uint8_t)acc;
        acc = 0;
      }
      nxt[s] = v;
      __syncthreads();
      if (q == kRebase - 1) {
        // rebase by pm[0]: decisions are unchanged, metrics stay bounded
        v = __fsub_rn(v, nxt[0]);
        cur[s] = v;  // every read of cur for this step is behind the barrier
        __syncthreads();
      } else {
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
  }
  __syncthreads();  // this block's decision rows are visible to warp 0
}

// Traceback from state 0 by warp 0 over `groups` packed decision rows.
// kBits: one 0/1 byte per decoded bit, for bits < n_out (K3); otherwise
// one MSB-first byte per 4 super-steps, for bytes < n_out (K2).
template <bool kBits>
__device__ void traceback(const uint8_t* __restrict__ dcw, int groups,
                          uint8_t* __restrict__ ocw, int n_out) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const uint16_t* rows = reinterpret_cast<const uint16_t*>(dcw);
  int state = 0;
  for (int g_hi = groups; g_hi > 0; g_hi -= 8) {
    uint32_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int g = g_hi - 1 - u;
      v[u] = g >= 0 ? rows[(size_t)g * (kStates / 2) + lane] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int g = g_hi - 1 - u;
      if (g < 0) break;
      uint32_t byte = 0;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        const uint32_t w = __shfl_sync(0xffffffffu, v[u], state >> 1);
        const uint32_t row_byte = (state & 1) ? (w >> 8) : w;
        const int j = (row_byte >> (6 - 2 * q)) & 3;
        if (kBits) {
          // super-step t = 4g + q decodes bits 2t ((state >> 1) & 1) and
          // 2t + 1 (state & 1); the state is the same in every lane
          const int bit = 8 * g + 2 * q;
          if (lane == 0 && bit < n_out) ocw[bit] = (uint8_t)((state >> 1) & 1);
          if (lane == 0 && bit + 1 < n_out) ocw[bit + 1] = (uint8_t)(state & 1);
        } else {
          byte |= (uint32_t)(state & 3) << (6 - 2 * q);
        }
        state = (state >> 2) | (j << 4);
      }
      if (!kBits && lane == 0 && g < n_out) ocw[g] = (uint8_t)byte;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kStates)
viterbi_kernel(const T* __restrict__ soft, const float* __restrict__ signs,
               uint8_t* __restrict__ dec, uint8_t* __restrict__ out,
               int t2p, int b, int n_out) {
  const int cw = blockIdx.x;
  uint8_t* dcw = dec + (size_t)cw * (t2p / 4) * kStates;
  forward_acs(TransposedSoft<T>{soft, b, cw}, signs, t2p, dcw);
  traceback<false>(dcw, t2p / 4, out + (size_t)cw * n_out, n_out);
}

template <typename T>
__global__ void __launch_bounds__(kStates)
viterbi_bits_kernel(const T* __restrict__ soft, const float* __restrict__ signs,
                    uint8_t* __restrict__ dec, uint8_t* __restrict__ out,
                    int t_mother, int t2p, int n_bits) {
  const int cw = blockIdx.x;
  uint8_t* dcw = dec + (size_t)cw * (t2p / 4) * kStates;
  const int n_vals = 4 * t_mother;
  forward_acs(MotherSoft<T>{soft + (size_t)cw * n_vals, n_vals}, signs, t2p, dcw);
  traceback<true>(dcw, t2p / 4, out + (size_t)cw * n_bits, n_bits);
}

}  // namespace

// soft: (t2p, 8, b) bf16 (is_bf16=1) or f32; signs: (8, 256) f32;
// dec: (b, t2p/4, 64) u8 scratch; out: (b, n_out) u8. t2p % 16 == 0.
extern "C" int tpudab_viterbi_decode_bytes_t(const void* soft, int is_bf16,
                                             const void* signs, void* dec,
                                             void* out, int t2p, int b,
                                             int n_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(signs);
  uint8_t* d = static_cast<uint8_t*>(dec);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is_bf16)
    viterbi_kernel<__nv_bfloat16><<<b, kStates, 0, st>>>(
        static_cast<const __nv_bfloat16*>(soft), sg, d, o, t2p, b, n_out);
  else
    viterbi_kernel<float><<<b, kStates, 0, st>>>(
        static_cast<const float*>(soft), sg, d, o, t2p, b, n_out);
  return (int)cudaGetLastError();
}

// soft: (b, t_mother, 4) bf16 (is_bf16=1) or f32; signs: (8, 256) f32;
// dec: (b, t2p/4, 64) u8 scratch; out: (b, n_bits) u8, one bit per byte.
// t2p % 16 == 0 and 2 * t2p >= t_mother >= n_bits.
extern "C" int tpudab_viterbi_decode_bits(const void* soft, int is_bf16,
                                          const void* signs, void* dec,
                                          void* out, int t_mother, int t2p,
                                          int b, int n_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(signs);
  uint8_t* d = static_cast<uint8_t*>(dec);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is_bf16)
    viterbi_bits_kernel<__nv_bfloat16><<<b, kStates, 0, st>>>(
        static_cast<const __nv_bfloat16*>(soft), sg, d, o, t_mother, t2p, n_bits);
  else
    viterbi_bits_kernel<float><<<b, kStates, 0, st>>>(
        static_cast<const float*>(soft), sg, d, o, t_mother, t2p, n_bits);
  return (int)cudaGetLastError();
}

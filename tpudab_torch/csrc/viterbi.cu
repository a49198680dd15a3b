// Viterbi decoder for the K=7 rate-1/4 DAB mother code: one forward ACS
// pass and one traceback, shared by the decode kernels and by the kernel
// experiments that take them apart.
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
// viterbi_fwd_variant_kernel is the forward pass alone, in the variants
// that tpudab's kernel-experiment tools time (all K1 taken apart):
//   - tools/exp_viterbi_decompose.py::_variant_kernel (:42; full, nodec,
//     noacs = bmonly), ::_prefetch_kernel (:103), ::_gmm4_kernel (:154),
//     ::_dbuf_kernel (:202; f32 and bf16 soft);
//   - tools/exp_viterbi.py::_fwd_kernel_wide (:35; the same instantiation
//     as gmm4: the branch metrics of a group's 4 super-steps at its start);
//   - tools/exp_viterbi_i16.py::_fwd_kernel_i16 (:45; int16 soft and path
//     metrics, start -16000, rebase by state 0 every 4 super-steps);
//   - tools/exp_depunct_t.py::fwd_t (:42; full on bf16, rebase every 16).
// viterbi_traceback_kernel is the traceback alone: tpudab's r5
// _tb_kernel_packed (viterbi_pallas.py:124) as exp_viterbi_decompose.py's
// `tb` (:406) and exp_depunct_t.py::tb_t (:68) call it, mode shuffle (the
// decode kernels' traceback); tools/exp_tb_tree.py's pre-r5 masked
// reduction (:14, mode masked) and 6-level select tree (:42, mode tree).
// Plain torch twins: tpudab_torch/ops/viterbi_exp.py::fwd_variant_ref and
// ::traceback_bytes_ref, which these kernels match exactly.
//
// What bounds it on Hopper: the trellis is sequential in time, so a
// codeword is a chain of T2p dependent ACS steps; the work is ~40 f32 adds
// and selects per state per super-step with a block-wide barrier between
// steps. Memory traffic is small (8 soft values in, 16 B of decisions out
// per super-step and codeword), so the kernel is bound by instruction
// throughput and barrier latency, and throughput comes from running many
// codewords at once. The traceback is a chain of dependent byte picks over
// the decisions, which it reads once (bytes, then latency).
//
// Design: one block of 64 threads (one per destination state) per codeword;
// on the TPU the batch lay on lanes and the grid walked time, here blocks
// run in parallel and each walks its codeword's time axis in a loop. Path
// metrics are double-buffered in shared memory (one barrier per step); the
// 16 super-steps of soft values of a chunk are staged in shared memory per
// codeword by a loader, the only part that differs between the layouts:
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
//
// The variants change only where the branch metrics come from and what is
// kept, so the differences between their times measure the parts:
//   full      branch metrics of step t computed at step t (the decode
//             kernels' forward);
//   nodec     the same ACS chain, no decision extract or pack: a zero row
//             is stored per group, as tpudab's does (:94);
//   noacs     no recursion and no barrier per step: decision bit
//             bm_j0 > bm_j1 from the branch metrics alone (tpudab's
//             `not do_acs` branch, which returns before `do_dec` is read,
//             so its bmonly is this kernel too); the branch metrics of
//             j = 2, 3 go into a running max, so that all four are
//             computed, as tpudab's full (256, B) product is;
//   prefetch  branch metrics of step t+1 computed into registers before
//             the ACS of step t (clamped at the staging chunk's end);
//   dbuf      the same into a double buffer in shared memory;
//   group4    the 4 super-steps' branch metrics of a group computed at
//             the group's start (gmm4, and X1's wide layout).
// The variant kernel also writes each thread's final metric, (B, 64) f32
// (noacs: its running max), so that nvcc cannot delete a chain whose
// decisions are not stored. The rebase interval is a template parameter:
// 16 for the decode kernels (the _t path's chunk), 32, 16 or 4 for the
// tools, the TPU's chunk in each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr int kStage = 16;  // super-steps of soft values staged at a time
constexpr int kSoft = 8;    // mother soft bits per radix-2 super-step

enum Variant { kFull = 0, kNoDec = 1, kNoAcs = 2, kPrefetch = 3, kDbuf = 4, kGroup4 = 5 };
enum TbMode { kShuffle = 0, kMasked = 1, kTree = 2 };

// f32 path metrics for f32 and bf16 soft; int16 metrics with int16
// wrap-around for int16 soft (X3).
struct F32Metric {
  using M = float;
  static constexpr float kStart = -1e9f;
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float of(float x) { return x; }
  __device__ static float of(__nv_bfloat16 x) { return __bfloat162float(x); }
};

struct I16Metric {
  using M = int16_t;
  static constexpr int16_t kStart = -16000;
  __device__ static int16_t add(int16_t a, int16_t b) { return (int16_t)(a + b); }
  __device__ static int16_t sub(int16_t a, int16_t b) { return (int16_t)(a - b); }
  __device__ static int16_t of(int16_t x) { return x; }
};

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

// Branch metric of super-transition (j << 6) | s: the sum in index order
// i = 0..7; +-x is exact, so this equals the plain version's sum of
// signs * soft.
template <typename Mt>
__device__ __forceinline__ typename Mt::M branch_metric(const typename Mt::M* x, uint32_t neg,
                                                        int j) {
  typename Mt::M bm = ((neg >> (j * kSoft)) & 1) ? -x[0] : x[0];
#pragma unroll
  for (int i = 1; i < kSoft; ++i)
    bm = Mt::add(bm, ((neg >> (j * kSoft + i)) & 1) ? -x[i] : x[i]);
  return bm;
}

// Soft value k (0..127) of the 16 super-steps from t0, transposed layout
// (t2p, 8, b): one value per codeword in each row.
template <typename T>
struct TransposedSoft {
  const T* soft;
  int b, cw;
  __device__ T operator()(int t0, int k) const { return soft[((size_t)t0 * kSoft + k) * b + cw]; }
};

// The same from one codeword's (T, 4) mother soft bits; +1.0 past T.
template <typename T>
struct MotherSoft {
  const T* row;
  int n_vals;  // 4 * T
  __device__ float operator()(int t0, int k) const {
    const int idx = t0 * kSoft + k;
    return idx < n_vals ? F32Metric::of(row[idx]) : 1.f;
  }
};

// Whether the metrics are rebased after super-step t0 + g4 + u of a chunk
// of kStage from t0 (every kRebase super-steps; known at compile time
// within a chunk).
template <int kRebase>
__device__ __forceinline__ bool rebase_after(int t0, int g4, int u) {
  static_assert(kRebase == 4 || kRebase % kStage == 0, "rebase every 4 or 16k super-steps");
  if (kRebase == 4) return u == 3;
  return u == 3 && g4 == kStage - 4 && (kRebase == kStage || (t0 + kStage) % kRebase == 0);
}

// Forward ACS over t2p super-steps (t2p % 16 == 0, t2p % kRebase == 0) by
// the block's 64 threads; writes the packed decision rows of this codeword
// to dcw and returns this thread's final path metric (noacs: its running
// max of the j = 2, 3 branch metrics).
template <int kVariant, typename Mt, int kRebase, typename Loader>
__device__ typename Mt::M forward_acs(const Loader& load, const float* __restrict__ signs,
                                      int t2p, uint8_t* __restrict__ dcw) {
  using M = typename Mt::M;
  const int s = threadIdx.x;
  __shared__ M pm_a[kStates];
  __shared__ M pm_b[kStates];
  __shared__ M xs[kStage * kSoft];
  __shared__ M bm_buf[kVariant == kDbuf ? 2 * 4 * kStates : 1];
  const uint32_t neg = sign_mask(signs, s);
  const int pred_lo = s >> 2;

  M* cur = pm_a;
  M* nxt = pm_b;
  M v = (s == 0) ? (M)0 : Mt::kStart;
  cur[s] = v;
  uint32_t acc = 0;
  M bm[4], bm_next[4], bm_grp[4][4];

  for (int t0 = 0; t0 < t2p; t0 += kStage) {
    __syncthreads();  // last chunk's reads of xs are done
    for (int k = s; k < kStage * kSoft; k += kStates) xs[k] = Mt::of(load(t0, k));
    __syncthreads();
    if (kVariant == kPrefetch) {
#pragma unroll
      for (int j = 0; j < 4; ++j) bm[j] = branch_metric<Mt>(xs, neg, j);
    }
    if (kVariant == kDbuf) {
#pragma unroll
      for (int j = 0; j < 4; ++j) bm_buf[(j << 6) | s] = branch_metric<Mt>(xs, neg, j);
    }
    // groups of 4 super-steps, each unrolled, so that the step within the
    // group (u) and every register index below are compile-time constants
    for (int g4 = 0; g4 < kStage; g4 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = g4 + u;
        const M* x = xs + q * kSoft;
        const M* x_next = xs + (q + 1 < kStage ? q + 1 : kStage - 1) * kSoft;
        if (kVariant == kFull || kVariant == kNoDec || kVariant == kNoAcs) {
#pragma unroll
          for (int j = 0; j < 4; ++j) bm[j] = branch_metric<Mt>(x, neg, j);
        } else if (kVariant == kPrefetch) {
#pragma unroll
          for (int j = 0; j < 4; ++j) bm_next[j] = branch_metric<Mt>(x_next, neg, j);
        } else if (kVariant == kDbuf) {
          // each thread reads back only the entries it wrote: no barrier
          M* fill = bm_buf + ((u + 1) & 1) * 4 * kStates;
          const M* use = bm_buf + (u & 1) * 4 * kStates;
#pragma unroll
          for (int j = 0; j < 4; ++j) fill[(j << 6) | s] = branch_metric<Mt>(x_next, neg, j);
#pragma unroll
          for (int j = 0; j < 4; ++j) bm[j] = use[(j << 6) | s];
        } else if (kVariant == kGroup4) {
          if (u == 0) {
#pragma unroll
            for (int w = 0; w < 4; ++w)
#pragma unroll
              for (int j = 0; j < 4; ++j) bm_grp[w][j] = branch_metric<Mt>(x + w * kSoft, neg, j);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) bm[j] = bm_grp[u][j];
        }

        uint32_t d;
        if (kVariant == kNoAcs) {
          d = bm[0] > bm[1];
          const M m23 = bm[3] > bm[2] ? bm[3] : bm[2];
          v = m23 > v ? m23 : v;
        } else {
          M c[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = Mt::add(cur[pred_lo | (j << 4)], bm[j]);
          const bool d01 = c[1] > c[0];
          const M m01 = d01 ? c[1] : c[0];
          const bool d23 = c[3] > c[2];
          const M m23 = d23 ? c[3] : c[2];
          const bool dh = m23 > m01;
          v = dh ? m23 : m01;
          d = dh ? (2u | (uint32_t)d23) : (uint32_t)d01;
        }
        if (kVariant != kNoDec) acc |= d << (6 - 2 * u);
        if (u == 3) {
          dcw[(size_t)((t0 + q) >> 2) * kStates + s] = (uint8_t)acc;
          acc = 0;
        }
        if (kVariant == kNoAcs) continue;
        if (kVariant == kPrefetch) {
#pragma unroll
          for (int j = 0; j < 4; ++j) bm[j] = bm_next[j];
        }
        nxt[s] = v;
        __syncthreads();
        if (rebase_after<kRebase>(t0, g4, u)) {
          // rebase by pm[0]: decisions are unchanged, metrics stay bounded
          v = Mt::sub(v, nxt[0]);
          cur[s] = v;  // every read of cur for this step is behind the barrier
          __syncthreads();
        } else {
          M* tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
      }
    }
  }
  __syncthreads();  // this block's decision rows are visible to warp 0
  return v;
}

// Row byte of `state` (in its low 8 bits) in a group's 64 decision bytes,
// which the warp holds in lanes (bytes 2*lane and 2*lane + 1): by a warp
// shuffle, or by tpudab's pre-r5 masked sum over the 64 rows.
template <int kMode>
__device__ __forceinline__ uint32_t row_byte(uint32_t w, int state, int lane) {
  if constexpr (kMode == kShuffle) {
    const uint32_t v = __shfl_sync(0xffffffffu, w, state >> 1);
    return (state & 1) ? (v >> 8) : v;
  } else {
    uint32_t hit = (2 * lane == state ? (w & 0xffu) : 0u) +
                   (2 * lane + 1 == state ? ((w >> 8) & 0xffu) : 0u);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hit += __shfl_xor_sync(0xffffffffu, hit, o);
    return hit;
  }
}

// Traceback from state 0 by one warp over `groups` packed decision rows.
// kBits: one 0/1 byte per decoded bit, for bits < n_out (K3); otherwise
// one MSB-first byte per 4 super-steps, for bytes < n_out (K2).
template <bool kBits, int kMode = kShuffle>
__device__ void traceback(const uint8_t* __restrict__ dcw, int groups,
                          uint8_t* __restrict__ ocw, int n_out) {
  const int lane = threadIdx.x & 31;
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
        const int j = (row_byte<kMode>(v[u], state, lane) >> (6 - 2 * q)) & 3;
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

// The same by one thread, bytes out, picking the state's byte by a 6-level
// binary select on the state bits, high bit first, over the row held in 16
// registers, as tools/exp_tb_tree.py::_tb_kernel_tree halves its 64 rows.
__device__ void traceback_tree(const uint8_t* __restrict__ dcw, int groups,
                               uint8_t* __restrict__ ocw, int n_out) {
  const uint4* rows = reinterpret_cast<const uint4*>(dcw);
  int state = 0;
  for (int g = groups - 1; g >= 0; --g) {
    uint32_t r[16];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 w = rows[(size_t)g * 4 + u];
      r[4 * u] = w.x; r[4 * u + 1] = w.y; r[4 * u + 2] = w.z; r[4 * u + 3] = w.w;
    }
    uint32_t byte = 0;
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      uint32_t v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = r[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = ((state >> 5) & 1) ? v[i + 8] : v[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = ((state >> 4) & 1) ? v[i + 4] : v[i];
#pragma unroll
      for (int i = 0; i < 2; ++i) v[i] = ((state >> 3) & 1) ? v[i + 2] : v[i];
      uint32_t w = ((state >> 2) & 1) ? v[1] : v[0];
      w = ((state >> 1) & 1) ? (w >> 16) : w;
      const uint32_t rb = (state & 1) ? (w >> 8) : w;
      const int j = (rb >> (6 - 2 * q)) & 3;
      byte |= (uint32_t)(state & 3) << (6 - 2 * q);
      state = (state >> 2) | (j << 4);
    }
    if (g < n_out) ocw[g] = (uint8_t)byte;
  }
}

template <typename T>
__global__ void __launch_bounds__(kStates)
viterbi_kernel(const T* __restrict__ soft, const float* __restrict__ signs,
               uint8_t* __restrict__ dec, uint8_t* __restrict__ out,
               int t2p, int b, int n_out) {
  const int cw = blockIdx.x;
  uint8_t* dcw = dec + (size_t)cw * (t2p / 4) * kStates;
  forward_acs<kFull, F32Metric, kStage>(TransposedSoft<T>{soft, b, cw}, signs, t2p, dcw);
  if (threadIdx.x < 32) traceback<false>(dcw, t2p / 4, out + (size_t)cw * n_out, n_out);
}

template <typename T>
__global__ void __launch_bounds__(kStates)
viterbi_bits_kernel(const T* __restrict__ soft, const float* __restrict__ signs,
                    uint8_t* __restrict__ dec, uint8_t* __restrict__ out,
                    int t_mother, int t2p, int n_bits) {
  const int cw = blockIdx.x;
  uint8_t* dcw = dec + (size_t)cw * (t2p / 4) * kStates;
  const int n_vals = 4 * t_mother;
  forward_acs<kFull, F32Metric, kStage>(MotherSoft<T>{soft + (size_t)cw * n_vals, n_vals},
                                        signs, t2p, dcw);
  if (threadIdx.x < 32) traceback<true>(dcw, t2p / 4, out + (size_t)cw * n_bits, n_bits);
}

template <typename T, typename Mt, int kVariant, int kRebase>
__global__ void __launch_bounds__(kStates)
viterbi_fwd_variant_kernel(const T* __restrict__ soft, const float* __restrict__ signs,
                           uint8_t* __restrict__ dec, float* __restrict__ pm_out,
                           int t2p, int b) {
  const int cw = blockIdx.x;
  const auto v = forward_acs<kVariant, Mt, kRebase>(TransposedSoft<T>{soft, b, cw}, signs, t2p,
                                                    dec + (size_t)cw * (t2p / 4) * kStates);
  pm_out[(size_t)cw * kStates + threadIdx.x] = (float)v;
}

// Shuffle and masked: one warp per codeword, the block's warps on
// consecutive codewords; tree: one thread per codeword.
template <int kMode>
__global__ void viterbi_traceback_kernel(const uint8_t* __restrict__ dec,
                                         uint8_t* __restrict__ out, int groups,
                                         int b, int n_out) {
  if constexpr (kMode == kTree) {
    const int cw = blockIdx.x * blockDim.x + threadIdx.x;
    if (cw < b)
      traceback_tree(dec + (size_t)cw * groups * kStates, groups, out + (size_t)cw * n_out, n_out);
  } else {
    const int cw = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    if (cw < b)
      traceback<false, kMode>(dec + (size_t)cw * groups * kStates, groups,
                              out + (size_t)cw * n_out, n_out);
  }
}

template <typename T, typename Mt, int kRebase>
cudaError_t launch_fwd(const void* soft, const float* signs, uint8_t* dec, float* pm,
                       int t2p, int b, int variant, cudaStream_t st) {
  const T* x = static_cast<const T*>(soft);
  switch (variant) {
#define TPUDAB_FWD_CASE(V)                                                                 \
    case V:                                                                                \
      viterbi_fwd_variant_kernel<T, Mt, V, kRebase><<<b, kStates, 0, st>>>(x, signs, dec, pm, \
                                                                          t2p, b);         \
      break;
    TPUDAB_FWD_CASE(kFull)
    TPUDAB_FWD_CASE(kNoDec)
    TPUDAB_FWD_CASE(kNoAcs)
    TPUDAB_FWD_CASE(kPrefetch)
    TPUDAB_FWD_CASE(kDbuf)
    TPUDAB_FWD_CASE(kGroup4)
#undef TPUDAB_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

// soft: (t2p, 8, b), dtype 0 f32, 1 bf16 (rebase 16 or 32), 2 int16
// (rebase 4); signs: (8, 256) f32; dec: (b, t2p/4, 64) u8; pm: (b, 64)
// f32. t2p % 16 == 0, t2p % rebase == 0. variant: 0 full, 1 nodec,
// 2 noacs, 3 prefetch, 4 dbuf, 5 group4.
extern "C" int tpudab_viterbi_fwd_variant(const void* soft, int dtype, const void* signs,
                                          void* dec, void* pm, int t2p, int b,
                                          int variant, int rebase, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(signs);
  uint8_t* d = static_cast<uint8_t*>(dec);
  float* p = static_cast<float*>(pm);
  if (dtype == 0 && rebase == 16)
    return (int)launch_fwd<float, F32Metric, 16>(soft, sg, d, p, t2p, b, variant, st);
  if (dtype == 0 && rebase == 32)
    return (int)launch_fwd<float, F32Metric, 32>(soft, sg, d, p, t2p, b, variant, st);
  if (dtype == 1 && rebase == 16)
    return (int)launch_fwd<__nv_bfloat16, F32Metric, 16>(soft, sg, d, p, t2p, b, variant, st);
  if (dtype == 1 && rebase == 32)
    return (int)launch_fwd<__nv_bfloat16, F32Metric, 32>(soft, sg, d, p, t2p, b, variant, st);
  if (dtype == 2 && rebase == 4)
    return (int)launch_fwd<int16_t, I16Metric, 4>(soft, sg, d, p, t2p, b, variant, st);
  return (int)cudaErrorInvalidValue;
}

// dec: (b, groups, 64) u8, 16-byte aligned rows; out: (b, n_out) u8,
// n_out <= groups. mode: 0 shuffle, 1 masked, 2 tree.
extern "C" int tpudab_viterbi_traceback(const void* dec, void* out, int groups, int b,
                                        int n_out, int mode, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(dec);
  uint8_t* o = static_cast<uint8_t*>(out);
  constexpr int kWarps = 4;   // codewords per block for the warp modes
  constexpr int kTreeBlock = 128;
  if (mode == kShuffle)
    viterbi_traceback_kernel<kShuffle><<<(b + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
        d, o, groups, b, n_out);
  else if (mode == kMasked)
    viterbi_traceback_kernel<kMasked><<<(b + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
        d, o, groups, b, n_out);
  else if (mode == kTree)
    viterbi_traceback_kernel<kTree><<<(b + kTreeBlock - 1) / kTreeBlock, kTreeBlock, 0, st>>>(
        d, o, groups, b, n_out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Viterbi decoder for the K=7 rate-1/4 DAB mother code: one forward ACS
// pass and one traceback, shared by the decode kernels and by the kernel
// experiments that take them apart.
//
// What it replaces. viterbi_kernel replaces
// tpudab/ops/viterbi_pallas.py::_fwd_kernel (K1, :60-109) and
// ::_tb_kernel_packed (K2, :124-150) on the transposed path
// viterbi_decode_pallas_bytes_t: soft bits (T2p, 8, B) in, MSB-first
// packed bytes out. viterbi_bits_kernel replaces K1 and ::_tb_kernel (K3,
// :153-177) on the bit-level path viterbi_decode_pallas: mother soft bits
// (B, T, 4) in, one 0/1 byte per decoded bit out (K3's unpack at :308-311
// is fused into the traceback). Plain torch twins:
// tpudab_torch/ops/viterbi.py::viterbi_decode_bytes_t_ref and
// ::viterbi_decode_ref, which these kernels match bit for bit (same
// index-order branch-metric sums, same pairwise strict-> selects, same
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
//   - tools/exp_depunct_t.py::fwd_t (:42; full on bf16, rebase 16).
// viterbi_traceback_kernel is the traceback alone: tpudab's r5
// _tb_kernel_packed (viterbi_pallas.py:124) as exp_viterbi_decompose.py's
// `tb` (:406) and exp_depunct_t.py::tb_t (:68) call it, mode shuffle (the
// decode kernels' traceback); tools/exp_tb_tree.py's pre-r5 masked
// reduction (:14, mode masked) and 6-level select tree (:42, mode tree:
// its walk by one thread a codeword, the state's byte picked by a load).
// Plain torch twins: tpudab_torch/ops/viterbi_exp.py::fwd_variant_ref and
// ::traceback_bytes_ref, which these kernels match exactly.
//
// What bounds it on Hopper. The trellis is sequential in time: a codeword
// is a chain of T2p dependent ACS steps, so throughput comes from running
// many codewords at once, and each one's chain should be short. Memory
// traffic is small (8 soft values in and 16 bytes of decisions out per
// super-step and codeword), so the forward pass is bound by instructions:
// ALU work (the branch-metric sums, 4 adds, 3 compares and 3 selects per
// state) and the shuffles and shared-memory accesses of the exchanges,
// which an SM serves at one warp instruction per cycle. The traceback reads
// the decisions once (its bytes bound: both 32-byte sectors of every row,
// since the maps read all 64 states) and is a chain of dependent picks,
// which the group maps below cut to one per 4 super-steps.
//
// viterbi_kernel: three layouts, picked by ops/viterbi_cuda.py::k12_layout
// from the batch B and the card's SMs (device ms on an NVIDIA H100 80GB
// HBM3: PERF.md section 6).
//   - One warp a codeword (kWarpLayout; forward_acs, below) for B up to
//     32 codewords an SM (4224 on 132 SMs): the FIC's 2048, `decode` and
//     `stream`. At a few codewords an SM the kernel is bound by the chain
//     of super-steps (~470 cycles each on an H100), not by issue, and a
//     layout with more work a thread only lengthens the chain.
//   - Radix-4 butterflies past that ("butterfly layouts" below;
//     forward_butterflies): two a thread (kBflyLayout; 8 states, 8 threads
//     a codeword, 4 codewords a warp) up to 48 codewords an SM, four
//     (kBfly4Layout; 16 states, 4 threads a codeword, 8 codewords a warp)
//     past that: the MSC's 12288. Both take 16 codewords a block. A thread
//     holds butterflies k0 ^ v for v in a subgroup of {0, 6, 11, 13}, sums
//     its own 8 branch metrics by a prefix tree (34 adds, no shuffle),
//     exchanges path metrics through shared memory in state order (a
//     16-byte store and 4 loads a butterfly) and stores one 32-bit
//     decision word a butterfly every 4 super-steps, at bytes 4k .. 4k + 3
//     of the same (B, T2p/4, 64) rows. The per-super-step work that one
//     warp a codeword pays once for 2 states (soft loads, shuffles,
//     exchange, loop, stores) is paid once for 8 or 16. After the forward
//     pass 16 threads of the block walk its 16 codewords (traceback_tree,
//     the byte picked by a shared load).
//   - The crossovers: warp / bfly 4224 codewords 0.763 / 0.793, 5120
//     1.138 / 0.913 at T2p 1744 (within 7% at T2p 400 from 3072 to 4224);
//     bfly / bfly4 at T2p 1744, 4608 0.678 / 0.751, 6656 0.880 / 0.780,
//     12288 1.274 / 1.124. Four butterflies need half the warps of two, so
//     at the MSC's 12288 an SM holds 12 warps (3 a scheduler) against 24:
//     they win by dispatching fewer instructions, not by hiding more
//     latency.
//   - SASS (sm_90a, bf16): one warp a codeword's inner group of 4
//     super-steps is 210 instructions (52.5 a codeword and super-step,
//     the soft staging not included); two butterflies' inner loop of 8
//     super-steps 1292 for a warp of 4 codewords (40.4 a codeword and
//     super-step, its staging included; 80 registers); four butterflies'
//     inner loop of 4 super-steps 1106 for a warp of 8 codewords (34.6,
//     the staging outside it): FFMA 392, FSETP 192, FMNMX 192, SEL 128,
//     LDS 72, IMAD 61, STS 16; 126 registers, no spills.
//   - What bounds them: dispatch, every class of instruction costing alike
//     (without the decisions, the tree or the exchange two butterflies ran
//     25%, 18% and 2% faster). The ~21 instructions a state and super-step
//     of two butterflies: 4 adds, 3 FMNMX, 3 FSETP, 2 SEL and ~1.3 IMAD for
//     the ACS and decisions, 4.25 for the tree, 1.25 for the exchange; four
//     pay the tree, the soft loads, the loop and the rebase once per 16
//     states, ~17 a state. The walk reads all decision rows once, ~0.1 ms
//     at the MSC's 343 MB.
//
// forward_acs: one warp per codeword, kWarps codewords per block.
//   - Lane l holds states 2l and 2l + 1, which have the same four
//     predecessors (l >> 1) | (j << 4). The path metrics are exchanged
//     through a per-warp double buffer in shared memory, laid out so that
//     a lane's four predecessors are one 16-byte chunk (pm_slot): two
//     stores, one __syncwarp and one load per super-step, no block-wide
//     barrier. The rebase by state 0 broadcasts lane 0's metric by a
//     shuffle.
//   - Branch metrics once per codeword and super-step. Of the 256
//     super-transitions only 32 sums differ up to sign (DAB's generators 1
//     and 4 are both 0133); lane l sums magnitude l in index order
//     (m = x0; m = m + s1*x1; ...; an FMA by +-1 rounds as the add of the
//     exact product), and each state takes its 4 by shuffles, signed in
//     the add to the path metric (fmaf(m, -1, pm) is exactly pm + (-m)).
//     Round-to-nearest is sign-symmetric, so the result is the plain
//     version's per-state sum bit for bit. A lane needs 4 magnitudes: state
//     2l + 1 takes state 2l's with j ^ 2. The table (ops/viterbi_cuda.py::
//     bm_table_on, built once per device from the sign table) gives each
//     lane its magnitude's signs, its 4 source lanes and 8 signs.
//   - Where the magnitudes are computed is the one thing the kernels
//     choose apart (the variants below): viterbi_kernel, thousands of
//     codewords and throughput-bound, computes step t's at step t
//     (`full`); viterbi_bits_kernel, at most a few hundred codewords with
//     about one warp per scheduler and so latency-bound, computes step
//     t+1's before step t's ACS (`prefetch`), which takes the sums off the
//     recursion's chain. Each was the faster of the schedules at its own
//     batches on an H100.
//   - Soft values are staged per 16 super-steps in shared memory, double-
//     buffered, the next chunk's global loads in flight while this one is
//     decoded. The transposed layout (T2p, 8, B) is staged by the whole
//     block (each row segment of kWarps codewords is one 32-byte sector:
//     8 f32 or 16 bf16 codewords), one __syncthreads per 16 super-steps.
//     The (B, T, 4) layout is staged by each warp for its own codeword (128
//     contiguous values, +1.0, the zero-input flush, past T), with
//     __syncwarp only. A codeword past B still takes part in every barrier
//     and stores nothing.
//   - Lane l packs its two states' 2-bit decisions over 4 super-steps
//     (step q in bits [6-2q, 8-2q) of each state's byte) into one uint16 at
//     bytes 2l, 2l + 1 of the group's 64-byte row in a global scratch
//     (B, T2p/4, 64). After its forward pass each warp walks its own
//     codeword's traceback from state 0 (see "Traceback" below): rows
//     staged by cp.async in a per-warp ring, each group's map of all 64
//     start states built off the chain, then one shuffle pick a group.
//
// The variants change only where the branch metrics come from and what is
// kept, so the differences between their times measure the parts:
//   full      magnitudes of step t computed at step t (the decode kernels'
//             forward);
//   nodec     the same ACS chain, no decision pack: a zero row is stored
//             per group, as tpudab's does (:94);
//   noacs     no recursion and no exchange: decision bit bm_j0 > bm_j1
//             from the branch metrics alone (tpudab's `not do_acs` branch,
//             which returns before `do_dec` is read, so its bmonly is this
//             kernel too); the branch metrics of j = 2, 3 go into a running
//             max, so that all four are computed, as tpudab's full
//             (256, B) product is;
//   prefetch  the magnitude of step t+1 computed into a register before
//             the ACS of step t (clamped at the staging chunk's end);
//   dbuf      the same through a per-warp double buffer in shared memory,
//             read back in place of the shuffles;
//   group4    the 4 super-steps' magnitudes of a group computed at the
//             group's start (gmm4, and X1's wide layout).
// The variant kernel also writes each state's final metric, (B, 64) f32
// (noacs: its running max), so that nvcc cannot delete a chain whose
// decisions are not stored. The rebase interval is a template parameter:
// 16 for the decode kernels (the _t path's chunk), 32, 16 or 4 for the
// tools, the TPU's chunk in each. int16 soft runs int16 metrics, whose
// adds wrap and are order-free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr int kLanes = 32;
constexpr int kStage = 16;               // super-steps of soft values staged at a time
constexpr int kSoft = 8;                 // mother soft bits per radix-2 super-step
constexpr int kTile = kStage * kSoft;    // soft values of a codeword per stage
constexpr int kPerLane = kTile / kLanes; // of them, loaded by each thread
constexpr int kBitsWarps = 4;            // codewords per block of viterbi_bits_kernel
constexpr unsigned kAll = 0xffffffffu;

enum Variant { kFull = 0, kNoDec = 1, kNoAcs = 2, kPrefetch = 3, kDbuf = 4, kGroup4 = 5 };
enum TbMode { kShuffle = 0, kMasked = 1, kTree = 2 };

// f32 path metrics for f32 and bf16 soft; int16 metrics with int16
// wrap-around for int16 soft (X3). mac(a, s, x) is a + s * x for s = +-1,
// rounded once: the product is exact, so it is the add of the signed term.
struct F32Metric {
  using M = float;
  static constexpr float kStart = -1e9f;
  __device__ static float mac(float a, float s, float x) { return fmaf(s, x, a); }
  __device__ static float mul(float s, float x) { return s * x; }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float shfl(float v, int src) { return __shfl_sync(kAll, v, src); }
  __device__ static float of(float x) { return x; }
  __device__ static float of(__nv_bfloat16 x) { return __bfloat162float(x); }
};

struct I16Metric {
  using M = int16_t;
  static constexpr int16_t kStart = -16000;
  __device__ static int16_t mac(int16_t a, int16_t s, int16_t x) { return (int16_t)(a + s * x); }
  __device__ static int16_t mul(int16_t s, int16_t x) { return (int16_t)(s * x); }
  __device__ static int16_t sub(int16_t a, int16_t b) { return (int16_t)(a - b); }
  __device__ static int16_t shfl(int16_t v, int src) {
    return (int16_t)__shfl_sync(kAll, (int)v, src);
  }
  __device__ static int16_t of(int16_t x) { return x; }
};

// Codewords per block on the transposed layout: one 32-byte sector of
// each (8, B) row.
template <typename T>
__host__ __device__ constexpr int transposed_warps() { return 32 / (int)sizeof(T); }

// Row stride of a warp's staged soft values: padded by 16 bytes, so that
// the block's staging stores spread over the banks.
template <typename M>
__host__ __device__ constexpr int x_stride() { return kTile + 16 / (int)sizeof(M); }

// This lane's part of the branch-metric table (2, 32) int32: row 0, bit i
// set where sign i of magnitude `lane` is -1; row 1, bits [5j, 5j+5) the
// lane holding the magnitude of super-transition (j << 6) | 2l, bit 20 + j
// its negation, bit 24 + j the negation of (j << 6) | (2l + 1), whose
// magnitude is that of ((j ^ 2) << 6) | 2l.
template <typename Mt>
struct LaneTable {
  using M = typename Mt::M;
  M msign[kSoft];
  int src[4];
  M sign0[4], sign1[4];
  __device__ LaneTable(const int* __restrict__ table, int lane) {
    const int ms = table[lane], sel = table[kLanes + lane];
#pragma unroll
    for (int i = 0; i < kSoft; ++i) msign[i] = ((ms >> i) & 1) ? (M)-1 : (M)1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      src[j] = (sel >> (5 * j)) & 31;
      sign0[j] = ((sel >> (20 + j)) & 1) ? (M)-1 : (M)1;
      sign1[j] = ((sel >> (24 + j)) & 1) ? (M)-1 : (M)1;
    }
  }
};

// The 8 soft values of one super-step from shared memory (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&x)[kSoft]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const int16_t* p, int16_t (&x)[kSoft]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = (int16_t)(w[k] & 0xffffu);
    x[2 * k + 1] = (int16_t)(w[k] >> 16);
  }
}

// The 4 path metrics of one 16-byte chunk of the exchange buffer.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const int16_t* p, int16_t (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = (int16_t)(a.x & 0xffffu); v[1] = (int16_t)(a.x >> 16);
  v[2] = (int16_t)(a.y & 0xffffu); v[3] = (int16_t)(a.y >> 16);
}

// Slot of `state` in a warp's path-metric exchange buffer. Chunk c holds
// states c, c + 16, c + 32, c + 48, the predecessors of states 4c..4c+3,
// so a lane reads its four in one load; even chunks take slots 0..7 and
// odd ones 8..15, so that the lanes' stores of states 2l (and of 2l + 1)
// fall on distinct banks.
__device__ __forceinline__ int pm_slot(int state) {
  const int c = state & 15;
  return 4 * ((c >> 1) | ((c & 1) << 3)) + (state >> 4);
}

// This lane's magnitude at one super-step: its signed soft values summed
// in index order.
template <typename Mt>
__device__ __forceinline__ typename Mt::M magnitude(const typename Mt::M* xs_step,
                                                    const LaneTable<Mt>& tb) {
  typename Mt::M x[kSoft];
  load8(xs_step, x);
  typename Mt::M m = x[0];
#pragma unroll
  for (int i = 1; i < kSoft; ++i) m = Mt::mac(m, tb.msign[i], x[i]);
  return m;
}

// Transposed (t2p, 8, b) soft: the block's kWarps codewords from cw0,
// staged by all its threads; a codeword past b reads 0.
template <typename T, typename Mt, int kWarps>
struct TransposedSoft {
  using M = typename Mt::M;
  const T* soft;
  int b, cw0;
  static __device__ void sync() { __syncthreads(); }
  __device__ void fetch(int t0, M (&r)[kPerLane]) const {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = threadIdx.x + k * kWarps * kLanes, row = e / kWarps, col = e % kWarps;
      r[k] = cw0 + col < b ? Mt::of(soft[((size_t)t0 * kSoft + row) * b + cw0 + col]) : (M)0;
    }
  }
  __device__ void put(const M (&r)[kPerLane], M* xs) const {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = threadIdx.x + k * kWarps * kLanes;
      xs[(e % kWarps) * x_stride<M>() + e / kWarps] = r[k];
    }
  }
};

// One codeword's (T, 4) mother soft bits, staged by its own warp; +1.0
// past T (n_vals = 4 * T; 0 for a warp past b).
template <typename T>
struct MotherSoft {
  const T* row;
  int n_vals;
  static __device__ void sync() { __syncwarp(); }
  __device__ void fetch(int t0, float (&r)[kPerLane]) const {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int idx = t0 * kSoft + (threadIdx.x & 31) + k * kLanes;
      r[k] = idx < n_vals ? F32Metric::of(row[idx]) : 1.f;
    }
  }
  __device__ void put(const float (&r)[kPerLane], float* xs) const {
    float* mine = xs + (threadIdx.x >> 5) * x_stride<float>();
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) mine[(threadIdx.x & 31) + k * kLanes] = r[k];
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

// 4-way compare-select of one state as pairwise strict > selects (ties
// keep the lower predecessor index): its new metric and 2-bit decision.
template <typename M>
__device__ __forceinline__ uint32_t acs(const M (&c)[4], M& v) {
  const bool d01 = c[1] > c[0];
  const M m01 = d01 ? c[1] : c[0];
  const bool d23 = c[3] > c[2];
  const M m23 = d23 ? c[3] : c[2];
  const bool dh = m23 > m01;
  v = dh ? m23 : m01;
  return dh ? (2u | (uint32_t)d23) : (uint32_t)d01;
}

// noacs: the decision bm_0 > bm_1 and the running max of bm_2, bm_3.
template <typename M>
__device__ __forceinline__ uint32_t bm_only(const M (&bm)[4], M& v) {
  const M m23 = bm[3] > bm[2] ? bm[3] : bm[2];
  v = m23 > v ? m23 : v;
  return bm[0] > bm[1];
}

template <typename M>
struct StatePair {
  M lo, hi;  // states 2l and 2l + 1
};

// Forward ACS of one codeword by one warp of kWarps over t2p super-steps
// (t2p % 16 == 0, t2p % kRebase == 0). Stores the packed decision rows to
// dcw (none when it is null: a codeword past the batch) and returns this
// lane's two final path metrics (noacs: their running maxima). Every warp
// of the block calls it, for the block-wide staging barrier.
template <int kVariant, typename Mt, int kRebase, int kWarps, typename Loader>
__device__ StatePair<typename Mt::M> forward_acs(const Loader& load,
                                                 const int* __restrict__ table, int t2p,
                                                 uint16_t* __restrict__ dcw) {
  using M = typename Mt::M;
  constexpr int kStride = x_stride<M>();
  __shared__ __align__(16) M xs[2][kWarps * kStride];
  __shared__ __align__(16) M pmx[kWarps][2][kStates];
  __shared__ M bmx[kVariant == kDbuf ? kWarps : 1][2][kLanes];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // where this lane reads its states' predecessors (l >> 1) + 16 j and
  // stores states 2l and 2l + 1
  const int rd = pm_slot(lane >> 1), wr0 = pm_slot(2 * lane), wr1 = pm_slot(2 * lane + 1);
  const LaneTable<Mt> tb(table, lane);

  M v0 = lane == 0 ? (M)0 : Mt::kStart, v1 = Mt::kStart;
  if (kVariant != kNoAcs) {
    pmx[w][0][wr0] = v0;
    pmx[w][0][wr1] = v1;
    __syncwarp();
  }
  uint32_t acc = 0;
  M r[kPerLane];
  load.fetch(0, r);

  for (int t0 = 0, chunk = 0; t0 < t2p; t0 += kStage, ++chunk) {
    // one barrier per chunk: the buffer written here was last read two
    // chunks ago, before the last chunk's barrier
    load.put(r, xs[chunk & 1]);
    Loader::sync();
    if (t0 + kStage < t2p) load.fetch(t0 + kStage, r);  // in flight during the chunk
    const M* xw = xs[chunk & 1] + w * kStride;
    M m_next, mg[4];
    if (kVariant == kPrefetch) m_next = magnitude(xw, tb);
    if (kVariant == kDbuf) {
      bmx[w][0][lane] = magnitude(xw, tb);
      __syncwarp();
    }
    // groups of 4 super-steps, each unrolled, so that the step within the
    // group (u) and every register and buffer index are compile-time
    for (int g4 = 0; g4 < kStage; g4 += 4) {
      if (kVariant == kGroup4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) mg[u] = magnitude(xw + (g4 + u) * kSoft, tb);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = g4 + u;
        const M* x_next = xw + (q + 1 < kStage ? q + 1 : kStage - 1) * kSoft;
        M g[4];  // the magnitudes of state 2l's super-transitions j
        if (kVariant == kDbuf) {
          // written here, read at the next step behind its __syncwarp
          bmx[w][(u + 1) & 1][lane] = magnitude(x_next, tb);
#pragma unroll
          for (int j = 0; j < 4; ++j) g[j] = bmx[w][u & 1][tb.src[j]];
        } else {
          M m;
          if (kVariant == kPrefetch) {
            m = m_next;
            m_next = magnitude(x_next, tb);
          } else if (kVariant == kGroup4) {
            m = mg[u];
          } else {
            m = magnitude(xw + q * kSoft, tb);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) g[j] = Mt::shfl(m, tb.src[j]);
        }

        uint32_t d0, d1;
        if (kVariant == kNoAcs) {
          M b0[4], b1[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b0[j] = Mt::mul(tb.sign0[j], g[j]);
            b1[j] = Mt::mul(tb.sign1[j], g[j ^ 2]);
          }
          d0 = bm_only(b0, v0);
          d1 = bm_only(b1, v1);
        } else {
          M p[4], c0[4], c1[4];
          load4(&pmx[w][u & 1][rd], p);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            c0[j] = Mt::mac(p[j], tb.sign0[j], g[j]);
            c1[j] = Mt::mac(p[j], tb.sign1[j], g[j ^ 2]);
          }
          d0 = acs(c0, v0);
          d1 = acs(c1, v1);
        }
        if (kVariant != kNoDec) acc |= (d0 << (6 - 2 * u)) | (d1 << (14 - 2 * u));
        if (u == 3) {
          if (dcw) dcw[(size_t)((t0 + q) >> 2) * kLanes + lane] = (uint16_t)acc;
          acc = 0;
        }
        if (kVariant == kNoAcs) continue;
        if (rebase_after<kRebase>(t0, g4, u)) {
          // rebase by pm[0]: decisions are unchanged, metrics stay bounded
          const M base = Mt::shfl(v0, 0);
          v0 = Mt::sub(v0, base);
          v1 = Mt::sub(v1, base);
        }
        // read at the next step behind this __syncwarp; every lane read this
        // buffer at the last step, before the last step's __syncwarp
        pmx[w][(u + 1) & 1][wr0] = v0;
        pmx[w][(u + 1) & 1][wr1] = v1;
        __syncwarp();
      }
    }
  }
  __syncwarp();  // this warp's decision rows are visible to all its lanes
  return {v0, v1};
}

// ---- Traceback ---------------------------------------------------------
//
// Group maps. A group's walk of 4 super-steps from a start state s depends
// only on the group's 64-byte row: q = 3 reads j3 = row[s] & 3 and the
// byte it emits is s | (j3 << 6) (the 2-bit shifts of the state carry s's
// own bits into the byte's bits 0-5), and the state 4 super-steps back is reached by
// three more reads, each at the state the last one made. So each lane
// builds, for its states 2l and 2l + 1, an 8-bit map entry, next state
// (bits 0-5) | j3 (bits 6-7), from the staged row in shared memory, with no
// reference to the traceback's own state: the maps of a stage of groups are
// built ahead while the chain walks the stage before. The chain is then one
// pick a group, S -> entry[S] of the lane pair holding S (a warp shuffle from
// lane S >> 1 and a select on S & 1), and emits S | (entry & 0xc0). It is
// function composition, exact by construction, ties included.
//
// Staging. A codeword's rows are contiguous (groups x 64 bytes). Each warp
// keeps a ring of kStages stages of kTbGroups rows in shared memory, filled
// backward from the last group by cp.async (16 bytes a lane, one stage a
// warp instruction): while the maps of stage k + 1 are built and stage k is
// walked, stages up to k + kStages are in flight, so DRAM latency is paid
// about once per codeword. A stage below group 0 copies nothing.
//
// Output. Lane l keeps the byte of every group g = l (mod 32), in one of
// two registers by the parity of g / 32, and a warp flushes a window of 32
// groups once the chain has passed its first group: 32 consecutive bytes
// (K2, the tools), or 256 bytes of one bit a byte (K3), each lane's 8 as
// one 8-byte store where aligned; the n_out tail is masked.

constexpr int kTbGroups = 8;                        // rows a stage: 512 bytes
constexpr int kTbStages = 4;                        // stages in a warp's ring, by default
constexpr int kTreeRing = 8;                        // rows in a tree thread's ring
constexpr int kTreeStride = kTreeRing * kStates + 16;      // its bytes, padded

// Shared memory by 32-bit shared-window addresses (ld.shared, not generic
// loads with 64-bit address arithmetic), volatile so that no read moves
// above the cp.async wait that makes its row visible.
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t lds_u8(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row byte of `state` (in its low 8 bits) in a group's 64 decision bytes,
// or the 8-bit map entry of `state`, which the warp holds in lanes (bytes
// or entries 2*lane and 2*lane + 1 in the low 16 bits of w): by a warp
// shuffle, or by tpudab's pre-r5 masked sum over the 64 rows.
template <int kMode>
__device__ __forceinline__ uint32_t row_byte(uint32_t w, int state, int lane) {
  if constexpr (kMode == kShuffle) {
    const uint32_t v = __shfl_sync(kAll, w, state >> 1);
    return (state & 1) ? (v >> 8) : v;
  } else {
    uint32_t hit = (2 * lane == state ? (w & 0xffu) : 0u) +
                   (2 * lane + 1 == state ? ((w >> 8) & 0xffu) : 0u);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hit += __shfl_xor_sync(kAll, hit, o);
    return hit;
  }
}

// Byte t of a staged row, as the map build reads it at step q (t's j in
// bits 4-5): shuffle reads it; masked sums the 4 bytes the walk can reach
// from t & 15 (t & 15 | j << 4, j = 0..3), each masked by j's match.
template <int kMode>
__device__ __forceinline__ uint32_t map_pick(uint32_t row, int t) {
  if constexpr (kMode == kShuffle) {
    return lds_u8(row + t);
  } else {
    const int a = t & 15, j = t >> 4;
    uint32_t hit = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) hit += lds_u8(row + a + 16 * i) & (0u - (uint32_t)(i == j));
    return hit;
  }
}

// This lane's map entries of one staged row (at shared address row): state
// 2l in bits 0-7, state 2l + 1 in bits 8-15 (next state | j3 << 6).
template <int kMode>
__device__ __forceinline__ uint32_t group_map(uint32_t row, int lane) {
  const uint32_t own = lds_u16(row + 2 * lane);
  uint32_t m = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t j3 = (own >> (8 * h)) & 3;
    int t = (lane >> 1) | (int)(j3 << 4);             // (2l + h) >> 2 | j3 << 4
#pragma unroll
    for (int q = 2; q >= 0; --q)
      t = (t >> 2) | (int)(((map_pick<kMode>(row, t) >> (6 - 2 * q)) & 3) << 4);
    m |= ((uint32_t)t | (j3 << 6)) << (8 * h);
  }
  return m;
}

// The 8 decoded bits of a byte, MSB first, one a byte (little-endian u64).
__device__ __forceinline__ unsigned long long bits_of(uint32_t byte) {
  unsigned long long v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) v |= (unsigned long long)((byte >> (7 - k)) & 1) << (8 * k);
  return v;
}

// Store of group g's byte (bytes out) or its 8 bits (kBits), for what lies
// below n_out: one 8-byte store where whole and aligned.
template <bool kBits>
__device__ __forceinline__ void put_group(uint8_t* __restrict__ ocw, int g, uint32_t byte,
                                          int n_out) {
  if (!kBits) {
    if (g < n_out) ocw[g] = (uint8_t)byte;
    return;
  }
  const unsigned long long v = bits_of(byte);
  uint8_t* p = ocw + 8 * (size_t)g;
  if (8 * g + 8 <= n_out && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<unsigned long long*>(p) = v;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (8 * g + k < n_out) p[k] = (uint8_t)(v >> (8 * k));
  }
}

// Bytes of a warp's ring of kStages stages.
template <int kStages>
__host__ __device__ constexpr int tb_ring() { return kStages * kTbGroups * kStates; }

// Traceback from state 0 by one warp over `groups` packed decision rows
// (dcw: 16-byte aligned), through the warp's ring (tb_ring<kStages>() bytes
// of shared memory, 16-byte aligned). kBits: one 0/1 byte per decoded bit,
// for bits < n_out (K3); otherwise one MSB-first byte per 4 super-steps,
// for bytes < n_out (K2). Not inlined: in the decode kernels it runs after
// the forward pass under the same 64-register bound, and a call keeps its
// registers apart from the forward pass's.
template <bool kBits, int kMode = kShuffle, int kStages = kTbStages>
__device__ __noinline__ void traceback(const uint8_t* __restrict__ dcw, int groups,
                          uint8_t* __restrict__ ocw, int n_out, uint8_t* ring) {
  static_assert(kStages >= 2, "a stage is read while the next lands");
  const int lane = threadIdx.x & 31;
  const int stages = (groups + kTbGroups - 1) / kTbGroups;
  const uint32_t ring_s = shared_addr(ring);
  // stage k: rows base(k) + u, u < kTbGroups, base(k) = groups - kTbGroups (k + 1);
  // lane l copies bytes [16 (l & 3), +16) of row u = l >> 2
  auto fetch = [&](int k) {
    const int g = groups - kTbGroups * (k + 1) + (lane >> 2);
    if (k < stages && g >= 0)
      cp_async16(ring_s + (k % kStages) * kTbGroups * kStates + 16 * lane,
                 dcw + (size_t)g * kStates + 16 * (lane & 3));
    cp_async_commit();
  };
  // two groups' entries a register (row u in bits 16 (u & 1)): 64 registers
  // hold the forward pass of the decode kernels, and these are live beside
  // its values
  auto maps = [&](int k, uint32_t (&m)[kTbGroups / 2]) {
    const uint32_t slot = ring_s + (k % kStages) * kTbGroups * kStates;
#pragma unroll
    for (int u = 0; u < kTbGroups; u += 2)
      m[u / 2] = group_map<kMode>(slot + u * kStates, lane) |
                 (group_map<kMode>(slot + (u + 1) * kStates, lane) << 16);
  };
#pragma unroll
  for (int k = 0; k < kStages; ++k) fetch(k);
  cp_async_wait<kStages - 1>();
  __syncwarp();
  uint32_t next[kTbGroups / 2], cur[kTbGroups / 2];
  maps(0, next);
  int state = 0;
  uint32_t keep0 = 0, keep1 = 0;   // this lane's bytes of the windows of even / odd g >> 5
  for (int k = 0; k < stages; ++k) {
    // every lane has read stage k's slot (maps(k)), which this refills
    __syncwarp();
    fetch(k + kStages);
    cp_async_wait<kStages - 1>();     // stage k + 1 has landed for this lane
    __syncwarp();                     // ... and for every lane
#pragma unroll
    for (int u = 0; u < kTbGroups / 2; ++u) cur[u] = next[u];
    maps(k + 1, next);                // off the chain (stale past the last stage)
    const int base = groups - kTbGroups * (k + 1);
#pragma unroll
    for (int u = kTbGroups - 1; u >= 0; --u) {
      const int g = base + u;
      const uint32_t e = row_byte<kMode>(cur[u / 2] >> (16 * (u & 1)), state, lane);
      const uint32_t byte = (uint32_t)state | (e & 0xc0u);
      if (g >= 0) {                   // the last stage's rows below 0 are not walked
        if (lane == (g & 31)) {
          if ((g >> 5) & 1) keep1 = byte;
          else keep0 = byte;
        }
        state = (int)(e & 63u);
      }
    }
    // flush the window of 32 groups whose first group this stage walked
    const int lo = base > 0 ? base : 0, w = (base + kTbGroups - 1) >> 5;
    if (32 * w >= lo) {
      const int g = 32 * w + lane;
      if (g < groups) put_group<kBits>(ocw, g, (w & 1) ? keep1 : keep0, n_out);
    }
  }
}

// The same by one thread, bytes out. Rows come through the thread's own
// ring of kTreeRing rows in shared memory (kTreeStride bytes, padded so
// that a quarter warp's 16-byte reads fall on distinct banks), filled by
// cp.async kTreeRing - 1 rows ahead. The state's byte is one load from the
// staged row, 4 dependent loads a group: on an H100 no slower than
// tools/exp_tb_tree.py::_tb_kernel_tree's 6-level binary select over the
// row held in 16 registers (~70 selects a group; (6144, 448, 64) rows,
// 0.1130 against 0.1164 ms), and faster where 96 walks share an SM
// (viterbi_kernel's butterfly layout). Bytes are kept 4 groups to a word
// and stored as one word where aligned.
__device__ void traceback_tree(const uint8_t* __restrict__ dcw, int groups,
                               uint8_t* __restrict__ ocw, int n_out, uint8_t* ring) {
  const uint32_t ring_s = shared_addr(ring);
  auto fetch = [&](int g) {
    if (g >= 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cp_async16(ring_s + (g % kTreeRing) * kStates + 16 * c, dcw + (size_t)g * kStates + 16 * c);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int d = 1; d < kTreeRing; ++d) fetch(groups - d);
  int state = 0;
  uint32_t word = 0;
  for (int g = groups - 1; g >= 0; --g) {
    fetch(g - (kTreeRing - 1));
    cp_async_wait<kTreeRing - 1>();   // row g has landed
    const uint32_t row = ring_s + (g % kTreeRing) * kStates;
    uint32_t byte = 0;
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      const int j = (lds_u8(row + state) >> (6 - 2 * q)) & 3;
      byte |= (uint32_t)(state & 3) << (6 - 2 * q);
      state = (state >> 2) | (j << 4);
    }
    word |= byte << (8 * (g & 3));
    if ((g & 3) == 0) {
      uint8_t* p = ocw + g;
      if (g + 4 <= n_out && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(p) = word;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (g + k < n_out) p[k] = (uint8_t)(word >> (8 * k));
      }
      word = 0;
    }
  }
}

// ---- viterbi_kernel's butterfly layouts -------------------------------
//
// A radix-4 butterfly: old states k, k + 16, k + 32, k + 48 go to new
// states 4k .. 4k + 3 (k < 16). Super-transition reg = (j << 6) | 4k | i
// (state 4k + i, predecessor j) sends soft value n with the sign
// (-1)^parity(kGenMasks byte n & reg). The code is linear, so for a thread
// whose butterflies are k0 ^ v, v in V = {0, 6, 11, 13} (a subgroup under
// XOR, whose four cosets split the 16 butterflies evenly), the signs split
// into the thread's own t_n = the sign of n in 4 k0 (registers) and the
// sign of (j << 6) | 4v | i (compile-time). The 64 super-transitions of the
// four butterflies take 8 distinct index-order sums up to sign: 34 adds of
// a prefix tree a thread and super-step, and no shuffle. A thread holds
// kBfly of them: 2 (v = 0, 6; kBflyLayout) or all 4 (kBfly4Layout).

// Byte n: the mask of soft value n's sign bit in the 8-bit super-transition
// register (DAB's generators 0133, 0171, 0145, 0133 over two trellis steps);
// tests/test_torch_k12_layout.py holds it to radix_tables()[0].
constexpr unsigned long long kGenMasks = 0x6d534f6ddaa69edaull;
constexpr int kCoset = 0xdb60;           // V, a nibble each: v_w = 0, 6, 11, 13
constexpr int kBflyCw = 16;              // codewords a block

__host__ __device__ constexpr int coset_offset(int w) { return (kCoset >> (4 * w)) & 15; }
__host__ __device__ constexpr int parity8(int x) {
  return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5) ^ (x >> 6) ^ (x >> 7)) & 1;
}
// 1 where soft value n enters super-transition reg negated
__host__ __device__ constexpr int sign_bit(int n, int reg) {
  return parity8((int)((kGenMasks >> (8 * n)) & 0xffu) & reg);
}

// Where a butterfly layout's threads sit: kBfly butterflies (4 kBfly
// states) a thread, kTpc threads a codeword, kBflyCw codewords a block.
// Thread r of a codeword holds butterflies base(r) ^ v_w, w < kBfly, and
// its codeword's exchange buffer is kPm floats; the thread map, base and
// kPm are chosen together so that a warp's 16-byte exchange stores (a
// quarter warp at a time) and its scalar loads fall on distinct banks.
//   - kBfly 2: lanes 8c + r (4 codewords a warp), base(r) one of each pair
//     {k, k ^ 6}, kPm 72.
//   - kBfly 4: lanes c + 8r (8 codewords a warp), base(r) = r, kPm 68 (17
//     16-byte units, odd): a quarter warp's stores are 8 codewords of one r,
//     at units 17c + k, distinct mod 8; a warp's loads k + 16j + 68c, with
//     k = r ^ v distinct mod 4 over r and 68c = 4c (mod 32), cover the 32
//     banks.
template <int kBfly>
struct BflyMap {
  static_assert(kBfly == 2 || kBfly == 4, "two or four butterflies a thread");
  static constexpr int kTpc = 16 / kBfly;
  static constexpr int kThreads = kBflyCw * kTpc;
  static constexpr int kPm = kBfly == 2 ? 72 : 68;
  // super-steps a pass of the inner loop: at (12288, 1744) the four
  // butterflies took 1.124 ms at 4 and 1.26 at 8 (NVIDIA H100 80GB HBM3)
  static constexpr int kSteps = kBfly == 2 ? 8 : 4;
  __device__ static int cw(int x) { return kBfly == 2 ? x / 8 : (x >> 5) * 8 + (x & 7); }
  __device__ static int r(int x) { return kBfly == 2 ? x % 8 : (x & 31) >> 3; }
  __device__ static int base(int r) { return kBfly == 2 ? r | ((r & 4) << 1) : r; }
  // the lane of thread 0 of lane's codeword
  __device__ static int lane0(int lane) { return kBfly == 2 ? lane & ~7 : lane & 7; }
};

// A thread's branch metrics as a prefix tree over its 8 index-order sums
// (patterns: bit n set where soft value n is negated, normalised so that
// bit 0 is clear). Level n holds the distinct prefixes of n + 1 signs;
// level 7 the 8 sums.
struct BmTree {
  int count[kSoft];               // nodes at level n
  int parent[kSoft][kSoft];       // node q of level n: its prefix at level n - 1
  int neg[kSoft][kSoft];          // ... and whether soft value n enters it negated
  int mag[4][4][4];               // [w][i][j]: the sum of state 4k + i, pred j
  int flip[4][4][4];              // ... and whether the branch metric is its negation
};

__host__ __device__ constexpr BmTree bm_tree() {
  BmTree t{};
  int pats[kSoft] = {};
  int np = 0;
  for (int w = 0; w < 4; ++w)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int reg = (j << 6) | (4 * coset_offset(w)) | i, s0 = sign_bit(0, reg);
        int pat = 0;
        for (int n = 1; n < kSoft; ++n) pat |= (sign_bit(n, reg) ^ s0) << n;
        int q = 0;
        while (q < np && pats[q] != pat) ++q;
        if (q == np && np < kSoft) pats[np++] = pat;
        t.mag[w][i][j] = q;       // kSoft where a 9th sum would be: bm_tree_ok() fails
        t.flip[w][i][j] = s0;
      }
  int prev[kSoft] = {}, cur[kSoft] = {};
  int nprev = 1;                  // level 0: x0 alone
  t.count[0] = 1;
  for (int n = 1; n < kSoft; ++n) {
    const int keep = (2 << n) - 1;
    int nc = 0;
    for (int p = 0; p < np; ++p) {
      const int pre = pats[p] & keep;
      int q = 0;
      while (q < nc && cur[q] != pre) ++q;
      if (q == nc) {
        cur[nc] = pre;
        int par = 0;
        while (par < nprev && prev[par] != (pre & (keep >> 1))) ++par;
        t.parent[n][nc] = par;
        t.neg[n][nc] = (pre >> n) & 1;
        ++nc;
      }
    }
    t.count[n] = nc;
    for (int q = 0; q < nc; ++q) prev[q] = cur[q];
    nprev = nc;
  }
  return t;
}

__host__ __device__ constexpr bool bm_tree_ok() {
  const BmTree t = bm_tree();
  for (int w = 0; w < 4; ++w)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        if (t.mag[w][i][j] >= kSoft) return false;
  return t.count[kSoft - 1] == kSoft;
}
static_assert(bm_tree_ok(), "the four butterflies of a coset of V take 8 distinct sums");

// The block's kBflyCw codewords from cw0 of (t2p, 8, b) soft values,
// staged by its kThreads threads in halves of a chunk (8 super-steps each):
// thread x reads codeword cw0 + x % 16 in rows x / 16 + kRows k (a 32-byte
// sector of a bf16 row per 16 threads) and writes them to that codeword's
// row of the buffer; a codeword past b reads codeword cw0's (finite values;
// it stores nothing). The loads are unconditional and kept raw until put()
// converts them, so that a half chunk's loads are all in flight at once and
// nothing waits on them before put(): loads under a select, each converted
// at once, kept the butterflies waiting on device memory one load at a time
// (at (12288, 1744) two butterflies 1.45 ms against 1.28, four, 8
// super-steps a pass, 1.62 against 1.24; NVIDIA H100 80GB HBM3).
template <typename T, int kThreads>
struct BlockSoft {
  static constexpr int kRows = kThreads / kBflyCw;
  static constexpr int kHalf = kTile / kRows / 2;
  const T* src;        // this thread's next row
  size_t step;         // elements between its rows
  int dst;             // its first slot in the buffer
  __device__ BlockSoft(const T* soft, int b, int cw0) {
    const int col = (int)(threadIdx.x % kBflyCw), row = (int)(threadIdx.x / kBflyCw);
    src = soft + (size_t)row * b + (cw0 + col < b ? cw0 + col : cw0);
    step = (size_t)kRows * b;
    dst = col * x_stride<float>() + row;
  }
  // the next half chunk, in flight until put()
  __device__ void fetch(T (&r)[kHalf]) {
#pragma unroll
    for (int k = 0; k < kHalf; ++k, src += step) r[k] = *src;
  }
  __device__ void put(const T (&r)[kHalf], float* xs, int half) const {
#pragma unroll
    for (int k = 0; k < kHalf; ++k) xs[dst + (half * kHalf + k) * kRows] = F32Metric::of(r[k]);
  }
};

// The 8 index-order sums of one super-step's soft values at xp (16-byte
// aligned) by the thread's prefix tree (signs u): a level from the last,
// one add a node.
__device__ __forceinline__ void tree_sums(const float* xp, const float (&u)[kSoft],
                                          float (&lvl)[kSoft]) {
  constexpr BmTree kT = bm_tree();
  float x[kSoft], nxt[kSoft];
  load8(xp, x);
  lvl[0] = x[0];
#pragma unroll
  for (int n = 1; n < kSoft; ++n) {
#pragma unroll
    for (int c = 0; c < kSoft; ++c)
      if (c < kT.count[n]) nxt[c] = fmaf(kT.neg[n][c] ? -u[n] : u[n], x[n], lvl[kT.parent[n][c]]);
#pragma unroll
    for (int c = 0; c < kSoft; ++c)
      if (c < kT.count[n]) lvl[c] = nxt[c];
  }
}

// Forward ACS of the block's kBflyCw codewords over t2p super-steps (t2p %
// 16 == 0), kBfly butterflies (4 kBfly states) a thread, f32 metrics
// rebased by state 0 every 16. Thread r of a codeword holds butterflies
// k0 ^ v_w (k0 = BflyMap::base(r)); every 4 super-steps it stores one
// 32-bit word a butterfly (states 4k .. 4k + 3: bytes 4k .. 4k + 3 of the
// group's row) to dcw (none when null). Path metrics go through a
// per-codeword double buffer in shared memory in state order: a
// butterfly's 4 new metrics are one 16-byte store, its 4 predecessors 4
// loads, one __syncwarp a super-step. xs: the staging buffer (2 chunks),
// pmx: the exchange buffers. Every thread of the block calls it, for the
// staging barrier. The inner loop runs Map::kSteps super-steps a pass, the
// staging of the next chunk's halves between its passes.
template <typename T, int kBfly>
__device__ void forward_butterflies(const T* __restrict__ soft, int b, int cw0, int t2p,
                                    uint8_t* __restrict__ dcw, float* xs, float* pmx) {
  using Map = BflyMap<kBfly>;
  constexpr int kXs = kBflyCw * x_stride<float>(), kBuf = kBflyCw * Map::kPm;
  constexpr int kSteps = Map::kSteps;
  static_assert(kSteps % 4 == 0 && (kStage / 2) % kSteps == 0, "whole groups of 4 a pass");
  constexpr BmTree kT = bm_tree();
  BlockSoft<T, Map::kThreads> load(soft, b, cw0);
  const int x = (int)threadIdx.x, cwl = Map::cw(x), k0 = Map::base(Map::r(x));
  const int lane0 = Map::lane0(x & 31);
  float* const pm_own = pmx + cwl * Map::kPm;
  // this thread's signs: u_n = t_n t_0 for the tree, t_0 for the branch metric
  float u[kSoft];
#pragma unroll
  for (int n = 0; n < kSoft; ++n) u[n] = (sign_bit(n, 4 * k0) ^ sign_bit(0, 4 * k0)) ? -1.f : 1.f;
  const float t0s = sign_bit(0, 4 * k0) ? -1.f : 1.f;

  float v[kBfly][4];
#pragma unroll
  for (int w = 0; w < kBfly; ++w) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[w][i] = (k0 ^ coset_offset(w)) == 0 && i == 0 ? 0.f : F32Metric::kStart;
    *reinterpret_cast<float4*>(pm_own + 4 * (k0 ^ coset_offset(w))) =
        make_float4(v[w][0], v[w][1], v[w][2], v[w][3]);
  }
  uint32_t acc[kBfly];
  T rbuf[BlockSoft<T, Map::kThreads>::kHalf];
  load.fetch(rbuf);
  load.put(rbuf, xs, 0);
  load.fetch(rbuf);
  load.put(rbuf, xs, 1);

  for (int t0 = 0, chunk = 0; t0 < t2p; t0 += kStage, ++chunk) {
    // this chunk is staged, and every thread is done with the other buffer
    __syncthreads();
    const bool more = t0 + kStage < t2p;
    if (more) load.fetch(rbuf);   // the next chunk's first half, in flight
    const float* xw = xs + (chunk & 1) * kXs + cwl * x_stride<float>();
    float* xn = xs + ((chunk + 1) & 1) * kXs;
#pragma unroll 1
    for (int h = 0; h < kStage; h += kStage / 2) {
      if (h && more) {
        load.put(rbuf, xn, 0);
        load.fetch(rbuf);
      }
#pragma unroll 1
      for (int q0 = h; q0 < h + kStage / 2; q0 += kSteps) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int q = q0 + s;
          float lvl[kSoft];
          tree_sums(xw + q * kSoft, u, lvl);
          const float* rd = pm_own + (s & 1) * kBuf;
#pragma unroll
          for (int w = 0; w < kBfly; ++w) {
            const int k = k0 ^ coset_offset(w);
            float p[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) p[j] = rd[k + 16 * j];
            uint32_t d = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float c[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                c[j] = fmaf(kT.flip[w][i][j] ? -t0s : t0s, lvl[kT.mag[w][i][j]], p[j]);
              // pairwise strict > (ties keep the lower j); fmaxf gives the
              // selected value, as no candidate is -0 or NaN
              const bool d01 = c[1] > c[0], d23 = c[3] > c[2];
              const float m01 = fmaxf(c[0], c[1]), m23 = fmaxf(c[2], c[3]);
              const bool dh = m23 > m01;
              v[w][i] = fmaxf(m01, m23);
              d |= (dh ? (d23 ? 3u : 2u) : (d01 ? 1u : 0u)) << (8 * i);
            }
            // step q's decision in bits [6 - 2 (q & 3), 8 - 2 (q & 3)) of its byte
            acc[w] = (s & 3 ? acc[w] * 4u : 0u) + d;
          }
          if (s == kSteps - 1 && q == kStage - 1) {
            // rebase by state 0 (thread 0 of the codeword, butterfly 0, i = 0)
            const float base = __shfl_sync(kAll, v[0][0], lane0);
#pragma unroll
            for (int w = 0; w < kBfly; ++w)
#pragma unroll
              for (int i = 0; i < 4; ++i) v[w][i] = __fsub_rn(v[w][i], base);
          }
          // read at the next step behind this __syncwarp; every thread of the
          // codeword read this buffer at the last step, before its __syncwarp
          float* wr = pm_own + ((s + 1) & 1) * kBuf;
#pragma unroll
          for (int w = 0; w < kBfly; ++w)
            *reinterpret_cast<float4*>(wr + 4 * (k0 ^ coset_offset(w))) =
                make_float4(v[w][0], v[w][1], v[w][2], v[w][3]);
          __syncwarp();
          if ((s & 3) == 3 && dcw) {
            uint8_t* row = dcw + (size_t)((t0 + q) >> 2) * kStates;
#pragma unroll
            for (int w = 0; w < kBfly; ++w)
              *reinterpret_cast<uint32_t*>(row + 4 * (k0 ^ coset_offset(w))) = acc[w];
          }
        }
      }
    }
    if (more) load.put(rbuf, xn, 1);
  }
}

// Blocks of kWarps warps, launch-bounded to 32 resident warps per SM (64
// registers a thread).
#define TPUDAB_WARPS_BOUNDS(W) __launch_bounds__((W) * kLanes, 1024 / ((W) * kLanes))

// Traceback ring stages of a decode kernel of kWarps warps: 2 where 4
// would take the block past 48 KB of static shared memory (bf16, 16 warps).
__host__ __device__ constexpr int decode_tb_stages(int warps) { return warps > 8 ? 2 : kTbStages; }

// traceback_tree, not inlined: its registers stay apart from the forward
// pass's.
__device__ __noinline__ void walk_tree(const uint8_t* __restrict__ dcw, int groups,
                                       uint8_t* __restrict__ ocw, int n_out, uint8_t* ring) {
  traceback_tree(dcw, groups, ocw, n_out, ring);
}

// viterbi_kernel's thread layouts (ops/viterbi_cuda.py::K12_LAYOUTS names
// them, ::k12_layout picks one from the batch): kWarpLayout, one warp a
// codeword (forward_acs and the warp's shuffle traceback); kBflyLayout and
// kBfly4Layout, two and four butterflies a thread (forward_butterflies,
// then traceback_tree by one thread a codeword). A butterfly layout's id is
// its butterflies a thread.
constexpr int kWarpLayout = 0, kBflyLayout = 2, kBfly4Layout = 4;
__host__ __device__ constexpr int k12_codewords(int layout, int warps) {
  return layout == kWarpLayout ? warps : kBflyCw;
}
__host__ __device__ constexpr int k12_threads(int layout, int warps) {
  return layout == kWarpLayout ? warps * kLanes : kBflyCw * 16 / layout;
}
// The four butterflies keep a batch of kWaveB codewords on kWaveSms SMs in
// one wave: the MSC's coding group of 12288 on an H100 SXM's 132 SMs,
// ceil(12288 / 132) = 94 codewords resident an SM.
constexpr int kWaveB = 12288, kWaveSms = 132;
__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
// resident blocks an SM: 32 warps (64 registers) for one warp a codeword,
// 24 (80 registers) for two butterflies a thread, and for four the blocks
// that hold ceil(kWaveB / kWaveSms) codewords (6 of 16: 12 warps, up to 168
// registers)
__host__ __device__ constexpr int k12_min_blocks(int layout, int warps) {
  return layout == kWarpLayout   ? 1024 / (warps * kLanes)
         : layout == kBflyLayout ? 768 / k12_threads(layout, warps)
                                 : ceil_div(ceil_div(kWaveB, kWaveSms), kBflyCw);
}

template <typename T, int kLayout>
__global__ void __launch_bounds__(k12_threads(kLayout, transposed_warps<T>()),
                                  k12_min_blocks(kLayout, transposed_warps<T>()))
viterbi_kernel(const T* __restrict__ soft, const int* __restrict__ table,
               uint8_t* __restrict__ dec, uint8_t* __restrict__ out,
               int t2p, int b, int n_out) {
  const size_t rows = (size_t)(t2p / 4) * kStates;
  if constexpr (kLayout == kWarpLayout) {
    constexpr int kWarps = transposed_warps<T>();
    constexpr int kRing = tb_ring<decode_tb_stages(kWarps)>();
    __shared__ __align__(16) uint8_t ring[kWarps * kRing];
    const int cw0 = blockIdx.x * kWarps, cw = cw0 + (int)(threadIdx.x >> 5);
    uint8_t* dcw = dec + (size_t)cw * rows;
    forward_acs<kFull, F32Metric, kStage, kWarps>(
        TransposedSoft<T, F32Metric, kWarps>{soft, b, cw0}, table, t2p,
        cw < b ? reinterpret_cast<uint16_t*>(dcw) : nullptr);
    if (cw < b)
      traceback<false, kShuffle, decode_tb_stages(kWarps)>(
          dcw, t2p / 4, out + (size_t)cw * n_out, n_out, ring + (threadIdx.x >> 5) * kRing);
  } else {
    constexpr int kBfly = kLayout;
    constexpr int kXs = kBflyCw * x_stride<float>();
    static_assert(kBflyCw * kTreeStride <= (int)sizeof(float) * 2 * kXs,
                  "the traceback's rings fit in the staging buffer");
    __shared__ __align__(16) float xs[2 * kXs];
    __shared__ __align__(16) float pmx[2 * kBflyCw * BflyMap<kBfly>::kPm];
    const int cw0 = blockIdx.x * kBflyCw, cw = cw0 + BflyMap<kBfly>::cw((int)threadIdx.x);
    forward_butterflies<T, kBfly>(
        soft, b, cw0, t2p, cw < b ? dec + (size_t)cw * rows : nullptr, xs, pmx);
    // every warp's decision rows are written, and every warp is done with
    // the staging buffer, which holds the rings: thread c walks codeword
    // cw0 + c
    __syncthreads();
    const int c = cw0 + (int)threadIdx.x;
    if (threadIdx.x < kBflyCw && c < b)
      walk_tree(dec + (size_t)c * rows, t2p / 4, out + (size_t)c * n_out, n_out,
                reinterpret_cast<uint8_t*>(xs) + threadIdx.x * kTreeStride);
  }
}

template <typename T>
__global__ void TPUDAB_WARPS_BOUNDS(kBitsWarps)
viterbi_bits_kernel(const T* __restrict__ soft, const int* __restrict__ table,
                    uint8_t* __restrict__ dec, uint8_t* __restrict__ out,
                    int t_mother, int t2p, int b, int n_bits) {
  constexpr int kRing = tb_ring<decode_tb_stages(kBitsWarps)>();
  __shared__ __align__(16) uint8_t ring[kBitsWarps * kRing];
  const int cw = blockIdx.x * kBitsWarps + (int)(threadIdx.x >> 5);
  const bool live = cw < b;
  uint8_t* dcw = dec + (size_t)cw * (t2p / 4) * kStates;
  const int n_vals = live ? 4 * t_mother : 0;
  forward_acs<kPrefetch, F32Metric, kStage, kBitsWarps>(
      MotherSoft<T>{soft + (size_t)cw * n_vals, n_vals}, table, t2p,
      live ? reinterpret_cast<uint16_t*>(dcw) : nullptr);
  if (live)
    traceback<true, kShuffle, decode_tb_stages(kBitsWarps)>(
        dcw, t2p / 4, out + (size_t)cw * n_bits, n_bits, ring + (threadIdx.x >> 5) * kRing);
}

template <typename T, typename Mt, int kVariant, int kRebase, int kWarps = transposed_warps<T>()>
__global__ void TPUDAB_WARPS_BOUNDS(kWarps)
viterbi_fwd_variant_kernel(const T* __restrict__ soft, const int* __restrict__ table,
                           uint8_t* __restrict__ dec, float* __restrict__ pm_out,
                           int t2p, int b) {
  const int cw0 = blockIdx.x * kWarps, cw = cw0 + (int)(threadIdx.x >> 5);
  const auto v = forward_acs<kVariant, Mt, kRebase, kWarps>(
      TransposedSoft<T, Mt, kWarps>{soft, b, cw0}, table, t2p,
      cw < b ? reinterpret_cast<uint16_t*>(dec + (size_t)cw * (t2p / 4) * kStates) : nullptr);
  if (cw < b)
    reinterpret_cast<float2*>(pm_out + (size_t)cw * kStates)[threadIdx.x & 31] =
        make_float2((float)v.lo, (float)v.hi);
}

constexpr int kTbWarps = 4;      // codewords per block of the warp modes
constexpr int kTreeBlock = 32;   // codewords (threads) per block of tree

// Shuffle and masked: one warp per codeword, the block's kTbWarps warps on
// consecutive codewords; tree: one thread per codeword, kTreeBlock a block.
template <int kMode>
__global__ void __launch_bounds__(kMode == kTree ? kTreeBlock : kTbWarps * kLanes)
viterbi_traceback_kernel(const uint8_t* __restrict__ dec, uint8_t* __restrict__ out,
                         int groups, int b, int n_out) {
  if constexpr (kMode == kTree) {
    __shared__ __align__(16) uint8_t ring[kTreeBlock * kTreeStride];
    const int cw = blockIdx.x * kTreeBlock + threadIdx.x;
    if (cw < b)
      traceback_tree(dec + (size_t)cw * groups * kStates, groups, out + (size_t)cw * n_out,
                     n_out, ring + threadIdx.x * kTreeStride);
  } else {
    constexpr int kRing = tb_ring<kTbStages>();
    __shared__ __align__(16) uint8_t ring[kTbWarps * kRing];
    const int cw = blockIdx.x * kTbWarps + threadIdx.x / 32;
    if (cw < b)
      traceback<false, kMode>(dec + (size_t)cw * groups * kStates, groups,
                              out + (size_t)cw * n_out, n_out, ring + (threadIdx.x / 32) * kRing);
  }
}

template <typename T>
int blocks_for(int b) {
  return (b + transposed_warps<T>() - 1) / transposed_warps<T>();
}

template <typename T, typename Mt, int kRebase>
cudaError_t launch_fwd(const void* soft, const int* table, uint8_t* dec, float* pm,
                       int t2p, int b, int variant, cudaStream_t st) {
  const T* x = static_cast<const T*>(soft);
  constexpr int kThreads = transposed_warps<T>() * kLanes;
  switch (variant) {
#define TPUDAB_FWD_CASE(V)                                                            \
    case V:                                                                           \
      viterbi_fwd_variant_kernel<T, Mt, V, kRebase><<<blocks_for<T>(b), kThreads, 0, st>>>( \
          x, table, dec, pm, t2p, b);                                                 \
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

template <typename T, int kLayout>
void launch_layout(const void* soft, const int* table, uint8_t* dec, uint8_t* out, int t2p,
                   int b, int n_out, cudaStream_t st) {
  constexpr int kCw = k12_codewords(kLayout, transposed_warps<T>());
  viterbi_kernel<T, kLayout><<<(b + kCw - 1) / kCw, k12_threads(kLayout, transposed_warps<T>()),
                               0, st>>>(static_cast<const T*>(soft), table, dec, out, t2p, b,
                                        n_out);
}

template <typename T>
cudaError_t launch_bytes_t(const void* soft, const int* table, uint8_t* dec, uint8_t* out,
                           int t2p, int b, int n_out, int layout, cudaStream_t st) {
  if (layout == kWarpLayout)
    launch_layout<T, kWarpLayout>(soft, table, dec, out, t2p, b, n_out, st);
  else if (layout == kBflyLayout)
    launch_layout<T, kBflyLayout>(soft, table, dec, out, t2p, b, n_out, st);
  else if (layout == kBfly4Layout)
    launch_layout<T, kBfly4Layout>(soft, table, dec, out, t2p, b, n_out, st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Blocks of viterbi_kernel in `layout` (see viterbi_kernel) resident an SM
// of the current device, by the occupancy calculator; -1 for a layout it
// does not have.
template <typename T>
int resident_blocks(int layout) {
  int n = -1;
  const int warps = transposed_warps<T>();
  cudaError_t e = cudaErrorInvalidValue;
  if (layout == kWarpLayout)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, viterbi_kernel<T, kWarpLayout>, k12_threads(kWarpLayout, warps), 0);
  else if (layout == kBflyLayout)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, viterbi_kernel<T, kBflyLayout>, k12_threads(kBflyLayout, warps), 0);
  else if (layout == kBfly4Layout)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, viterbi_kernel<T, kBfly4Layout>, k12_threads(kBfly4Layout, warps), 0);
  return e == cudaSuccess ? n : -1;
}

}  // namespace

// soft: (t2p, 8, b) bf16 (is_bf16=1) or f32; table: (2, 32) int32, the
// branch-metric table (see LaneTable; layout 0 reads it); dec: (b, t2p/4,
// 64) u8 scratch; out: (b, n_out) u8. t2p % 16 == 0. layout: see
// viterbi_kernel.
extern "C" int tpudab_viterbi_decode_bytes_t(const void* soft, int is_bf16,
                                             const void* table, void* dec,
                                             void* out, int t2p, int b,
                                             int n_out, int layout, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  uint8_t* d = static_cast<uint8_t*>(dec);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is_bf16)
    return (int)launch_bytes_t<__nv_bfloat16>(soft, tb, d, o, t2p, b, n_out, layout, st);
  return (int)launch_bytes_t<float>(soft, tb, d, o, t2p, b, n_out, layout, st);
}

// Blocks of viterbi_kernel's `layout` (bf16 soft when is_bf16, else f32)
// resident an SM of the current device, or -1.
extern "C" int tpudab_viterbi_resident_blocks(int layout, int is_bf16) {
  return is_bf16 ? resident_blocks<__nv_bfloat16>(layout) : resident_blocks<float>(layout);
}

// soft: (b, t_mother, 4) bf16 (is_bf16=1) or f32; table: (2, 32) int32;
// dec: (b, t2p/4, 64) u8 scratch; out: (b, n_bits) u8, one bit per byte.
// t2p % 16 == 0 and 2 * t2p >= t_mother >= n_bits.
extern "C" int tpudab_viterbi_decode_bits(const void* soft, int is_bf16,
                                          const void* table, void* dec,
                                          void* out, int t_mother, int t2p,
                                          int b, int n_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  uint8_t* d = static_cast<uint8_t*>(dec);
  uint8_t* o = static_cast<uint8_t*>(out);
  const int blocks = (b + kBitsWarps - 1) / kBitsWarps;
  if (is_bf16)
    viterbi_bits_kernel<__nv_bfloat16><<<blocks, kBitsWarps * kLanes, 0, st>>>(
        static_cast<const __nv_bfloat16*>(soft), tb, d, o, t_mother, t2p, b, n_bits);
  else
    viterbi_bits_kernel<float><<<blocks, kBitsWarps * kLanes, 0, st>>>(
        static_cast<const float*>(soft), tb, d, o, t_mother, t2p, b, n_bits);
  return (int)cudaGetLastError();
}

// soft: (t2p, 8, b), dtype 0 f32, 1 bf16 (rebase 16 or 32), 2 int16
// (rebase 4); table: (2, 32) int32; dec: (b, t2p/4, 64) u8; pm: (b, 64)
// f32. t2p % 16 == 0, t2p % rebase == 0. variant: 0 full, 1 nodec,
// 2 noacs, 3 prefetch, 4 dbuf, 5 group4.
extern "C" int tpudab_viterbi_fwd_variant(const void* soft, int dtype, const void* table,
                                          void* dec, void* pm, int t2p, int b,
                                          int variant, int rebase, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  uint8_t* d = static_cast<uint8_t*>(dec);
  float* p = static_cast<float*>(pm);
  if (dtype == 0 && rebase == 16)
    return (int)launch_fwd<float, F32Metric, 16>(soft, tb, d, p, t2p, b, variant, st);
  if (dtype == 0 && rebase == 32)
    return (int)launch_fwd<float, F32Metric, 32>(soft, tb, d, p, t2p, b, variant, st);
  if (dtype == 1 && rebase == 16)
    return (int)launch_fwd<__nv_bfloat16, F32Metric, 16>(soft, tb, d, p, t2p, b, variant, st);
  if (dtype == 1 && rebase == 32)
    return (int)launch_fwd<__nv_bfloat16, F32Metric, 32>(soft, tb, d, p, t2p, b, variant, st);
  if (dtype == 2 && rebase == 4)
    return (int)launch_fwd<int16_t, I16Metric, 4>(soft, tb, d, p, t2p, b, variant, st);
  return (int)cudaErrorInvalidValue;
}

// dec: (b, groups, 64) u8, 16-byte aligned rows; out: (b, n_out) u8,
// n_out <= groups. mode: 0 shuffle, 1 masked, 2 tree.
extern "C" int tpudab_viterbi_traceback(const void* dec, void* out, int groups, int b,
                                        int n_out, int mode, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(dec);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (mode == kShuffle)
    viterbi_traceback_kernel<kShuffle><<<(b + kTbWarps - 1) / kTbWarps, kTbWarps * kLanes, 0, st>>>(
        d, o, groups, b, n_out);
  else if (mode == kMasked)
    viterbi_traceback_kernel<kMasked><<<(b + kTbWarps - 1) / kTbWarps, kTbWarps * kLanes, 0, st>>>(
        d, o, groups, b, n_out);
  else if (mode == kTree)
    viterbi_traceback_kernel<kTree><<<(b + kTreeBlock - 1) / kTreeBlock, kTreeBlock, 0, st>>>(
        d, o, groups, b, n_out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

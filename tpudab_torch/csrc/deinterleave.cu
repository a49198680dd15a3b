// MSC time deinterleave (EN 300 401 sec 12), one tiled kernel with two
// output modes. Buffer row r of ensemble e holds 15 rows of history (the
// carry) and then the CIF slices; logical frame j is
//     logical[e, j, k] = buf[e, j + d(k mod 16), k],
// d the bit-reversed 0..15 delay table.
//
// Replaces tpudab/msc/interleave.py::deinterleave_pallas (K4, :97, called
// at :134) and, in mode (b), the XLA index maps around it in tpudab's step:
// the CIF slices, the carry concatenation, the body cut and the transposed
// depuncture (tpudab/models/step.py:139-170, tpudab/fec/depuncture.py:96).
// Plain torch twins: tpudab_torch/msc/interleave.py::deinterleave_ref (a)
// and ::deinterleave_depuncture_t_ref (b).
//
// Modes:
// (a) logical rows: out[e, j, k] from a contiguous (E, c+15, S) buffer
//     (the host path's SubchannelDecoder).
// (b) the Viterbi input: out[m, col0 + e*c + j] = logical[e, j, idx[m]]
//     where idx[m] < n_punct, 0.0 at n_punct and +1.0 at n_punct + 1 (the
//     tail flush), for every mother position m of the (T2p * 8, B) output,
//     reading the history from the carry and the CIF slices straight from
//     the flat soft bits. Extra blocks copy buffer rows c..c+14 into a
//     fresh new carry (when c < 15 part of it is old carry, so never in
//     place). The FIC runs the same tile at depth 1: no delay, no carry,
//     codeword n of a frame read from its FIB group.
//
// What bounds it on Hopper: bytes; it computes nothing. For one 108-CU EEP
// 3-A subchannel of the bench step (E = 32, c = 64, bf16) it must read the
// 28.3 MB slice and the 6.6 MB carry and write the 57.1 MB Viterbi input
// and the 6.6 MB new carry: 98.7 MB, 0.0295 ms at 3.35 TB/s. Before, that
// work was five passes through device memory (slice copy, concatenation,
// the kernel, a second concatenation, then a gather over a transposed view
// whose reads were uncoalesced), about 3 ms per step for six subchannels.
//
// Design: a block owns NB consecutive codewords (logical frames) of one
// ensemble (NB * sizeof(T) = 128 bytes, so each output row segment is one
// cache line) and a tile of 128 mother positions (b) or 128 columns (a).
// The depuncture map is monotone on the kept positions, so a tile's
// columns k are one range of at most 128; the block stages the NB + 15
// buffer rows of that range (rounded out to 16-byte vectors) in shared
// memory with 16-byte loads, then writes its outputs coalesced: in (b) a
// warp writes consecutive codewords of one mother row and reads one shared
// column down consecutive rows. The row pitch is an odd number of 32-bit
// words, so those column reads fall in distinct banks. Exact: pure copy
// and two constants.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 16;
constexpr int kHist = kDepth - 1;
constexpr int kThreads = 256;
constexpr int kTile = 128;   // mother positions (b) or columns (a) per block

template <typename T>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte load
  static constexpr int kRows = 128 / sizeof(T);    // codewords per block
  // staged columns: at most kTile, widened to whole vectors at both ends
  static constexpr int kCols = kTile + kVec;
  // padded row pitch in 32-bit words, odd: column reads hit distinct banks
  static constexpr int kPitchWords = (kCols * sizeof(T) / 4) | 1;
  static constexpr int kPitch = kPitchWords * 4 / sizeof(T);
  static constexpr int kWords = (kRows + kHist) * kPitchWords;
};

__device__ __forceinline__ uint16_t one_bits(uint16_t) { return 0x3F80; }      // bf16 1.0
__device__ __forceinline__ uint32_t one_bits(uint32_t) { return 0x3F800000; }  // f32 1.0

__device__ __forceinline__ int delay(int k) { return __brev(k & (kDepth - 1)) >> 28; }

// Where buffer row r of ensemble e lies: rows r < hist in the carry
// (E, hist, width); row r >= hist is slice n = r - hist, at
// soft[(e * frames + n / per_frame) * frame_stride + base + (n % per_frame) * pitch].
template <typename T>
struct Rows {
  const T* carry;
  const T* soft;
  int hist, frames, per_frame, frame_stride, base, pitch, width;

  __device__ __forceinline__ const T* row(int e, int r) const {
    if (r < hist) return carry + ((size_t)e * hist + r) * width;
    const int n = r - hist;
    return soft + ((size_t)e * frames + n / per_frame) * frame_stride + base
           + (size_t)(n % per_frame) * pitch;
  }
};

// kDeint: apply the delays (history of 15 rows); kT: mode (b), else (a).
template <typename T, bool kDeint, bool kT>
__global__ void __launch_bounds__(kThreads)
deint_kernel(Rows<T> src, int c, int n_jb, const int64_t* __restrict__ index,
             int n_mother, int n_punct, int n_tiles, T* __restrict__ out,
             int out_stride, int col0, T* __restrict__ new_carry) {
  using L = Layout<T>;
  __shared__ __align__(16) uint32_t sm_words[L::kWords];
  __shared__ int s_idx[kTile];
  __shared__ int s_lo, s_hi;
  const T* sm = reinterpret_cast<const T*>(sm_words);
  const int tid = threadIdx.x;
  const int e = blockIdx.y / n_jb;
  const int jb = blockIdx.y - e * n_jb;

  if (kT && blockIdx.x == n_tiles) {   // the new carry: buffer rows c .. c+14
    const int nv = src.width / L::kVec;
    for (int t = jb; t < kHist; t += n_jb) {
      const uint4* from = reinterpret_cast<const uint4*>(src.row(e, c + t));
      uint4* to = reinterpret_cast<uint4*>(new_carry + ((size_t)e * kHist + t) * src.width);
      for (int v = tid; v < nv; v += kThreads) to[v] = from[v];
    }
    return;
  }

  const int j0 = jb * L::kRows;
  const int nj = min(L::kRows, c - j0);
  int klo, khi, m0 = 0, tm = 0;
  if (kT) {
    m0 = blockIdx.x * kTile;
    tm = min(kTile, n_mother - m0);
    if (tid == 0) { s_lo = INT_MAX; s_hi = -1; }
    __syncthreads();
    if (tid < tm) {
      const int k = (int)index[m0 + tid];
      s_idx[tid] = k;
      if (k < n_punct) { atomicMin(&s_lo, k); atomicMax(&s_hi, k); }
    }
    __syncthreads();
    klo = s_lo;
    khi = s_hi + 1;   // klo > khi: the tile holds only erasures and flush
  } else {
    klo = blockIdx.x * kTile;
    khi = min(klo + kTile, src.width);
  }
  const int ka = klo & ~(L::kVec - 1);

  if (klo < khi) {   // stage rows j0 .. j0 + nj (+ 15) of columns [ka, kb)
    const int kb = min((khi + L::kVec - 1) & ~(L::kVec - 1), src.width);
    const int nv = (kb - ka) / L::kVec;
    const int rows = nj + (kDeint ? kHist : 0);
    for (int i = tid; i < rows * nv; i += kThreads) {
      const int r = i / nv;
      const int v = i - r * nv;
      const uint4 x = *reinterpret_cast<const uint4*>(src.row(e, j0 + r) + ka + v * L::kVec);
      uint32_t* to = sm_words + r * L::kPitchWords + v * 4;
      to[0] = x.x; to[1] = x.y; to[2] = x.z; to[3] = x.w;
    }
  }
  __syncthreads();

  if (kT) {   // warp: consecutive codewords j of one mother row m
    const int j = tid % L::kRows;
    if (j >= nj) return;
    T* o = out + col0 + (size_t)e * c + j0 + j;
    const T one = one_bits(T());
    for (int t = tid / L::kRows; t < tm; t += kThreads / L::kRows) {
      const int k = s_idx[t];
      T v;
      if (k < n_punct)
        v = sm[(j + (kDeint ? delay(k) : 0)) * L::kPitch + (k - ka)];
      else
        v = k == n_punct ? T(0) : one;
      o[(size_t)(m0 + t) * out_stride] = v;
    }
  } else {    // warp: consecutive columns k of one logical row j
    const int k = klo + tid % kTile;
    if (k >= khi) return;
    const int d = delay(k);
    for (int j = tid / kTile; j < nj; j += kThreads / kTile)
      out[((size_t)e * c + j0 + j) * src.width + k] = sm[(j + d) * L::kPitch + (k - ka)];
  }
}

template <typename T, bool kDeint, bool kT>
int launch(const Rows<T>& src, int e, int c, const int64_t* index, int n_mother,
           int n_punct, T* out, int out_stride, int col0, T* new_carry, cudaStream_t st) {
  const int n_jb = (c + Layout<T>::kRows - 1) / Layout<T>::kRows;
  const int n_tiles = kT ? (n_mother + kTile - 1) / kTile : (src.width + kTile - 1) / kTile;
  const dim3 grid(n_tiles + (kT && new_carry ? 1 : 0), e * n_jb);
  deint_kernel<T, kDeint, kT><<<grid, kThreads, 0, st>>>(
      src, c, n_jb, index, n_mother, n_punct, n_tiles, out, out_stride, col0, new_carry);
  return (int)cudaGetLastError();
}

template <typename T>
int deinterleave_depuncture_t(const void* soft, const void* carry, void* new_carry,
                              const void* index, void* out, int e, int frames,
                              int per_frame, int frame_stride, int base, int pitch,
                              int width, int c, int n_mother, int n_punct,
                              int out_stride, int col0, cudaStream_t st) {
  const Rows<T> src{static_cast<const T*>(carry), static_cast<const T*>(soft),
                    carry ? kHist : 0, frames, per_frame, frame_stride, base, pitch, width};
  const int64_t* idx = static_cast<const int64_t*>(index);
  T* o = static_cast<T*>(out);
  if (carry)
    return launch<T, true, true>(src, e, c, idx, n_mother, n_punct, o, out_stride, col0,
                                 static_cast<T*>(new_carry), st);
  return launch<T, false, true>(src, e, c, idx, n_mother, n_punct, o, out_stride, col0,
                                nullptr, st);
}

template <typename T>
int deinterleave_rows(const void* buf, void* out, int e, int c, int s, cudaStream_t st) {
  // buffer row r of ensemble e: buf[(e * (c + 15) + r) * s]
  const Rows<T> src{nullptr, static_cast<const T*>(buf), 0, c + kHist, 1, s, 0, 0, s};
  return launch<T, true, false>(src, e, c, nullptr, 0, 0, static_cast<T*>(out), 0, 0,
                                nullptr, st);
}

}  // namespace

// Mode (a). buf: (e, c+15, s), out: (e, c, s), elements of elem_bytes (2
// or 4) bytes; 16-byte aligned, s a multiple of 16.
extern "C" int tpudab_deinterleave(const void* buf, void* out, int e, int c,
                                   int s, int elem_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2 ? deinterleave_rows<uint16_t>(buf, out, e, c, s, st)
                         : deinterleave_rows<uint32_t>(buf, out, e, c, s, st);
}

// Mode (b). soft: (e * frames, frame_stride); carry: (e, 15, width) or
// null for depth 1 (the FIC), new_carry likewise; index: (n_mother,) int64;
// out: (n_mother, out_stride), columns col0 .. col0 + e*c written. Slice n
// of ensemble e starts at soft[(e * frames + n / per_frame) * frame_stride
// + base + (n % per_frame) * pitch]. Every row start 16-byte aligned.
extern "C" int tpudab_deinterleave_depuncture_t(
    const void* soft, const void* carry, void* new_carry, const void* index, void* out,
    int e, int frames, int per_frame, int frame_stride, int base, int pitch, int width,
    int c, int n_mother, int n_punct, int out_stride, int col0, int elem_bytes,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2
             ? deinterleave_depuncture_t<uint16_t>(soft, carry, new_carry, index, out, e,
                                                   frames, per_frame, frame_stride, base,
                                                   pitch, width, c, n_mother, n_punct,
                                                   out_stride, col0, st)
             : deinterleave_depuncture_t<uint32_t>(soft, carry, new_carry, index, out, e,
                                                   frames, per_frame, frame_stride, base,
                                                   pitch, width, c, n_mother, n_punct,
                                                   out_stride, col0, st);
}

"""Complex-free OFDM demod: split re/im IQ frames -> soft bits.

Counterpart of tpudab.ofdm.demod.demod_frames_split, and of its complex f32
oracle demod_frames (torch.fft, for tests only). The FFT, active-bin
select and frequency deinterleave are one dense DFT matmul per split part
(dense_demod_matrix), left to torch.matmul as tpudab leaves it to XLA.

Two DFT paths, chosen by the operands' dtype (dft_operands):
- bf16 (the receive step's): carve + rotate to bf16 (kernel K5 on CUDA,
  tpudab_torch.ops.carve, which also writes the sum ar + ai that the first
  product takes), then the 3-matmul Karatsuba complex product with
  bf16 outputs. tpudab's dot accumulates in f32 and rounds once to bf16;
  cuBLAS may instead reduce split-K partial sums in bf16 unless
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is
  False, which chip_smoke.py and the GPU tests set so that the card's
  products round as the reference's do.
- f32: plain carve + rotate in f32 and two f32 matmuls, for parity with
  tpudab's f32 path.

The tail after the products (the Karatsuba combine, the DQPSK demap, the
normalisation, the tap and mean_power) runs where the products are:
- CUDA tensors with bf16 operands: three launches of csrc/demod_tail.cu
  (tpudab_torch.ops.demod_tail), which read the products in bf16 and write
  the soft bits, with no f32 copy in between. dr and di round where the
  eager chain does; the f32 sums behind the frame's mean, mean_power and
  the tap's scale run in the kernels' fixed order (soft bits within 1 bf16
  ulp of the eager chain's).
- the CPU, or f32 operands: the eager torch chain (eager_tail), which
  the CPU tests hold against tpudab.

rtl_sdr's raw IQ, uint8 frames (F, frame_len, 2) or (F, 2 frame_len) of
interleaved offset-binary I/Q with frames_im None, is chosen by the
frames' dtype: on the kernels' path K5 and stats_kernel read the bytes and
convert them in registers; elsewhere the frames are converted first, to
(x - 127.5) / 128 in f32 (ops/carve.py::u8_parts). Either way the soft
bits are those of the f32 frames so converted. A tracked stream's u8
frames come as one buffer of I/Q pairs with `starts`, each frame's first
pair in it (ofdm/track.py): K5 and stats_kernel read them in place, the
other path gathers them first (ops/carve.py::u8_frames_at).

Under a profiler the stages record spans (host/profiling.py): demod.carve
(K5 and its tables; items: window samples), demod.dft (the products, and
on the eager chain the combine), demod.demap (the demap and, on CUDA, the
per-frame sums), demod.norm (items: soft bits) and demod.stats (the tap
and mean_power).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudab_torch.constants.interleaver import get_carrier_map_positions
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.host.profiling import span
from tpudab_torch.ops import demod_tail
from tpudab_torch.ops.carve import carve_rotate, carve_windows, u8_frames_at, u8_parts

N_CONST_POINTS = 480  # constellation tap size


@functools.lru_cache(maxsize=None)
def active_bin_indices(mode: int) -> np.ndarray:
    """fft-bin indices of the active carriers k=-K/2..K/2 except 0."""
    p = get_ofdm_params(mode)
    k_half = p.nb_data_carriers // 2
    ks = np.array([k for k in range(-k_half, k_half + 1) if k != 0])
    return (ks % p.nb_fft).astype(np.int32)


@functools.lru_cache(maxsize=None)
def dense_demod_matrix(mode: int):
    """(nb_fft, K) cos and sin parts of the DFT restricted to the active
    carriers, columns in logical (frequency-deinterleaved) order."""
    p = get_ofdm_params(mode)
    cols = active_bin_indices(mode)[get_carrier_map_positions(mode).astype(np.int64)]
    ang = -2.0 * np.pi * np.outer(np.arange(p.nb_fft), cols) / p.nb_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dft_operands(mode: int, dft_dtype: str = "bfloat16"):
    """DFT operands as tensors: bf16 (Wre, Wre + Wim, Wim - Wre) for the
    Karatsuba path, or the f32 (nb_fft, 2K) [Wre | Wim] for the f32 path."""
    wre, wim = dense_demod_matrix(mode)
    if dft_dtype == "bfloat16":
        return tuple(torch.from_numpy(w).to(torch.bfloat16)
                     for w in (wre, wre + wim, wim - wre))
    if dft_dtype == "float32":
        return (torch.from_numpy(np.concatenate([wre, wim], axis=1)),)
    raise ValueError(f"dft_dtype {dft_dtype!r} not in (bfloat16, float32)")


def demod_frames(frames, freq_offset_hz, mode: int = 1, window_offset: int = 12):
    """The complex f32 oracle of the demod (tpudab.ofdm.demod.demod_frames),
    on complex torch.fft: a test reference, never on the card's path.

    frames (F, nb_frame_length) complex64, each starting at the first
    sample of the null symbol; freq_offset_hz scalar or (F,), the net CFO
    rotated out; the FFT window advanced window_offset samples into the
    cyclic prefix. Returns (soft (F, nb_frame_bits) f32, unit mean
    magnitude, + => 0; stats {"mean_power": (F,)})."""
    p = get_ofdm_params(mode)
    frames = torch.as_tensor(frames)
    f, dev = frames.shape[0], frames.device
    n_sym, n_fft, n_cp = p.nb_symbols, p.nb_fft, p.nb_cyclic_prefix

    freq = torch.as_tensor(freq_offset_hz, dtype=torch.float32, device=dev).broadcast_to((f,))
    t_idx = torch.arange(p.nb_frame_length, dtype=torch.float32, device=dev) / SAMPLING_RATE
    x = frames * torch.exp(-2j * np.pi * freq[:, None] * t_idx[None, :]).to(torch.complex64)

    sym = x[:, p.nb_null_period:].reshape(f, n_sym, n_fft + n_cp)
    start = n_cp - window_offset
    spec = torch.fft.fft(sym[:, :, start:start + n_fft], dim=-1)
    carriers = spec[..., torch.from_numpy(active_bin_indices(mode).astype(np.int64)).to(dev)]
    diff = carriers[:, 1:] * carriers[:, :-1].conj()
    pos = torch.from_numpy(get_carrier_map_positions(mode).astype(np.int64)).to(dev)
    logical = diff[..., pos]

    soft = torch.cat([logical.real, logical.imag], dim=-1).reshape(f, p.nb_frame_bits)
    soft = soft / soft.abs().mean(dim=-1, keepdim=True).clamp_min(1e-20)
    return soft.float(), {"mean_power": (frames.abs() ** 2).mean(dim=-1)}


def spectra_split(frames_re, frames_im, freq_hz, operands, mode: int = 1,
                  window_offset: int = 12):
    """The demod's front: carve + rotate and the DFT products. frames
    (F, frame_len//128, 128) or (F, frame_len), bf16 or f32; freq_hz scalar
    or (F,); operands from dft_operands. Returns (cr, ci), the (F, n_sym, K)
    spectra at the active carriers in logical order, in the operands'
    dtype."""
    return _spectra(frames_re, frames_im, freq_hz, operands, mode, window_offset, True)


def _spectra(frames_re, frames_im, freq_hz, operands, mode, window_offset, combine,
             starts=None):
    """spectra_split; with bf16 operands and combine False, the three
    Karatsuba products (m1, m2, m3) instead of (m1 - m2, m3 + m1); starts
    as demod_frames_split takes them (bf16 operands only)."""
    p = get_ofdm_params(mode)
    n_sym, n_fft = p.nb_symbols, p.nb_fft
    f = frames_re.shape[0] if starts is None else starts.numel()
    dev = frames_re.device
    at = {} if starts is None else {"starts": starts}    # an aligned call as it was

    if operands[0].dtype == torch.bfloat16:
        wc, wcd, wdc = operands
        with span("demod.carve", f * n_sym * n_fft, dev):
            xr, xi, xs = carve_rotate(frames_re, frames_im, freq_hz, mode, window_offset,
                                      with_sum=True, **at)
        with span("demod.dft", 0, dev):
            ar = xr.view(f, n_sym, n_fft)
            ai = xi.view(f, n_sym, n_fft)
            # Karatsuba: three products instead of four, bf16 outputs; xs is
            # the bf16 ar + ai, written by the carve
            m1 = torch.matmul(xs.view(f, n_sym, n_fft), wc)
            m2 = torch.matmul(ai, wcd)
            m3 = torch.matmul(ar, wdc)
            return (m1 - m2, m3 + m1) if combine else (m1, m2, m3)
    (mboth,) = operands
    with span("demod.carve", f * n_sym * n_fft, dev):
        ar, ai = carve_windows(frames_re, frames_im, freq_hz, mode,
                               window_offset, torch.float32)
    with span("demod.dft", 0, dev):
        k = mboth.shape[1] // 2
        p1 = torch.matmul(ar, mboth)          # [ar@Wre | ar@Wim]
        p2 = torch.matmul(ai, mboth)          # [ai@Wre | ai@Wim]
        return p1[..., :k] - p2[..., k:], p1[..., k:] + p2[..., :k]


def differential_demap(cr, ci):
    """(F, n_sym, K) spectra -> (F, n_sym - 1, K) parts of z_l * conj(z_{l-1})."""
    dr = cr[:, 1:] * cr[:, :-1] + ci[:, 1:] * ci[:, :-1]
    di = ci[:, 1:] * cr[:, :-1] - cr[:, 1:] * ci[:, :-1]
    return dr, di


def _tail_kernels(operands, device) -> bool:
    """Whether the demod's tail runs as csrc/demod_tail.cu: on CUDA, with
    the bf16 (Karatsuba) operands."""
    return device.type == "cuda" and operands[0].dtype == torch.bfloat16


def demod_frames_split(frames_re, frames_im, freq_hz, operands, mode: int = 1,
                       window_offset: int = 12, out_dtype=torch.float32, starts=None):
    """frames (F, frame_len//128, 128) or (F, frame_len), bf16 or f32, or
    u8 frames (F, frame_len, 2) or (F, 2 frame_len) with frames_im None,
    or a u8 buffer (..., 2) of I/Q pairs with frames_im None and starts (F,)
    int64, frame f's first pair in the flattened buffer; freq_hz scalar or
    (F,); operands from dft_operands. Returns (soft (F, nb_frame_bits)
    out_dtype, stats) with stats holding mean_power (F,) and the
    const_re/const_im constellation tap (480,)."""
    dev = frames_re.device
    frame_len = get_ofdm_params(mode).nb_frame_length
    if not _tail_kernels(operands, dev):
        if starts is not None:
            frames_re = u8_frames_at(frames_re, starts, frame_len)
        if frames_re.dtype == torch.uint8:
            frames_re, frames_im = u8_parts(frames_re, get_ofdm_params(mode).nb_frame_length,
                                            frames_im)
        return eager_tail(spectra_split(frames_re, frames_im, freq_hz, operands, mode,
                                        window_offset), frames_re, frames_im, out_dtype)
    m = _spectra(frames_re, frames_im, freq_hz, operands, mode, window_offset, False, starts)
    at = {} if starts is None else {"starts": starts, "frame_len": frame_len}
    with span("demod.demap", 0, dev):
        partials = demod_tail.demap(*m)
    with span("demod.norm", m[0].shape[0] * get_ofdm_params(mode).nb_frame_bits, dev):
        soft = demod_tail.norm(*m, partials, out_dtype)
    with span("demod.stats", 0, dev):
        mean_power, tap = demod_tail.stats(frames_re, frames_im, *m, **at)
    return soft, {"mean_power": mean_power, "const_re": tap[0], "const_im": tap[1]}


def eager_tail(spectra, frames_re, frames_im, out_dtype=torch.float32):
    """The demod after the DFT in eager torch: spectra (cr, ci) from
    spectra_split and the frames -> demod_frames_split's (soft, stats).
    The spectra are freed before the normalisation allocates, so pass the
    pair without keeping it."""
    dev = frames_re.device
    with span("demod.demap", 0, dev):
        dr, di = differential_demap(*spectra)
    del spectra
    f, n_rows, k = dr.shape

    with span("demod.norm", 2 * dr.numel(), dev):
        if dr.dtype == torch.bfloat16:
            # normalise the parts before the concat (equal-sized halves, so
            # the mean over the frame is the average of the halves' means)
            norm = 0.5 * (dr.abs().float().mean(dim=(1, 2), keepdim=True)
                          + di.abs().float().mean(dim=(1, 2), keepdim=True))
            denom = norm.clamp_min(1e-20)
            soft = torch.cat([(dr.float() / denom).to(out_dtype),
                              (di.float() / denom).to(out_dtype)], dim=-1)
            soft = soft.reshape(f, -1)
        else:
            soft = torch.cat([dr, di], dim=-1).reshape(f, -1)
            norm = soft.abs().mean(dim=-1, keepdim=True)
            soft = (soft / norm.clamp_min(1e-20)).to(out_dtype)

    with span("demod.stats", 0, dev):
        # decimated constellation tap of the last frame, unit RMS
        stride = max(1, (n_rows * k) // N_CONST_POINTS)
        cr_pts = dr[-1].reshape(-1)[::stride][:N_CONST_POINTS].float()
        ci_pts = di[-1].reshape(-1)[::stride][:N_CONST_POINTS].float()
        scale = torch.rsqrt((cr_pts ** 2 + ci_pts ** 2).mean() + 1e-20)
        fr = frames_re.reshape(f, -1).float()
        fi = frames_im.reshape(f, -1).float()
        stats = {"mean_power": (fr ** 2 + fi ** 2).mean(dim=-1),
                 "const_re": cr_pts * scale, "const_im": ci_pts * scale}
    return soft, stats

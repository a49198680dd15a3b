"""OFDM acquisition, batched over buffers: counterpart of
tpudab.ofdm.sync_device.

The algorithm is tpudab's, step for step: null dip -> dip-end rise ->
fractional CFO (lag-Tu autocorrelation) -> integer-bin CFO (differential-
spectrum circular correlation against the PRS reference) -> global PRS
matched filter over one frame of lags -> one unconditional refinement pass
(coarse at the exact PRS position, the matched filter again) -> fractional
CFO on the aligned frame. The control flow does not depend on the data, and
one call acquires a batch of B buffers. tpudab computes its FFTs as matmuls
(tpudab.ops.matfft) because the TPU it was written for has no fast FFT;
here they are torch.fft (cuFFT on the card), and the inverse transforms are
left unnormalised as matfft's are. Nothing inside makes a tensor on the
host, so a caller may capture the tracking taps in a CUDA graph
(ofdm/track.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.constants.prs import get_prs_spectrum, get_prs_time
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _complex_table(re: np.ndarray, im: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


@functools.lru_cache(maxsize=None)
def _coarse_tables(mode: int, device: torch.device) -> torch.Tensor:
    """Constant conj(FFT(d_ref)) for the differential-spectrum correlation,
    rounded to f32 parts as tpudab's table is."""
    ref = get_prs_spectrum(mode)
    f = np.conj(np.fft.fft(ref * np.conj(np.roll(ref, 1))))
    return _complex_table(f.real.astype(np.float32), f.imag.astype(np.float32), device)


@functools.lru_cache(maxsize=None)
def _prs_mf_tables(mode: int, nfft: int, device: torch.device) -> torch.Tensor:
    """Constant conj(FFT(prs_time, nfft)) for the PRS matched filter."""
    f = np.conj(np.fft.fft(get_prs_time(mode), nfft))
    return _complex_table(f.real.astype(np.float32), f.imag.astype(np.float32), device)


def _freq(freq_hz, b: int, device) -> torch.Tensor:
    return torch.as_tensor(freq_hz, dtype=torch.float32, device=device).broadcast_to((b,))


def _rotate(re: torch.Tensor, im: torch.Tensor, freq_hz: torch.Tensor, t0: int = 0):
    """Per-row mixer: (B, L) * exp(-2j pi f t), f (B,) Hz, t from sample t0."""
    t = (t0 + torch.arange(re.shape[-1], dtype=torch.float32, device=re.device)) / SAMPLING_RATE
    ph = -2.0 * math.pi * freq_hz[:, None] * t[None, :]
    c, s = torch.cos(ph), torch.sin(ph)
    return re * c - im * s, re * s + im * c


def _ifft_mag(x: torch.Tensor) -> torch.Tensor:
    """|unnormalised inverse FFT| along the last axis."""
    return torch.fft.ifft(x, norm="forward").abs()


def _coarse_split(win_re, win_im, mode: int, max_bins: int):
    """Integer-bin CFO from (B, nb_fft) PRS-aligned windows. Returns
    (offset_bins (B,) int32, quality (B,))."""
    p = get_ofdm_params(mode)
    s = torch.fft.fft(torch.complex(win_re, win_im))
    d = s * torch.roll(s, 1, dims=-1).conj()
    mag = _ifft_mag(torch.fft.fft(d) * _coarse_tables(mode, s.device))
    lags = torch.cat([torch.arange(0, max_bins + 1, device=mag.device),
                      torch.arange(p.nb_fft - max_bins, p.nb_fft, device=mag.device)])
    vals = mag[:, lags]
    best = torch.argmax(vals, dim=-1)
    lag = lags[best]
    offset = torch.where(lag <= max_bins, lag, lag - p.nb_fft)
    q = vals.gather(-1, best[:, None])[:, 0] / mag.mean(dim=-1).clamp_min(1e-20)
    return offset.to(torch.int32), q


def _prs_search_split(seg_re, seg_im, mode: int, length: int,
                      peak_threshold_db: float = 15.0,
                      peak_distance_prob: float = 0.15):
    """Global PRS matched filter over (B, n) CFO-corrected segments
    (n >= length + nb_fft). Returns (peak (B,) int32, quality (B,), the
    peak's fraction (B,) in [-0.5, 0.5]): the fraction is the vertex of the
    parabola through the magnitudes at peak - 1, peak and peak + 1 (0 where
    they make no peak), which the tracker (ofdm/track.py) reads.

    First-path detection under multipath: among lags up to one cyclic
    prefix ahead of the strongest peak, each candidate's magnitude is
    boosted by the distance prior p^(-d/CP) and must clear
    max * 10^(-threshold_db/20); the best boosted candidate wins.
    threshold_db <= 0 or p >= 1 is plain argmax."""
    p = get_ofdm_params(mode)
    nfft = _next_pow2(seg_re.shape[-1])
    spec = torch.fft.fft(torch.complex(seg_re, seg_im), n=nfft)
    mag = _ifft_mag(spec * _prs_mf_tables(mode, nfft, spec.device))[:, :length]
    max_lag = torch.argmax(mag, dim=-1)
    max_mag = mag.gather(-1, max_lag[:, None])
    q = max_mag[:, 0] / mag.mean(dim=-1).clamp_min(1e-20)
    if peak_threshold_db > 0.0 and 0.0 < peak_distance_prob < 1.0:
        cp = float(p.nb_cyclic_prefix)
        d = (max_lag[:, None] - torch.arange(length, device=mag.device)[None, :]).float()
        in_win = (d >= 0.0) & (d <= cp)
        boost = torch.pow(torch.full_like(d, peak_distance_prob), -d / cp)
        thresh = max_mag * 10.0 ** (-peak_threshold_db / 20.0)
        score = torch.where(in_win & (mag >= thresh), mag * boost, -1.0)
        peak = torch.argmax(score, dim=-1)
    else:
        peak = max_lag
    a, b, c = (mag.gather(-1, (peak + d).clamp(0, length - 1)[:, None])[:, 0] for d in (-1, 0, 1))
    den = a - 2.0 * b + c
    frac = torch.where(den < 0, 0.5 * (a - c) / den.clamp_max(-1e-30), 0.0).clamp(-0.5, 0.5)
    return peak.to(torch.int32), q, frac


def _cp_autocorr_split(fr_re, fr_im, mode: int):
    """Fractional CFO (Hz) from the CP autocorrelation over all symbols of
    aligned (B, frame_len) frames."""
    p = get_ofdm_params(mode)
    b = fr_re.shape[0]

    def syms(x):
        return x[:, p.nb_null_period:].reshape(b, p.nb_symbols, p.nb_symbol_period)
    sr, si = syms(fr_re), syms(fr_im)
    h_r, h_i = sr[:, :, : p.nb_cyclic_prefix], si[:, :, : p.nb_cyclic_prefix]
    t_r = sr[:, :, p.nb_fft: p.nb_fft + p.nb_cyclic_prefix]
    t_i = si[:, :, p.nb_fft: p.nb_fft + p.nb_cyclic_prefix]
    acc_r = (h_r * t_r + h_i * t_i).sum(dim=(1, 2))
    acc_i = (h_i * t_r - h_r * t_i).sum(dim=(1, 2))
    return -torch.atan2(acc_i, acc_r) / (2.0 * math.pi) * (SAMPLING_RATE / p.nb_fft)


def _slice_rows(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """(B, n), (B,) -> (B, length) per-row slices, each start clamped to
    [0, n - length] as jax.lax.dynamic_slice clamps it."""
    s = starts.long().clamp(0, x.shape[-1] - length)
    return x.gather(-1, s[:, None] + torch.arange(length, device=x.device)[None, :])


def _frame_start(peak: torch.Tensor, p) -> torch.Tensor:
    start = peak - p.nb_cyclic_prefix - p.nb_null_period
    return torch.where(start < 0, start + p.nb_frame_length, start)


def acquire_device(re: torch.Tensor, im: torch.Tensor, mode: int = 1,
                   max_coarse_bins: int = 100, peak_threshold_db: float = 15.0,
                   peak_distance_prob: float = 0.15):
    """Batched full acquisition of (B, n) f32 split-real IQ (n >= 2 frames)
    on their device. Returns a dict of (B,) tensors there: frame_start,
    coarse_bins (int32), coarse_hz, fine_hz, net_freq_hz, null_quality,
    coarse_quality, time_quality. No host round trip."""
    p = get_ofdm_params(mode)
    b, n = re.shape
    spacing = SAMPLING_RATE / p.nb_fft
    if n < 2 * p.nb_frame_length:
        raise ValueError(f"need >= 2 frames ({2 * p.nb_frame_length} samples) "
                         f"for acquisition, got {n}")

    # 1. null dip + dip-end rise
    power = re * re + im * im
    csum = torch.cat([power.new_zeros((b, 1)), torch.cumsum(power, dim=-1)], dim=-1)
    win = p.nb_null_period
    ma = (csum[:, win:] - csum[:, :-win]) / win
    cand = ma[:, : p.nb_frame_length]
    null_start = torch.argmin(cand, dim=-1)
    mean_p = power.mean(dim=-1)
    null_q = cand.gather(-1, null_start[:, None])[:, 0] / mean_p.clamp_min(1e-20)
    rise = 64
    ma_r = (csum[:, rise:] - csum[:, :-rise]) / rise
    idx = torch.arange(ma_r.shape[-1], device=re.device)
    risen = (ma_r > 0.5 * mean_p[:, None]) & (idx[None, :] >= null_start[:, None])
    null_end = torch.where(risen.any(dim=-1), risen.to(torch.uint8).argmax(dim=-1),
                           null_start + p.nb_null_period)
    approx_prs = (null_end + p.nb_cyclic_prefix).clamp_max(n - p.nb_fft)

    # 2. fractional CFO, alignment-free (lag-Tu autocorrelation)
    n2 = (2 * p.nb_frame_length - p.nb_fft) // 8 * 8
    a_r, a_i = re[:, :n2], im[:, :n2]
    b_r, b_i = re[:, p.nb_fft: p.nb_fft + n2], im[:, p.nb_fft: p.nb_fft + n2]
    acc_r = (a_r * b_r + a_i * b_i).sum(dim=-1)
    acc_i = (a_i * b_r - a_r * b_i).sum(dim=-1)
    fine_hz = -torch.atan2(acc_i, acc_r) / (2.0 * math.pi) * spacing

    # 3. integer-bin CFO after removing the fractional part
    w_re, w_im = _rotate(_slice_rows(re, approx_prs, p.nb_fft),
                         _slice_rows(im, approx_prs, p.nb_fft), fine_hz)
    coarse_bins, coarse_q = _coarse_split(w_re, w_im, mode, max_coarse_bins)
    net_hz = coarse_bins.float() * spacing + fine_hz

    # 4. exact timing: PRS matched filter over one frame of lags
    n_corr = p.nb_frame_length + p.nb_fft
    s_re, s_im = _rotate(re[:, :n_corr], im[:, :n_corr], net_hz)
    peak, time_q, _ = _prs_search_split(s_re, s_im, mode, p.nb_frame_length,
                                        peak_threshold_db, peak_distance_prob)
    frame_start = _frame_start(peak, p)

    # 5. refinement, unconditional: coarse again at the exact PRS body, the
    # matched filter again with the refined net, then the fractional CFO on
    # the aligned frame
    prs_body = (frame_start + p.nb_null_period + p.nb_cyclic_prefix).clamp_max(n - p.nb_fft)
    w2_re, w2_im = _rotate(_slice_rows(re, prs_body, p.nb_fft),
                           _slice_rows(im, prs_body, p.nb_fft), fine_hz)
    coarse2, coarse_q2 = _coarse_split(w2_re, w2_im, mode, max_coarse_bins)
    net_hz = coarse2.float() * spacing + fine_hz
    s_re, s_im = _rotate(re[:, :n_corr], im[:, :n_corr], net_hz)
    peak, time_q, _ = _prs_search_split(s_re, s_im, mode, p.nb_frame_length,
                                        peak_threshold_db, peak_distance_prob)
    frame_start = _frame_start(peak, p)

    safe_start = frame_start.clamp_max(n - p.nb_frame_length)
    f_re, f_im = _rotate(_slice_rows(re, safe_start, p.nb_frame_length),
                         _slice_rows(im, safe_start, p.nb_frame_length), net_hz)
    fine_hz = fine_hz + _cp_autocorr_split(f_re, f_im, mode)
    coarse_hz = coarse2.float() * spacing
    return {
        "frame_start": frame_start.to(torch.int32),
        "coarse_bins": coarse2,
        "coarse_hz": coarse_hz,
        "fine_hz": fine_hz,
        "net_freq_hz": coarse_hz + fine_hz,
        "null_quality": null_q,
        "coarse_quality": torch.maximum(coarse_q, coarse_q2),
        "time_quality": time_q,
    }


def fine_time_sync_device(seg_re, seg_im, freq_hz, mode: int = 1, search: int = 64,
                          peak_threshold_db: float = 15.0,
                          peak_distance_prob: float = 0.15):
    """Batched PRS matched filter for the streaming timing recheck:
    (B, 2*search + nb_fft [+margin]) segments expected to hold the PRS near
    sample `search`, rotated by freq_hz (scalar or (B,)) in here. Returns
    (peak (B,), quality (B,))."""
    seg_re, seg_im = _rotate(seg_re, seg_im, _freq(freq_hz, seg_re.shape[0], seg_re.device))
    return _prs_search_split(seg_re, seg_im, mode, 2 * search + 1,
                             peak_threshold_db, peak_distance_prob)[:2]


def coarse_freq_device(seg_re, seg_im, freq_hz, mode: int = 1, max_bins: int = 100):
    """Batched residual integer-bin CFO of (B, nb_fft) PRS-body windows
    after removing freq_hz: the streaming continuous coarse tap. Returns
    (residual_bins (B,) int32, quality (B,))."""
    seg_re, seg_im = _rotate(seg_re, seg_im, _freq(freq_hz, seg_re.shape[0], seg_re.device))
    return _coarse_split(seg_re, seg_im, mode, max_bins)


def fine_freq_device(f_re, f_im, freq_hz, mode: int = 1):
    """Batched residual fractional CFO (Hz) of aligned (B, frame_len)
    frames after removing freq_hz: the streaming fine-freq tracking tap."""
    f_re, f_im = _rotate(f_re, f_im, _freq(freq_hz, f_re.shape[0], f_re.device))
    return _cp_autocorr_split(f_re, f_im, mode)


_HOST_KEYS = ("frame_start", "coarse_bins", "coarse_hz", "fine_hz", "net_freq_hz",
              "null_quality", "coarse_quality", "time_quality")


def acquire_host(iq: np.ndarray, mode: int = 1, max_coarse_bins: int = 100,
                 peak_threshold_db: float = 15.0, peak_distance_prob: float = 0.15,
                 device=DEFAULT_DEVICE):
    """Single-buffer acquisition of complex host IQ on device: one copy
    there, one read back at the end; python scalars out."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(iq, dtype=np.complex64)).to(dev)
    out = acquire_device(x.real.contiguous()[None], x.imag.contiguous()[None], mode,
                         max_coarse_bins, float(peak_threshold_db), float(peak_distance_prob))
    vals = torch.stack([out[k].double()[0] for k in _HOST_KEYS]).cpu().tolist()
    res = dict(zip(_HOST_KEYS, vals))
    res["frame_start"] = int(res["frame_start"])
    res["coarse_bins"] = int(res["coarse_bins"])
    return res

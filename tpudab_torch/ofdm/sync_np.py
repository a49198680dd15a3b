"""Pure-NumPy acquisition on the host: counterpart of tpudab.ofdm.sync_np.

The numpy oracle that the port's acquisition (ofdm/sync_device.py,
acquire_device and acquire_host) is held to, line for line tpudab's, on
the port's own constants and SyncConfig. Nothing on the receive path
calls it: tests/test_torch_sync.py and chip_smoke.py's acquisition check
compare against it.
"""

from __future__ import annotations

import numpy as np

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.constants.prs import get_prs_spectrum, get_prs_time
from tpudab_torch.ofdm.sync import SyncConfig, carrier_spacing_hz


def estimate_null_start_np(buffer: np.ndarray, mode: int = 1):
    p = get_ofdm_params(mode)
    power = np.abs(buffer) ** 2
    csum = np.concatenate([[0.0], np.cumsum(power)])
    win = p.nb_null_period
    ma = (csum[win:] - csum[:-win]) / win
    candidates = ma[: p.nb_frame_length]
    null_start = int(np.argmin(candidates))
    quality = candidates[null_start] / max(float(np.mean(power)), 1e-20)
    return null_start, float(quality)


def estimate_null_end_np(buffer, null_start, mode=1, rise_window=64):
    p = get_ofdm_params(mode)
    power = np.abs(buffer) ** 2
    csum = np.concatenate([[0.0], np.cumsum(power)])
    ma = (csum[rise_window:] - csum[:-rise_window]) / rise_window
    thresh = 0.5 * float(np.mean(power))
    risen = np.nonzero(ma[null_start:] > thresh)[0]
    if risen.size:
        return null_start + int(risen[0])
    return null_start + p.nb_null_period


def coarse_freq_estimate_np(prs_window, mode=1, max_bins=100):
    p = get_ofdm_params(mode)
    spec = np.fft.fft(prs_window)
    ref = get_prs_spectrum(mode)
    d_rx = spec * np.conj(np.roll(spec, 1))
    d_ref = ref * np.conj(np.roll(ref, 1))
    corr = np.fft.ifft(np.fft.fft(d_rx) * np.conj(np.fft.fft(d_ref)))
    mag = np.abs(corr)
    lags = np.concatenate([np.arange(0, max_bins + 1),
                           np.arange(p.nb_fft - max_bins, p.nb_fft)])
    vals = mag[lags]
    best = int(np.argmax(vals))
    lag = int(lags[best])
    offset = lag if lag <= max_bins else lag - p.nb_fft
    quality = vals[best] / max(float(np.mean(mag)), 1e-20)
    return offset, float(quality)


def prs_search_full_np(buffer, mode=1, length=None):
    p = get_ofdm_params(mode)
    if length is None:
        length = p.nb_frame_length
    ref = get_prs_time(mode)
    n = length + p.nb_fft
    nfft = 1
    while nfft < n:
        nfft *= 2
    corr = np.fft.ifft(np.fft.fft(buffer[:n], nfft) * np.conj(np.fft.fft(ref, nfft)))
    mag = np.abs(corr[:length])
    peak = int(np.argmax(mag))
    quality = mag[peak] / max(float(np.mean(mag)), 1e-20)
    return peak, float(quality)


def fine_freq_autocorr_np(buffer, mode=1):
    p = get_ofdm_params(mode)
    n = (buffer.shape[0] - p.nb_fft) // 8 * 8
    acc = np.sum(buffer[:n] * np.conj(buffer[p.nb_fft : p.nb_fft + n]))
    return float(-np.angle(acc) / (2.0 * np.pi) * (SAMPLING_RATE / p.nb_fft))


def fine_freq_estimate_np(frame, mode=1):
    p = get_ofdm_params(mode)
    syms = frame[p.nb_null_period:].reshape(p.nb_symbols, p.nb_symbol_period)
    head = syms[:, : p.nb_cyclic_prefix]
    tail = syms[:, p.nb_fft : p.nb_fft + p.nb_cyclic_prefix]
    acc = np.sum(head * np.conj(tail))
    return float(-np.angle(acc) / (2.0 * np.pi) * (SAMPLING_RATE / p.nb_fft))


def fine_time_sync_np(segment, mode=1, search=256):
    p = get_ofdm_params(mode)
    ref = get_prs_time(mode)
    n = segment.shape[0]
    nfft = 1
    while nfft < n + p.nb_fft:
        nfft *= 2
    corr = np.fft.ifft(np.fft.fft(segment, nfft) * np.conj(np.fft.fft(ref, nfft)))
    mag = np.abs(corr[: 2 * search + 1])
    peak = int(np.argmax(mag))
    quality = mag[peak] / max(float(np.mean(mag)), 1e-20)
    return peak, float(quality)


def acquire_np(buffer: np.ndarray, mode: int = 1,
               cfg: SyncConfig = SyncConfig()):
    """Acquire one buffer (at least two frames): the same dict as
    acquire_host, all numpy and Python scalars."""
    p = get_ofdm_params(mode)
    buffer = np.asarray(buffer)
    assert buffer.shape[0] >= 2 * p.nb_frame_length

    # 1. rough frame position
    null_start, null_q = estimate_null_start_np(buffer, mode)
    null_end = estimate_null_end_np(buffer, null_start, mode)
    approx_prs = null_end + p.nb_cyclic_prefix

    # 2. fractional CFO first (alignment-free); removing it BEFORE the coarse
    # estimate avoids the half-carrier ambiguity (e.g. a true offset of
    # 1.5 bins must not resolve to coarse=1, fine=-0.5 bins)
    fine_hz = fine_freq_autocorr_np(buffer[: 2 * p.nb_frame_length], mode)

    # 3. integer-bin CFO on the fine-corrected PRS window
    tw = np.arange(p.nb_fft, dtype=np.float64) / SAMPLING_RATE
    window = buffer[approx_prs : approx_prs + p.nb_fft] \
        * np.exp(-2j * np.pi * fine_hz * tw)
    coarse_bins, coarse_q = coarse_freq_estimate_np(window, mode, cfg.max_coarse_bins)
    coarse_hz = coarse_bins * carrier_spacing_hz(mode)
    net_hz = coarse_hz + fine_hz

    # 4. exact timing via the global PRS matched filter
    n_corr = p.nb_frame_length + p.nb_fft
    t = np.arange(n_corr, dtype=np.float64) / SAMPLING_RATE
    seg_c = buffer[:n_corr] * np.exp(-2j * np.pi * net_hz * t)
    peak, time_q = prs_search_full_np(seg_c, mode)
    frame_start = peak - p.nb_cyclic_prefix - p.nb_null_period
    if frame_start < 0:
        frame_start += p.nb_frame_length

    # 5. refine: coarse again at the exact PRS position, then the small
    # fine RESIDUAL after full net correction (never re-wrapping)
    prs_body = frame_start + p.nb_null_period + p.nb_cyclic_prefix
    if prs_body + p.nb_fft <= buffer.shape[0]:
        window2 = buffer[prs_body : prs_body + p.nb_fft] \
            * np.exp(-2j * np.pi * fine_hz * tw)
        coarse2, coarse_q2 = coarse_freq_estimate_np(window2, mode, cfg.max_coarse_bins)
        if coarse2 != coarse_bins:
            coarse_bins = coarse2
            coarse_hz = coarse_bins * carrier_spacing_hz(mode)
            net_hz = coarse_hz + fine_hz
            seg_c = buffer[:n_corr] * np.exp(-2j * np.pi * net_hz * t)
            peak, time_q = prs_search_full_np(seg_c, mode)
            frame_start = peak - p.nb_cyclic_prefix - p.nb_null_period
            if frame_start < 0:
                frame_start += p.nb_frame_length
        coarse_q = max(coarse_q, coarse_q2)
    if frame_start + p.nb_frame_length <= buffer.shape[0]:
        tf = np.arange(p.nb_frame_length, dtype=np.float64) / SAMPLING_RATE
        frame1 = buffer[frame_start : frame_start + p.nb_frame_length] \
            * np.exp(-2j * np.pi * net_hz * tf)
        fine_hz += fine_freq_estimate_np(frame1, mode)
        net_hz = coarse_hz + fine_hz

    return {
        "frame_start": frame_start,
        "coarse_bins": coarse_bins,
        "coarse_hz": coarse_hz,
        "fine_hz": fine_hz,
        "net_freq_hz": net_hz,
        "null_quality": null_q,
        "coarse_quality": coarse_q,
        "time_quality": time_q,
    }

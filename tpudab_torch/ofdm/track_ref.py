"""The plain reference of a tracked step's tracking (ofdm/track.py) and of
the demod's outputs it feeds: float64 torch on the host, no kernel of the
port, nothing the port computed but the state it is handed.

Given the dongles' u8 segments (E, L, 2) and a Tracker state, track_step
cuts the F frames of each ensemble where the state says, measures each
frame's start with the PRS matched filter (first path, as
sync_device._prs_search_split picks it), the fine CFO by the CP
autocorrelation of the last frame, the whole carriers on its PRS body,
fits the line through the starts for the rate, and returns the frame
starts, the next state and the consumed samples, with every frame's
mean power and the constellation tap of the last ensemble's last frame
(EN 300 401 sec 14: the FFT window 12 samples into the guard, the active
carriers in logical order, the differential products decimated to 480
points, unit RMS), as the step reports them. The step's arithmetic runs
in float32 on its FFTs; the decisions (starts, consumed, whole carriers)
have to come out the same, the estimates within a tolerance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudab_torch.constants.interleaver import get_carrier_map_positions
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.constants.prs import get_prs_spectrum, get_prs_time
from tpudab_torch.ofdm.sync import SyncConfig
from tpudab_torch.ofdm.track import (COARSE_QUALITY, LOCK_QUALITY, MARGIN, PAD,
                                     RATE_GAIN)

N_CONST_POINTS = 480
WINDOW_OFFSET = 12


def _iq(pairs: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint8 -> complex128, (x - 127.5) / 128 in each part."""
    x = (pairs.to(torch.float64) - 127.5) / 128.0
    return torch.complex(x[..., 0], x[..., 1])


def _rotated(x: torch.Tensor, freq_hz: torch.Tensor) -> torch.Tensor:
    """(B, n) complex rows times exp(-2 pi j f t), t from each row's start."""
    t = torch.arange(x.shape[-1], dtype=torch.float64) / SAMPLING_RATE
    return x * torch.exp(-2j * math.pi * freq_hz[:, None] * t[None, :])


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def prs_search(x: torch.Tensor, mode: int, length: int, cfg: SyncConfig):
    """The PRS matched filter over (B, n) rotated rows, first path:
    (peak (B,) int64, quality (B,), the peak's fraction (B,), the vertex
    of the parabola through the magnitudes at peak - 1, peak, peak + 1)."""
    p = get_ofdm_params(mode)
    nfft = _next_pow2(x.shape[-1])
    ref = torch.from_numpy(np.conj(np.fft.fft(get_prs_time(mode), nfft)))
    mag = torch.fft.ifft(torch.fft.fft(x, n=nfft) * ref, norm="forward").abs()[:, :length]
    max_lag = mag.argmax(dim=-1)
    max_mag = mag.gather(-1, max_lag[:, None])
    q = max_mag[:, 0] / mag.mean(dim=-1)
    cp = float(p.nb_cyclic_prefix)
    d = (max_lag[:, None] - torch.arange(length)[None, :]).double()
    boost = cfg.impulse_peak_distance_probability ** (-d / cp)
    ok = (d >= 0) & (d <= cp) & (mag >= max_mag * 10.0 ** (-cfg.impulse_peak_threshold_db / 20))
    peak = torch.where(ok, mag * boost, -1.0).argmax(dim=-1)
    a, b, c = (mag.gather(-1, (peak + d).clamp(0, length - 1)[:, None])[:, 0] for d in (-1, 0, 1))
    den = a - 2.0 * b + c
    frac = torch.where(den < 0, 0.5 * (a - c) / den.clamp_max(-1e-300), 0.0).clamp(-0.5, 0.5)
    return peak, q, frac


def coarse_bins(x: torch.Tensor, mode: int, max_bins: int):
    """Whole-carrier CFO of (B, nb_fft) rotated PRS bodies: (bins, quality)."""
    p = get_ofdm_params(mode)
    ref = get_prs_spectrum(mode)
    table = torch.from_numpy(np.conj(np.fft.fft(ref * np.conj(np.roll(ref, 1)))))
    s = torch.fft.fft(x)
    mag = torch.fft.ifft(torch.fft.fft(s * torch.roll(s, 1, dims=-1).conj()) * table,
                         norm="forward").abs()
    lags = torch.cat([torch.arange(max_bins + 1), torch.arange(p.nb_fft - max_bins, p.nb_fft)])
    vals = mag[:, lags]
    best = vals.argmax(dim=-1)
    lag = lags[best]
    return torch.where(lag <= max_bins, lag, lag - p.nb_fft), vals.gather(
        -1, best[:, None])[:, 0] / mag.mean(dim=-1)


def _carriers(mode: int) -> torch.Tensor:
    p = get_ofdm_params(mode)
    k_half = p.nb_data_carriers // 2
    ks = np.array([k for k in range(-k_half, k_half + 1) if k != 0])
    return torch.from_numpy((ks % p.nb_fft)[get_carrier_map_positions(mode).astype(np.int64)])


def const_tap(frame: torch.Tensor, freq_hz: float, mode: int = 1) -> torch.Tensor:
    """One frame's complex IQ (frame_len,) and the CFO to take out ->
    (2, 480) float64, the tap's real and imaginary parts."""
    p = get_ofdm_params(mode)
    x = _rotated(frame[None], torch.tensor([float(freq_hz)], dtype=torch.float64))[0]
    sym = x[p.nb_null_period:].reshape(p.nb_symbols, p.nb_fft + p.nb_cyclic_prefix)
    start = p.nb_cyclic_prefix - WINDOW_OFFSET
    spec = torch.fft.fft(sym[:, start:start + p.nb_fft], dim=-1)[:, _carriers(mode)]
    diff = spec[1:] * spec[:-1].conj()
    stride = max(1, diff.numel() // N_CONST_POINTS)
    pts = diff.reshape(-1)[::stride][:N_CONST_POINTS]
    pts = pts / torch.sqrt((pts.abs() ** 2).mean() + 1e-300)
    return torch.stack([pts.real, pts.imag])


def frame_starts(state: dict, n_frames: int, mode: int = 1) -> torch.Tensor:
    """(E, F) int64: frame j of ensemble e at round(rs + j T rate) of its
    segment, clamped as the tracker clamps it."""
    t = get_ofdm_params(mode).nb_frame_length
    j = torch.arange(n_frames, dtype=torch.float64)
    pos = state["rs"].double()[:, None] + j[None, :] * (t * state["rate"].double()[:, None])
    return torch.round(pos).long().clamp(0, n_frames * t + MARGIN - t - PAD)


def track_step(seg: torch.Tensor, state: dict, n_frames: int, mode: int = 1,
               cfg: SyncConfig = SyncConfig()) -> dict:
    """seg (E, L, 2) uint8 and a state as the tracker keeps it (any
    device; read to the host) -> {"starts" (E, F), "state", "consumed"
    (E,), "mean_power" (E, F), "tap" (2, 480)}, float64 and int64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = get_ofdm_params(mode)
    t, f, s = p.nb_frame_length, n_frames, cfg.fine_time_search
    spacing = SAMPLING_RATE / p.nb_fft
    seg = seg.cpu()
    state = {k: v.detach().cpu() for k, v in state.items()}
    e = seg.shape[0]
    rows = torch.arange(e)[:, None]
    starts = frame_starts(state, f, mode)
    coarse, fine = state["coarse_hz"].double(), state["fine_hz"].double()
    net = coarse + fine

    mean_power = torch.stack([(_iq(seg[i][starts[i][:, None] + torch.arange(t)]).abs() ** 2)
                              .mean(dim=-1) for i in range(e)])
    tap = const_tap(_iq(seg[-1, starts[-1, -1]:starts[-1, -1] + t]), float(net[-1]), mode)

    at = p.nb_null_period + p.nb_cyclic_prefix - s
    idx = starts[:, :, None] + at + torch.arange(2 * s + p.nb_fft)
    win = _iq(seg[rows[:, :, None], idx])
    peak, q, frac = prs_search(_rotated(win.reshape(e * f, -1), net.repeat_interleave(f)), mode,
                         2 * s + 1, cfg)
    meas = (starts + peak.view(e, f) - s).double() + frac.view(e, f)
    quality = q.view(e, f).mean(dim=1)
    locked = quality >= LOCK_QUALITY

    last = torch.round(meas[:, -1]).long()
    cp = (p.nb_null_period + p.nb_symbol_period * torch.arange(p.nb_symbols)[:, None]
          + torch.arange(p.nb_cyclic_prefix)[None, :]).reshape(-1)
    head = _iq(seg[rows, last[:, None] + cp])
    tail = _iq(seg[rows, last[:, None] + cp + p.nb_fft])
    acc = (head * tail.conj()).sum(dim=-1) * torch.exp(2j * math.pi * net / spacing)
    fine = fine + (1.0 - cfg.fine_freq_beta ** f) * (-torch.angle(acc) / (2 * math.pi) * spacing)
    body = _iq(seg[rows, last[:, None] + p.nb_null_period + p.nb_cyclic_prefix
                   + torch.arange(p.nb_fft)])
    bins, cq = coarse_bins(_rotated(body, coarse + fine), mode, cfg.max_coarse_bins)
    coarse = coarse + torch.where((bins != 0) & (cq > COARSE_QUALITY),
                                  bins.double() * spacing, 0.0)
    whole = torch.round(fine / spacing) * spacing
    fine, coarse = fine - whole, coarse + whole

    j = torch.arange(f, dtype=torch.float64)
    mbar = meas.mean(dim=1)
    rate = state["rate"].double()
    if f > 1:
        jc = j - j.mean()
        slope = (jc * (meas - mbar[:, None])).sum(dim=1) / (t * (jc * jc).sum())
        rate = rate + RATE_GAIN * (slope - rate)
    nxt = torch.where(locked, mbar + (f - j.mean()) * t * rate,
                      state["rs"] + f * t * state["rate"])
    c = torch.round(nxt).long() - starts[:, 0]
    new = {"rs": nxt - state["c_prev"],
           "rate": torch.where(locked, rate, state["rate"]),
           "coarse_hz": torch.where(locked, coarse, state["coarse_hz"]),
           "fine_hz": torch.where(locked, fine, state["fine_hz"]),
           "c_prev": c, "quality": quality.float(), "locked": locked}
    return {"starts": starts, "state": new, "consumed": c, "mean_power": mean_power,
            "tap": tap}

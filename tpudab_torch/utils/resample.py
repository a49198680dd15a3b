"""Streaming windowed-sinc polyphase resampler (host-side, numpy): a copy
of tpudab.utils.resample.

Shared by two consumers:
- tpudab_torch.audio.pipeline: per-source PCM rate conversion to the sink
  rate (the reference's AudioPipeline resamples inside the mixer);
- tpudab_torch.host.streaming: fractional sample-clock drift compensation
  on the IQ ring read. The tracked ppm drift retunes the ratio
  continuously, so timing stays locked without the +/-32-sample jump
  discontinuities (the jump path remains as a coarse fallback).

Design: P polyphase branches of a Kaiser-windowed sinc prototype (length
P*T). Output sample k is taken at input position pos0 + k*step; the branch
is chosen by the fractional part (nearest of P=128 phases = at most 1/256
sample timing quantization, far below the +/-0.5 sample tolerance of the
OFDM guard interval and inaudible for PCM). The ratio (`step`, input samples
per output sample) can be retuned between chunks without phase glitches.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def polyphase_bank(n_phases: int = 128, taps: int = 16,
                   cutoff: float = 0.5, beta: float = 8.0) -> np.ndarray:
    """(n_phases, taps) float32 filter bank from a Kaiser-windowed sinc.

    cutoff is in units of the input Nyquist (0.5 = full input band).
    Branch q reconstructs the signal at fractional offset q/P after sample
    ip via y = sum_j bank[q, j] * x[ip - j]; the window is centered, so the
    output carries a constant (taps/2 - 1) sample group delay.
    """
    p, t = n_phases, taps
    n = np.arange(p * t, dtype=np.float64)
    center = p * t // 2          # integer grid point: every branch samples
    #                              the prototype exactly on-grid (a .5-offset
    #                              center + round() jitters taps by +-0.5
    #                              grid steps and erases the stopband)
    x = (n - center) / p
    proto = 2.0 * cutoff * np.sinc(2.0 * cutoff * x) * np.kaiser(p * t, beta)
    # bank[q, j] = g(j - (t/2 - 1) + frac) with g the (even) prototype, so
    # y = sum_j bank[q, j] * x[ip - j] = x(ip + frac - (t/2 - 1)): the
    # interpolation point advances WITH frac (a reversed sign here is exact
    # at frac = 0 but time-reverses the sub-sample motion, turning the
    # periodic frac pattern of rational ratios into -22 dB sidebands).
    bank = np.empty((p, t), np.float64)
    half = t // 2 - 1
    for q in range(p):
        frac = q / p
        pos = center + (np.arange(t) - half + frac) * p
        pi = np.clip(np.round(pos).astype(int), 0, p * t - 1)
        bank[q] = proto[pi]
    bank /= bank.sum(axis=1, keepdims=True)  # unity DC gain per branch
    return bank.astype(np.float32)


class PolyphaseResampler:
    """Streaming chunk-wise resampler; continuous across process() calls.

    ratio = input samples per output sample (src_rate / dst_rate).
    Accepts (n,) real/complex or (n, ch) arrays; dtype is preserved.
    """

    def __init__(self, ratio: float, n_phases: int = 128, taps: int = 16,
                 cutoff: float | None = None):
        self.n_phases = n_phases
        self.taps = taps
        self._cutoff = cutoff
        self.set_ratio(ratio)
        self._hist = None              # last `taps` input samples
        self._pos = float(taps)        # next interpolation point (index into
        #                                [hist | chunk]); ip >= taps-1 always

    def set_ratio(self, ratio: float) -> None:
        """Retune between chunks (drift tracking); no phase discontinuity."""
        self.ratio = float(ratio)
        cutoff = self._cutoff
        if cutoff is None:
            cutoff = 0.5 * min(1.0, 1.0 / self.ratio) * 0.92
        self._bank = polyphase_bank(self.n_phases, self.taps,
                                    round(cutoff, 4))

    def process(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        t = self.taps
        if self._hist is None:
            self._hist = np.zeros((t,) + x.shape[1:], x.dtype)
        buf = np.concatenate([self._hist, x], axis=0)
        n = buf.shape[0]
        first = self._pos
        m = int(np.floor((n - 1 - first) / self.ratio)) + 1
        if m <= 0:
            self._hist = buf[-t:]
            self._pos = first - x.shape[0]
            out = np.zeros((0,) + x.shape[1:], x.dtype)
            return out[:, 0] if squeeze else out
        pts = first + self.ratio * np.arange(m)
        ip = np.floor(pts).astype(np.int64)
        frac = pts - ip
        q = np.minimum((frac * self.n_phases + 0.5).astype(np.int64),
                       self.n_phases - 1)
        # gather in blocks: the (m, taps, ch) window tensor for a whole
        # 2.048 MS/s IQ batch would be ~100 MB; 64k-point blocks keep the
        # working set cache-friendly with no seam (pure gather)
        y = np.empty((m,) + x.shape[1:], x.dtype)
        blk = 1 << 16
        for lo in range(0, m, blk):
            hi = min(lo + blk, m)
            cols = ip[lo:hi, None] - np.arange(t)[None, :]  # all >= 0
            win = buf[cols]                          # (b, taps, ch)
            h = self._bank[q[lo:hi]][..., None]      # (b, taps, 1)
            y[lo:hi] = (win * h).sum(axis=1)
        # next chunk's buf starts with the last `t` samples of this one:
        # absolute index a here becomes a - (n - t) there; the maximal m
        # guarantees pts[-1] + ratio > n - 1, i.e. the new pos >= t - 1 + r
        self._pos = float(pts[-1] + self.ratio) - (n - t)
        self._hist = buf[-t:]
        return y[:, 0] if squeeze else y

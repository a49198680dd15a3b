"""The plain reference of the demod, and its control.

Plain PyTorch on the host, in float64, with no kernel of the program and
nothing it made: from the IQ exactly as the program is handed it, the
reference works out each frame's mean power and the constellation tap of a
frame (EN 300 401 sec 14: the FFT window 12 samples into the guard, the
active carriers in frequency-deinterleaved order, the differential product
z_l conj(z_{l-1}) of each carrier over the frame's 75 data symbols, every
240th product up to 480 of them, scaled to unit RMS), as the step reports
them in mean_power and const_re / const_im.

`precision="fp8"` is the control of the monitoring cells: the reference
with the IQ and the FFT window's samples rounded to float8 e4m3 and the
DFT a product with the float8-rounded DFT matrix, the step below the bf16
that the configuration serves its IQ in. `precision="bf16"` is the same
one step below an f32 capture. It has to come out as not correct.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.synth.interleaver import get_carrier_map_positions
from benchmark.synth.ofdm_params import SAMPLING_RATE, get_ofdm_params

N_CONST_POINTS = 480
WINDOW_OFFSET = 12


def _lower(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A real tensor rounded to the precision and back to float64."""
    if precision in ("fp8", "bf16"):
        low = torch.float8_e4m3fn if precision == "fp8" else torch.bfloat16
        return x.to(low).to(torch.float64)
    if precision == "f64":
        return x.to(torch.float64)
    raise ValueError(f"precision {precision!r} not in (f64, bf16, fp8)")


@functools.lru_cache(maxsize=None)
def _carriers(mode: int) -> np.ndarray:
    """FFT bin of each active carrier in logical order."""
    p = get_ofdm_params(mode)
    k_half = p.nb_data_carriers // 2
    ks = np.array([k for k in range(-k_half, k_half + 1) if k != 0])
    return (ks % p.nb_fft)[get_carrier_map_positions(mode).astype(np.int64)]


def mean_power(re: torch.Tensor, im: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """(..., frame_len) parts of the IQ -> (...) mean power, float64."""
    r, i = _lower(re, precision), _lower(im, precision)
    return (r * r + i * i).mean(dim=-1)


def const_tap(re: torch.Tensor, im: torch.Tensor, freq_hz: float, mode: int = 1,
              precision: str = "f64") -> torch.Tensor:
    """(frame_len,) parts of one frame's IQ and the CFO to take out ->
    (2, N_CONST_POINTS) float64: the tap's real and imaginary parts."""
    p = get_ofdm_params(mode)
    n = torch.arange(p.nb_frame_length, dtype=torch.float64)
    rot = torch.exp(-2j * np.pi * float(freq_hz) * n / SAMPLING_RATE)
    x = torch.complex(_lower(re, precision), _lower(im, precision)) * rot
    sym = x[p.nb_null_period:].reshape(p.nb_symbols, p.nb_fft + p.nb_cyclic_prefix)
    start = p.nb_cyclic_prefix - WINDOW_OFFSET
    win = sym[:, start:start + p.nb_fft]
    bins = torch.from_numpy(_carriers(mode))
    if precision == "f64":
        spec = torch.fft.fft(win, dim=-1)[:, bins]
    else:
        ang = -2.0 * np.pi * torch.outer(torch.arange(p.nb_fft, dtype=torch.float64),
                                         bins.to(torch.float64)) / p.nb_fft
        wr, wi = _lower(torch.cos(ang), precision), _lower(torch.sin(ang), precision)
        xr, xi = _lower(win.real, precision), _lower(win.imag, precision)
        spec = torch.complex(xr @ wr - xi @ wi, xr @ wi + xi @ wr)
    diff = spec[1:] * spec[:-1].conj()
    stride = max(1, diff.numel() // N_CONST_POINTS)
    pts = diff.reshape(-1)[::stride][:N_CONST_POINTS]
    pts = pts / torch.sqrt((pts.abs() ** 2).mean() + 1e-300)
    return torch.stack([pts.real, pts.imag])


def mean_power_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest relative gap of the program's mean powers from the
    reference's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / want))


def const_rms_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The RMS distance, over the tap's points, of the program's unit-RMS
    tap from the reference's."""
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(np.sqrt((d ** 2).sum(axis=0).mean()))

"""The plain reference of the wideband front end's channeliser, and its control.

A wideband receiver (the hackrf8 configuration: a HackRF One's 8-bit
signed I/Q at 16.384 MS/s) covers several DAB blocks; each block's
ensemble is its stream mixed down by the block's offset from the centre,
low-pass filtered and decimated to 2.048 MS/s:

    y_b[m] = sum_k h[k] x[D m - k] exp(-j 2 pi f_b (D m - k) / rate)

with x the s8 samples scaled by 1/128 (exact), n = D m - k the sample's
absolute index, and h a Kaiser-windowed sinc designed here from the
configuration's numbers (taps, beta, cutoff), scaled to unity gain at DC.
Plain PyTorch in float64 (TF32 off), with no kernel of the program and
nothing it made; the mixing by direct multiplication, the filter by direct
convolution, both on the device the stream is on, in chunks of outputs so
that a whole step fits on the card. The frames then go to
benchmark/reference.py's mean_power and const_tap.

`precision="fp8"` is the control: the taps and the mixed samples rounded
to float8 e4m3 (and, through reference.py, the FFT window and the DFT
matrix), a step below the f16 taps and bf16 frames the configuration is
served in. It has to come out as not correct.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from benchmark import reference

SCALE = 1.0 / 128.0
CHUNK = 1 << 20          # outputs a pass


def _lower(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float64)
    if precision == "f64":
        return x
    raise ValueError(f"precision {precision!r} not in (f64, fp8)")


def design(taps: int, beta: float, cutoff_hz: float, rate_hz: float,
           precision: str = "f64", device=None) -> torch.Tensor:
    """(taps,) float64: the Kaiser-windowed sinc low-pass, unity DC gain."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = torch.arange(taps, dtype=torch.float64, device=device) - (taps - 1) / 2.0
    w = torch.kaiser_window(taps, periodic=False, beta=beta, dtype=torch.float64, device=device)
    h = w * torch.sinc(2.0 * cutoff_hz / rate_hz * n)
    return _lower(h / h.sum(), precision)


def ddc(stream: torch.Tensor, first_n: int, offsets_hz: Sequence[float], h: torch.Tensor,
        rate_hz: float, decimation: int, precision: str = "f64") -> torch.Tensor:
    """One receiver's stream, (L, 2) int8 I/Q whose sample 0 has absolute
    index first_n -> (blocks, (L - taps) // D + 1) complex128: output j of
    block b is y_b at the m whose window D m - taps + 1 .. D m is stream
    samples D j .. D j + taps - 1. Every offset a whole number of kHz, so
    the mixing phase is taken exactly from the sample's integer index."""
    if stream.dtype != torch.int8 or stream.shape[-1] != 2:
        raise ValueError(f"a wideband stream is (L, 2) int8, got {tuple(stream.shape)} "
                         f"{stream.dtype}")
    dev, taps, d = stream.device, h.numel(), decimation
    x = torch.complex(stream[:, 0].to(torch.float64), stream[:, 1].to(torch.float64)) * SCALE
    n_out = (x.numel() - taps) // d + 1
    period = round(rate_hz / 1000)
    out = torch.empty((len(offsets_hz), n_out), dtype=torch.complex128, device=dev)
    for b, f in enumerate(offsets_hz):
        f_khz = round(f / 1000)
        if abs(f - f_khz * 1000) > 1e-3:
            raise ValueError(f"offset {f} Hz is not a whole number of kHz")
        for j0 in range(0, n_out, CHUNK):
            j1 = min(n_out, j0 + CHUNK)
            lo, hi = d * j0, d * (j1 - 1) + taps
            n = torch.arange(lo, hi, dtype=torch.int64, device=dev) + first_n
            ph = (f_khz * n) % period
            z = x[lo:hi] * torch.polar(torch.ones_like(ph, dtype=torch.float64),
                                       -2.0 * math.pi * ph.to(torch.float64) / period)
            z = torch.complex(_lower(z.real, precision), _lower(z.imag, precision))
            acc = torch.zeros(j1 - j0, dtype=torch.complex128, device=dev)
            for k in range(taps):
                s = taps - 1 - k
                acc += h[k] * z[s: s + d * (j1 - j0): d]
            out[b, j0:j1] = acc
    return out


def mean_power(frames: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """(..., frame_len) complex frames -> (...) mean power, float64."""
    return reference.mean_power(frames.real, frames.imag, precision)


def const_tap(frame: torch.Tensor, freq_hz: float, mode: int = 1,
              precision: str = "f64") -> torch.Tensor:
    """(frame_len,) complex, one frame, and the CFO to take out -> (2, 480)
    float64: the tap's real and imaginary parts."""
    frame = frame.cpu()
    return reference.const_tap(frame.real.contiguous(), frame.imag.contiguous(), freq_hz,
                               mode, precision)


def rms_gap(got_re: torch.Tensor, got_im: torch.Tensor, want: torch.Tensor) -> tuple:
    """(sum |got - want|^2, sum |want|^2), floats: the parts of a relative
    RMS error, to be summed over blocks of frames."""
    dr = got_re.to(torch.float64) - want.real
    di = got_im.to(torch.float64) - want.imag
    return float((dr * dr + di * di).sum()), float((want.abs() ** 2).sum())

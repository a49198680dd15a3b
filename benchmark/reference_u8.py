"""The plain reference of the demod on rtl_sdr's raw IQ, and its control.

rtl_sdr (osmocom rtl-sdr's rtl_sdr and rtl_tcp) delivers 8-bit unsigned
I/Q, interleaved, offset binary around 127.5. The reference converts each
byte exactly, (x - 127.5) / 128 in float64, and hands the two parts to
benchmark/reference.py's mean_power and const_tap, plain PyTorch in
float64 with no kernel of the program and nothing it made.

`precision="fp8"` is the control: the converted parts, the FFT window's
samples and the DFT matrix rounded to float8 e4m3 (reference.py), the step
below the configuration's 8-bit front end. It has to come out as not
correct.
"""

from __future__ import annotations

import torch

from benchmark import reference

OFFSET = 127.5
SCALE = 1.0 / 128.0


def parts(iq: torch.Tensor):
    """(..., frame_len, 2) uint8 I/Q -> (re, im), each (..., frame_len)
    float64: (x - 127.5) / 128, exact."""
    if iq.dtype != torch.uint8 or iq.shape[-1] != 2:
        raise ValueError(f"rtl_sdr IQ is (..., frame_len, 2) uint8, got {tuple(iq.shape)} "
                         f"{iq.dtype}")
    x = (iq.to(torch.float64) - OFFSET) * SCALE
    return x[..., 0], x[..., 1]


def mean_power(iq: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """(..., frame_len, 2) uint8 frames -> (...) mean power, float64."""
    return reference.mean_power(*parts(iq), precision)


def const_tap(iq: torch.Tensor, freq_hz: float, mode: int = 1,
              precision: str = "f64") -> torch.Tensor:
    """(frame_len, 2) uint8, one frame, and the CFO to take out -> (2, 480)
    float64: the tap's real and imaginary parts."""
    return reference.const_tap(*parts(iq), freq_hz, mode, precision)

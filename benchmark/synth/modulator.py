"""OFDM modulator: DAB transmission-frame bits -> baseband IQ (numpy).

Counterpart of tpudab.synth.modulator (EN 300 401 sec 14: DQPSK mapping,
frequency interleaving, PRS) and of its channel impairments, which give
the same samples as tpudab's for the same Impairments and seed. Test and
smoke fixture, host side.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.synth.interleaver import get_carrier_map_positions
from benchmark.synth.ofdm_params import SAMPLING_RATE, get_ofdm_params
from benchmark.synth.prs import get_prs_carriers


def _active_bins(mode: int) -> np.ndarray:
    p = get_ofdm_params(mode)
    k_half = p.nb_data_carriers // 2
    ks = np.array([k for k in range(-k_half, k_half + 1) if k != 0])
    return ks % p.nb_fft


def modulate_frame_bits(frame_bits: np.ndarray, mode: int = 1) -> np.ndarray:
    """One transmission frame of 0/1 bits -> complex64 IQ (nb_frame_length,),
    null symbol silent, unit average power over the rest."""
    p = get_ofdm_params(mode)
    bits = np.asarray(frame_bits, dtype=np.uint8).reshape(
        p.nb_data_symbols, 2 * p.nb_data_carriers)
    k = p.nb_data_carriers
    re = 1.0 - 2.0 * bits[:, :k].astype(np.float32)
    im = 1.0 - 2.0 * bits[:, k:].astype(np.float32)
    q_logical = (re + 1j * im).astype(np.complex64) / np.sqrt(2.0)
    q_carriers = np.zeros_like(q_logical)
    q_carriers[:, get_carrier_map_positions(mode)] = q_logical

    z = np.empty((p.nb_symbols, k), dtype=np.complex64)
    z[0] = get_prs_carriers(mode)
    for l in range(1, p.nb_symbols):
        z[l] = z[l - 1] * q_carriers[l - 1]

    spec = np.zeros((p.nb_symbols, p.nb_fft), dtype=np.complex64)
    spec[:, _active_bins(mode)] = z
    scale = p.nb_fft / np.sqrt(p.nb_data_carriers)
    time = (np.fft.ifft(spec, axis=-1) * scale).astype(np.complex64)
    with_cp = np.concatenate([time[:, -p.nb_cyclic_prefix:], time], axis=-1)

    frame = np.zeros(p.nb_frame_length, dtype=np.complex64)
    frame[p.nb_null_period:] = with_cp.reshape(-1)
    return frame


@dataclasses.dataclass
class Impairments:
    """Channel impairments applied to a synthesised IQ stream."""

    freq_offset_hz: float = 0.0      # carrier frequency offset
    freq_ramp_hz_per_s: float = 0.0  # linear CFO drift (oscillator walk)
    delay_samples: int = 0           # integer sample delay (prepended)
    snr_db: float | None = None      # AWGN SNR vs unit signal power; None = clean
    amplitude: float = 1.0
    phase: float = 0.0
    clock_ppm: float = 0.0           # receiver sample clock x ppm fast: the
                                     # signal appears stretched
    # tapped-delay-line multipath: echoes as (delay_samples, gain,
    # phase_rad) relative to the implicit direct path (delay 0, gain 1)
    multipath: tuple = ()
    seed: int = 0


def apply_impairments(iq: np.ndarray, imp: Impairments,
                      sampling_rate: float = SAMPLING_RATE) -> np.ndarray:
    """Clock offset (linear interpolation), multipath, delay, CFO and its
    ramp, amplitude and phase, then AWGN from default_rng(imp.seed)."""
    x = np.asarray(iq, dtype=np.complex64)
    if imp.clock_ppm:
        # resample on the receiver's time grid t_rx[k] = k / (1 + ppm*1e-6)
        ratio = 1.0 / (1.0 + imp.clock_ppm * 1e-6)
        n_out = int(np.floor((x.shape[0] - 1) / ratio)) + 1
        t_rx = np.arange(n_out, dtype=np.float64) * ratio
        x = (np.interp(t_rx, np.arange(x.shape[0]), x.real)
             + 1j * np.interp(t_rx, np.arange(x.shape[0]), x.imag)
             ).astype(np.complex64)
    if imp.multipath:
        # y[n] = x[n] + sum_k g_k e^{j phi_k} x[n - d_k], before CFO and noise
        max_d = max(int(d) for d, _, _ in imp.multipath)
        y = np.concatenate([x, np.zeros(max_d, np.complex64)])
        for d, g, ph in imp.multipath:
            tap = np.complex64(g * np.exp(1j * ph))
            y[int(d): int(d) + x.shape[0]] += tap * x
        x = y[: x.shape[0] + max_d]
    if imp.delay_samples:
        x = np.concatenate([np.zeros(imp.delay_samples, dtype=np.complex64), x])
    n = np.arange(x.shape[0], dtype=np.float64)
    t = n / sampling_rate
    # instantaneous f(t) = f0 + r*t  ->  phase = 2pi (f0 t + r t^2 / 2)
    rot = np.exp(1j * (2 * np.pi * (imp.freq_offset_hz * t
                                    + 0.5 * imp.freq_ramp_hz_per_s * t * t)
                       + imp.phase))
    x = (imp.amplitude * x * rot).astype(np.complex64)
    if imp.snr_db is not None:
        rng = np.random.default_rng(imp.seed)
        sigma = imp.amplitude * 10.0 ** (-imp.snr_db / 20.0) / np.sqrt(2.0)
        noise = sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
        x = (x + noise).astype(np.complex64)
    return x

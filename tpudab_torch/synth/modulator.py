"""OFDM modulator: DAB transmission-frame bits -> baseband IQ (numpy).

Counterpart of tpudab.synth.modulator (EN 300 401 sec 14: DQPSK mapping,
frequency interleaving, PRS). Test and smoke fixture, host side.
"""

from __future__ import annotations

import numpy as np

from tpudab_torch.constants.interleaver import get_carrier_map_positions
from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.constants.prs import get_prs_carriers


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


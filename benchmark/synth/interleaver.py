"""Frequency interleaver map, ETSI EN 300 401 sec 14.6.

Reference parity: vendor/DAB-Radio `get_DAB_mapper_ref(out, nb_fft)` (proven
API at the reference's src/radio_block.cpp:3,20-21).

Construction (mode-generic): with N = nb_fft,
  R(0) = 0;  R(i) = (13*R(i-1) + N/4 - 1) mod N
Visit i = 1..N-1; keep d = R(i) with N/8 <= d <= 7N/8 and d != N/2; the j-th
kept value maps logical QPSK index j to carrier index k = d - N/2
(k in -K/2..K/2 excluding 0).
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.synth.ofdm_params import get_ofdm_params


@functools.lru_cache(maxsize=None)
def get_carrier_map(mode: int) -> np.ndarray:
    """map[j] = carrier index k for logical (deinterleaved) QPSK index j.

    Shape (K,), values in [-K/2, K/2] \\ {0}. The map is a bijection onto the
    active carriers.
    """
    params = get_ofdm_params(mode)
    n = params.nb_fft
    k_count = params.nb_data_carriers
    lo, hi, dc = n // 8, 7 * n // 8, n // 2
    out = np.empty(k_count, dtype=np.int64)
    r = 0
    j = 0
    for _ in range(1, n):
        r = (13 * r + n // 4 - 1) % n
        if lo <= r <= hi and r != dc:
            out[j] = r - dc
            j += 1
    assert j == k_count, f"interleaver map yielded {j} carriers, expected {k_count}"
    return out


@functools.lru_cache(maxsize=None)
def get_carrier_map_positions(mode: int) -> np.ndarray:
    """map in 'active-carrier array position' space.

    Active carriers ordered by k (-K/2..-1,1..K/2) occupy positions 0..K-1.
    Returns pos[j] such that active_carriers[pos[j]] is where logical QPSK
    index j lives. Useful for vectorized (de)interleaving with jnp.take.
    """
    params = get_ofdm_params(mode)
    k_half = params.nb_data_carriers // 2
    kmap = get_carrier_map(mode)
    pos = np.where(kmap < 0, kmap + k_half, kmap + k_half - 1)
    assert sorted(pos.tolist()) == list(range(params.nb_data_carriers))
    return pos.astype(np.int64)


@functools.lru_cache(maxsize=None)
def get_inverse_map_positions(mode: int) -> np.ndarray:
    """inv[p] = logical QPSK index stored at active-carrier position p."""
    pos = get_carrier_map_positions(mode)
    inv = np.empty_like(pos)
    inv[pos] = np.arange(pos.shape[0])
    return inv

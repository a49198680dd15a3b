"""OFDM sync tunables: counterpart of tpudab.ofdm.sync's SyncConfig and
carrier_spacing_hz. The acquisition itself is ofdm/sync_device.py."""

from __future__ import annotations

import dataclasses

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """Tunables mirroring the reference's OFDM_Demod config surface:
    coarse range, update betas, thresholds."""

    max_coarse_bins: int = 100          # +/- carrier bins of coarse CFO search
    fine_time_search: int = 256         # +/- samples around expected PRS start
    null_threshold_ratio: float = 0.5   # null power must be below ratio * mean
    fine_freq_beta: float = 0.9         # EMA for streaming fine-freq updates
    coarse_freq_beta: float = 0.9       # EMA for streaming coarse updates
    window_offset: int = 12             # FFT window advance into CP
    # multipath first-path detection in the PRS matched filter: pick the
    # earliest correlation peak within threshold_db of the strongest, up to
    # one guard interval ahead, with a distance prior p^(d/CP) discounting
    # far-ahead candidates (p = 1 or threshold = 0: plain argmax)
    impulse_peak_threshold_db: float = 15.0
    impulse_peak_distance_probability: float = 0.15


def carrier_spacing_hz(mode: int) -> float:
    p = get_ofdm_params(mode)
    return SAMPLING_RATE / p.nb_fft

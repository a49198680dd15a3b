"""OFDM front end (counterpart of tpudab.ofdm): acquisition (sync,
sync_device) and the split-real demod (demod)."""

from tpudab_torch.ofdm.demod import active_bin_indices, demod_frames, demod_frames_split
from tpudab_torch.ofdm.sync import SyncConfig, carrier_spacing_hz
from tpudab_torch.ofdm.sync_device import (
    acquire_device, acquire_host, fine_time_sync_device, coarse_freq_device,
    fine_freq_device,
)

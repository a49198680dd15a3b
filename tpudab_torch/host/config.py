"""JSON config with autosave: counterpart of tpudab.host.config. The JSON
files are interchangeable with tpudab's (same fields, same defaults):
RadioConfig mirrors the SDR++ plugin's dab_plugin_config.json and the
runtime-tunable OFDM_Demod::GetConfig() surface (sync betas/thresholds).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

from tpudab_torch.ofdm.sync import SyncConfig


@dataclasses.dataclass
class RadioConfig:
    mode: int = 1
    is_enabled: bool = True
    batch_frames: int = 8
    sink_sample_rate: int = 48_000
    global_gain: float = 1.0
    # OFDM sync tunables (OFDM_Demod::GetConfig parity)
    max_coarse_bins: int = 100
    fine_time_search: int = 256
    null_threshold_ratio: float = 0.5
    fine_freq_beta: float = 0.9
    coarse_freq_beta: float = 0.9
    window_offset: int = 12
    # streaming-loop tunables (StreamingRadio mirrors)
    desync_threshold: float = 0.35
    is_coarse_freq_correction: bool = True
    coarse_check_interval: int = 4
    # live tuner (rtl_tcp): last-tuned Band III channel label, persisted so
    # a restart comes back on the same ensemble (reference config parity)
    channel: Optional[str] = None

    def sync_config(self) -> SyncConfig:
        return SyncConfig(
            max_coarse_bins=self.max_coarse_bins,
            fine_time_search=self.fine_time_search,
            null_threshold_ratio=self.null_threshold_ratio,
            fine_freq_beta=self.fine_freq_beta,
            coarse_freq_beta=self.coarse_freq_beta,
            window_offset=self.window_offset,
        )


class ConfigManager:
    """Load/save RadioConfig as JSON with autosave on set()."""

    def __init__(self, path: str, autosave: bool = True):
        self.path = path
        self.autosave = autosave
        self._lock = threading.Lock()
        self.config = self.load()

    def load(self) -> RadioConfig:
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                fields = {f.name for f in dataclasses.fields(RadioConfig)}
                return RadioConfig(**{k: v for k, v in data.items() if k in fields})
            except (json.JSONDecodeError, TypeError, OSError):
                pass
        return RadioConfig()

    def save(self) -> None:
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dataclasses.asdict(self.config), f, indent=2)
            os.replace(tmp, self.path)

    def set(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if not hasattr(self.config, k):
                raise AttributeError(f"unknown config key {k!r}")
            setattr(self.config, k, v)
        if self.autosave:
            self.save()

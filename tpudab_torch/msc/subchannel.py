"""MSC subchannel decoding: CIF slices -> logical-frame bytes.

Counterpart of tpudab.msc.subchannel: SubchannelConfig (re-declared with
the same fields, since the tpudab module imports jax), subch_cif_slices,
and the host per-stage path's SubchannelDecoder and MSCDecoder.

A SubchannelDecoder lives on one device. Its 15-CIF deinterleave history
is an f32 tensor there; each batch of CIF slices is deinterleaved (kernel
K4 on CUDA), depunctured, Viterbi-decoded (K1 + K3 on CUDA), descrambled
and packed there, and only the bytes come back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from tpudab_torch.constants.dab_params import CIF_BITS, CU_BITS
from tpudab_torch.constants.puncture import PunctureProfile, eep_profile
from tpudab_torch.fec.depuncture import depuncture
from tpudab_torch.fec.prbs import prbs_bytes_on
from tpudab_torch.msc.interleave import TIME_INTERLEAVE_DEPTH, deinterleave_batch
from tpudab_torch.ops.viterbi_cuda import viterbi_decode_best
from tpudab_torch.utils.bits import torch_pack_bits
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device

HISTORY = TIME_INTERLEAVE_DEPTH - 1


@dataclasses.dataclass(frozen=True)
class SubchannelConfig:
    """Static decode geometry for one subchannel."""

    subch_id: int
    start_cu: int
    size_cu: int
    profile: PunctureProfile
    padding_bits: int = 0  # UEP padding appended after the tail
    uep_key: Optional[tuple] = None  # (bitrate_kbps, protection_level) if UEP

    @property
    def slice_bits(self) -> int:
        return self.size_cu * CU_BITS

    @property
    def data_bits(self) -> int:
        """Decoded bits per 24 ms logical frame."""
        return self.profile.data_bits

    @classmethod
    def from_db(cls, sub) -> "SubchannelConfig":
        """From a database Subchannel (tpudab_torch.database.entities)."""
        if sub.is_uep:
            from tpudab_torch.constants.puncture import get_uep_profile_by_index
            uep = get_uep_profile_by_index(sub.uep_index)
            return cls(sub.subch_id, sub.start_cu, uep.size_cu,
                       uep.to_profile(), uep.padding_bits,
                       uep_key=(uep.bitrate_kbps, uep.protection_level))
        profile = eep_profile(sub.size_cu, sub.eep_level, sub.eep_option)
        return cls(sub.subch_id, sub.start_cu, sub.size_cu, profile, 0)


def subch_cif_slices(soft: torch.Tensor, cfg: SubchannelConfig,
                     nb_fic_bits: int, nb_cifs: int) -> torch.Tensor:
    """(rows, nb_frame_bits) flat soft -> (rows, nb_cifs, slice_bits), a
    strided view of the subchannel's window in every CIF."""
    lo = cfg.start_cu * CU_BITS
    msc = soft[:, nb_fic_bits:].reshape(soft.shape[0], nb_cifs, CIF_BITS)
    return msc[:, :, lo: lo + cfg.slice_bits]


def _empty(n_bytes: int):
    return (np.zeros((0, n_bytes), np.uint8), np.zeros(0, bool),
            np.zeros(0, np.int64))


class SubchannelDecoder:
    """Streaming decoder for one subchannel across consecutive CIFs.

    process(cif_soft) consumes (C, slice_bits) soft CIF slices and returns
    (C, data_bytes) decoded logical frames (numpy), a validity mask (False
    for the first 15 CIFs of history warm-up) and the logical frame index
    of each row.
    """

    def __init__(self, config: SubchannelConfig, device=DEFAULT_DEVICE):
        self.config = config
        self.device = resolve_device(device)
        self._history = torch.zeros((HISTORY, config.slice_bits),
                                    dtype=torch.float32, device=self.device)
        self._n_seen = 0
        # online self-calibration for budget-solved ('s') UEP rows: the
        # region table is resolved from the broadcast itself before the
        # first frames are decoded (fec/uep_calibrate.py)
        self.calibration = None
        from tpudab_torch.fec.uep_calibrate import needs_calibration
        self._cal_pending = (config.uep_key is not None
                             and needs_calibration(*config.uep_key))
        self._cal_buf: List[torch.Tensor] = []  # complete logical frames

    def _run_calibration(self, frames: torch.Tensor) -> None:
        """Calibrate on the given complete logical frames and swap
        self.config to the winning table."""
        from tpudab_torch.fec import uep_calibrate as uc

        self._cal_pending = False
        res = uc.calibrate(frames, *self.config.uep_key)
        self.calibration = res
        if res.swapped:
            self.config = dataclasses.replace(
                self.config, profile=res.chosen.to_profile(),
                padding_bits=res.chosen.padding_bits)

    def _maybe_calibrate(self, logical: torch.Tensor) -> bool:
        """Accumulate complete logical frames and, once there are enough,
        run the UEP table calibration. While it is pending, process() holds
        all output. Returns True once calibration is resolved."""
        from tpudab_torch.fec import uep_calibrate as uc

        fresh = logical[max(HISTORY - self._n_seen, 0):]   # logical index >= 0
        if fresh.shape[0]:
            self._cal_buf.append(fresh)
        if sum(f.shape[0] for f in self._cal_buf) < uc.CALIBRATION_FRAMES:
            return False
        self._run_calibration(torch.cat(self._cal_buf)[: uc.CALIBRATION_FRAMES])
        return True

    def _decode(self, logical: torch.Tensor) -> np.ndarray:
        """(C, slice_bits) logical soft frames -> (C, data_bytes) bytes."""
        cfg = self.config
        n = cfg.slice_bits
        body = logical[:, : n - cfg.padding_bits] if cfg.padding_bits else logical
        mother = depuncture(body, cfg.profile).reshape(logical.shape[0],
                                                       cfg.data_bits + 6, 4)
        bits = viterbi_decode_best(mother, cfg.data_bits)
        by = torch_pack_bits(bits) ^ prbs_bytes_on(cfg.data_bits // 8, bits.device)
        return by.cpu().numpy()

    def _release_held(self):
        frames = torch.cat(self._cal_buf)
        self._cal_buf = []
        return frames

    def process(self, cif_soft):
        cif_soft = torch.as_tensor(cif_soft, dtype=torch.float32, device=self.device)
        c, n = cif_soft.shape
        if n != self.config.slice_bits:
            raise ValueError(f"CIF slices of {n} bits, subchannel {self.config.subch_id} "
                             f"has {self.config.slice_bits}")
        buf = torch.cat([self._history, cif_soft], dim=0)          # (15 + C, n)
        logical = deinterleave_batch(buf, c)                       # (C, n)
        self._history = buf[-HISTORY:].clone()

        if self._cal_pending:
            done = self._maybe_calibrate(logical)
            self._n_seen += c
            if not done:
                # hold: nothing is decoded until the table is verified
                return _empty(self.config.data_bits // 8)
            # decode everything held (all complete frames so far) at once
            # under the winning table and emit it with its indices
            frames = self._release_held()
            m = frames.shape[0]
            return self._decode(frames), np.ones(m, bool), np.arange(m)

        out = self._decode(logical)
        # logical frame m = n_seen - 15 + row: with the new batch of C CIFs,
        # frames n_seen-15 .. n_seen+C-16 became complete (frame m needs
        # CIFs m..m+15). Rows with m < 0 are warm-up (zero history).
        idx = np.arange(c) + self._n_seen - HISTORY
        self._n_seen += c
        return out, idx >= 0, idx

    def flush(self):
        """End of stream: if calibration still holds frames (a capture
        shorter than CALIBRATION_FRAMES complete frames after discovery),
        calibrate on what is held and emit it. Returns (bytes, valid, idx)
        like process()."""
        if not (self._cal_pending and self._cal_buf):
            return _empty(self.config.data_bits // 8)
        frames = self._release_held()
        self._run_calibration(frames)
        m = frames.shape[0]
        return self._decode(frames), np.ones(m, bool), np.arange(m)

    def reset(self):
        self._history = torch.zeros_like(self._history)
        self._n_seen = 0
        self._cal_buf = []  # the calibration lock itself survives a resync


class MSCDecoder:
    """Decodes all configured subchannels from transmission-frame soft bits
    on one device."""

    def __init__(self, configs: List[SubchannelConfig], nb_cifs: int, cif_bits: int,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.configs = {c.subch_id: c for c in configs}
        self.decoders = {c.subch_id: SubchannelDecoder(c, self.device) for c in configs}
        self.nb_cifs = nb_cifs
        self.cif_bits = cif_bits

    def process_frames(self, msc_soft) -> Dict[int, tuple]:
        """msc_soft: (F, nb_cifs * cif_bits) -> {subch_id: (bytes, valid, idx)}."""
        msc = torch.as_tensor(msc_soft, dtype=torch.float32, device=self.device)
        cifs = msc.reshape(msc.shape[0] * self.nb_cifs, self.cif_bits)
        out = {}
        for subch_id, cfg in self.configs.items():
            lo = cfg.start_cu * CU_BITS
            out[subch_id] = self.decoders[subch_id].process(cifs[:, lo: lo + cfg.slice_bits])
        return out

    def reset(self):
        for d in self.decoders.values():
            d.reset()

"""Subchannel decode geometry and CIF slicing.

Counterpart of tpudab.msc.subchannel's SubchannelConfig (re-declared with
the same fields, since the tpudab module imports jax) and
subch_cif_slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpudab.constants.dab_params import CIF_BITS, CU_BITS
from tpudab.constants.puncture import PunctureProfile


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


def subch_cif_slices(soft: torch.Tensor, cfg: SubchannelConfig,
                     nb_fic_bits: int, nb_cifs: int) -> torch.Tensor:
    """(rows, nb_frame_bits) flat soft -> (rows, nb_cifs, slice_bits), a
    strided view of the subchannel's window in every CIF."""
    lo = cfg.start_cu * CU_BITS
    msc = soft[:, nb_fic_bits:].reshape(soft.shape[0], nb_cifs, CIF_BITS)
    return msc[:, :, lo: lo + cfg.slice_bits]

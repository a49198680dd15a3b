"""Database entities: Ensemble, Service (with country/ECC accessors),
ServiceComponent (transport mode, audio/data type), Subchannel (start addr,
capacity units, UEP/EEP), LinkService, FM_Service, DRM_Service.

Counterpart of tpudab.database.entities, rewritten here because the
tpudab.database package imports jax.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from tpudab_torch.constants.tables import country_str, language_str, programme_type_str
from tpudab_torch.constants.puncture import eep_bitrate_kbps, uep_index_order


class TransportMode(enum.IntEnum):
    STREAM_AUDIO = 0
    STREAM_DATA = 1
    FIDC = 2
    PACKET_DATA = 3


class AudioServiceType(enum.IntEnum):
    DAB = 0        # MPEG-1/2 layer II
    DAB_PLUS = 63  # AAC superframes


class DataServiceType(enum.IntEnum):
    TDC = 5
    MOT = 60
    TRANSPARENT = 0
    PROPRIETARY = 61


@dataclasses.dataclass
class Ensemble:
    ensemble_id: int = 0
    label: str = ""
    ecc: int = 0
    lto_half_hours: int = 0
    inter_table_id: int = 0
    cif_counter: int = 0
    alarm: bool = False

    @property
    def country(self) -> str:
        return country_str(self.ecc, (self.ensemble_id >> 12) & 0xF)


@dataclasses.dataclass
class Subchannel:
    subch_id: int
    start_cu: int = 0
    size_cu: int = 0
    is_uep: bool = False
    uep_index: int = 0
    eep_level: int = 0   # 1..4
    eep_option: int = 0  # 0 = set A, 1 = set B
    fec_scheme: int = 0

    @property
    def bitrate_kbps(self) -> Optional[int]:
        if self.is_uep:
            keys = uep_index_order()
            if 0 <= self.uep_index < len(keys):
                return keys[self.uep_index][0]
            return None
        if self.eep_level:
            try:
                return eep_bitrate_kbps(self.size_cu, self.eep_level, self.eep_option)
            except (KeyError, ZeroDivisionError):
                return None
        return None

    @property
    def protection_label(self) -> str:
        """render_formatters.cpp:9-25 parity (UEP/EEP descriptor strings)."""
        if self.is_uep:
            return f"UEP {self.uep_index}"
        if self.eep_level:
            return f"EEP {self.eep_level}-{'A' if self.eep_option == 0 else 'B'}"
        return "?"


@dataclasses.dataclass
class ServiceComponent:
    service_id: int
    component_id: int = 0           # SCIdS / index within service
    transport_mode: TransportMode = TransportMode.STREAM_AUDIO
    audio_type: Optional[int] = None   # ASCTy for TMId 0
    data_type: Optional[int] = None    # DSCTy for TMId 1/3
    subch_id: Optional[int] = None
    scid: Optional[int] = None         # packet-mode service component id
    is_primary: bool = True
    language: Optional[int] = None
    label: str = ""
    packet_address: Optional[int] = None
    dg_flag: int = 0

    @property
    def is_audio(self) -> bool:
        return self.transport_mode == TransportMode.STREAM_AUDIO

    @property
    def is_dab_plus(self) -> Optional[bool]:
        if not self.is_audio or self.audio_type is None:
            return None
        return self.audio_type == AudioServiceType.DAB_PLUS


@dataclasses.dataclass
class Service:
    service_id: int
    label: str = ""
    programme_type: int = 0
    language: int = 0
    country_id: int = 0
    ecc: int = 0
    components: List[int] = dataclasses.field(default_factory=list)  # keys into db

    @property
    def country_id_from_sid(self) -> int:
        return (self.service_id >> 12) & 0xF

    @property
    def programme_type_str(self) -> str:
        return programme_type_str(self.programme_type)

    @property
    def language_str(self) -> str:
        return language_str(self.language)


@dataclasses.dataclass
class LinkService:
    link_session: int
    active: bool = False
    hard: bool = False
    international: bool = False
    service_id: int = 0


@dataclasses.dataclass
class FMService:
    rds_pi: int
    link_session: int = 0
    frequencies: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DRMService:
    drm_id: int
    link_session: int = 0
    frequencies: List[int] = dataclasses.field(default_factory=list)

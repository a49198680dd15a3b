"""Ensemble synthesizer: services/subchannels -> FIC FIGs + coded MSC -> frame bits.

Counterpart of tpudab.synth.ensemble without jax, so that the smoke run can
synthesise the bench's signal on a machine that has no jax. Gives the same
bits and IQ as tpudab.synth for the same spec and seed. Covers stream and
packet-mode components (FIG 0/2 in its SCId form, with FIG 0/3 for packet
address 2), EEP and UEP subchannels, and FM and DRM service links
(FIG 0/6 + FIG 0/21).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.synth.dab_params import (get_dab_params, CIF_BITS, CIF_CU,
                                         CU_BITS, FIB_BYTES)
from benchmark.synth.puncture import (FIC_PROFILE, FIC_PROFILE_MODE3,
                                       PunctureProfile, eep_bitrate_kbps,
                                       eep_profile, get_uep_index_table,
                                       get_uep_profile)
from benchmark.synth.coding import (TIME_INTERLEAVE_DEPTH, conv_encode, descramble_bits,
                                     interleave_delays, puncture, unpack_bits)
from benchmark.synth.crc import crc16_append
from benchmark.synth.modulator import modulate_frame_bits

ASCTY_DAB = 0        # MPEG-1/2 layer II audio
ASCTY_DAB_PLUS = 63  # AAC superframes
TMID_STREAM_AUDIO = 0
TMID_STREAM_DATA = 1
TMID_PACKET_DATA = 3


@dataclasses.dataclass
class SubchannelSpec:
    subch_id: int
    start_cu: int
    size_cu: int
    protection: tuple  # ('eep', level 1..4, option 0|1) or ('uep', bitrate, level)

    def profile(self) -> PunctureProfile:
        kind = self.protection[0]
        if kind == "eep":
            return eep_profile(self.size_cu, self.protection[1], self.protection[2])
        if kind == "uep":
            return get_uep_profile(self.protection[1], self.protection[2]).to_profile()
        raise ValueError(self.protection)

    @property
    def bitrate_kbps(self) -> int:
        if self.protection[0] == "eep":
            return eep_bitrate_kbps(self.size_cu, self.protection[1], self.protection[2])
        return self.protection[1]

    @property
    def data_bits_per_frame(self) -> int:
        """Convolutional input bits per 24 ms logical frame."""
        return self.bitrate_kbps * 24

    @property
    def uep_padding_bits(self) -> int:
        if self.protection[0] == "uep":
            return get_uep_profile(self.protection[1], self.protection[2]).padding_bits
        return 0


@dataclasses.dataclass
class ServiceSpec:
    service_id: int
    label: str
    components: list  # [(tmid, ascty_or_dscty, subch_id)]
    programme_type: int = 0
    language: int = 0x09
    country_id: int = 0xC  # UK by default (with ECC 0xE1)


@dataclasses.dataclass
class FMLinkSpec:
    """Linked FM service (RDS PI + frequency list) for FIG 0/6 + 0/21."""

    service_id: int         # DAB service the FM service is linked to
    rds_pi: int
    frequencies_hz: list    # FM frequencies
    link_session: int = 1


@dataclasses.dataclass
class DRMLinkSpec:
    """Linked DRM service (DRM id + frequency list) for FIG 0/6 + 0/21."""

    service_id: int
    drm_id: int
    frequencies_hz: list
    link_session: int = 2


@dataclasses.dataclass
class EnsembleSpec:
    ensemble_id: int
    label: str
    services: list
    subchannels: list
    ecc: int = 0xE1
    lto_half_hours: int = 0
    inter_table_id: int = 1
    fm_links: list = dataclasses.field(default_factory=list)
    drm_links: list = dataclasses.field(default_factory=list)


def _label16(s: str) -> bytes:
    b = s.encode("latin-1", "replace")[:16]
    return b + b" " * (16 - len(b))


def _fig0_6(link_session: int, idlq: int, ident: int) -> bytes:
    """FIG 0/6 body: one linkage set (Id list flag 1, LA 1 = active, S/H 0,
    ILS 0) with its LSN and one 16-bit id of list qualifier idlq."""
    b0 = (1 << 7) | (1 << 6) | ((link_session >> 8) & 0x0F)
    return bytes([0x06, b0, link_session & 0xFF, (idlq << 5) | 1,
                  ident >> 8, ident & 0xFF])


class _FIGWriter:
    """Accumulates FIGs and packs them into CRC'd FIBs."""

    def __init__(self):
        self.figs = []

    def add(self, fig_type: int, payload: bytes):
        assert 1 <= len(payload) <= 29
        self.figs.append(bytes([(fig_type << 5) | len(payload)]) + payload)

    def add_list(self, fig_type: int, header: bytes, items: list):
        """Add a list FIG, segmented across FIGs of at most 29 bytes."""
        body = bytearray(header)
        for it in items:
            assert len(header) + len(it) <= 29, "single entry exceeds a FIG"
            if len(body) + len(it) > 29:
                self.add(fig_type, bytes(body))
                body = bytearray(header)
            body += it
        if len(body) > len(header):
            self.add(fig_type, bytes(body))

    def pack_fibs(self, n_fibs: int) -> np.ndarray:
        """Pack into n_fibs FIBs of 30 data bytes: greedy in FIG order (as
        tpudab's synthesizer, so the bits are the same), or, where that
        overflows (more services than tpudab's synthesizer fits in a
        frame), first-fit decreasing: each FIG, largest first, into the
        first FIB with room for it."""
        bodies = [b""]
        for fig in self.figs:
            if len(bodies[-1]) + len(fig) > 30:
                bodies.append(b"")
            bodies[-1] += fig
        if len(bodies) > n_fibs:
            bodies = [b""] * n_fibs
            for fig in sorted(self.figs, key=len, reverse=True):
                k = next((i for i, b in enumerate(bodies) if len(b) + len(fig) <= 30), None)
                assert k is not None, f"the FIGs do not fit in {n_fibs} FIBs"
                bodies[k] += fig
        bodies += [b""] * (n_fibs - len(bodies))
        fibs = []
        for body in bodies:
            if len(body) < 30:
                body += b"\xff"  # end marker
            body += b"\x00" * (30 - len(body))
            fibs.append(crc16_append(np.frombuffer(body, dtype=np.uint8)))
        return np.stack(fibs)


class EnsembleSynthesizer:
    """Builds transmission-frame bits (and IQ) for a described ensemble.
    Payload bytes per subchannel logical frame come from payload_fn or from
    a seeded PRNG stream."""

    def __init__(self, spec: EnsembleSpec, mode: int = 1, seed: int = 1234):
        self.spec = spec
        self.mode = mode
        self.dab = get_dab_params(mode)
        self.rng = np.random.default_rng(seed)
        self.payload_fn = {}   # subch_id -> fn(logical_frame_idx) -> bytes
        self._payload_cache = {}
        self._coded_cache = {}   # (subch_id, logical_idx) -> slice bits
        used = np.zeros(CIF_CU, dtype=bool)
        for sub in spec.subchannels:
            if sub.protection[0] == "uep":
                expect = get_uep_profile(sub.protection[1], sub.protection[2]).size_cu
                assert sub.size_cu == expect, (
                    f"subchannel {sub.subch_id}: UEP {sub.protection[1]}kbps "
                    f"PL{sub.protection[2]} requires size {expect} CU, got {sub.size_cu}")
            seg = used[sub.start_cu: sub.start_cu + sub.size_cu]
            assert not seg.any(), f"subchannel {sub.subch_id} overlaps"
            seg[:] = True
        self.cif_counter = 0

    # ---------------- FIC ----------------

    def _build_figs(self, frame_idx: int) -> _FIGWriter:
        w = _FIGWriter()
        spec = self.spec
        cif = self.cif_counter % 5000
        # FIG 0/0 ensemble info: EId(16) Change(2) Al(1) CIFcnt(13)
        w.add(0, bytes([0x00, spec.ensemble_id >> 8, spec.ensemble_id & 0xFF,
                        (cif // 250) % 20, cif % 250]))
        # FIG 0/1 subchannel organisation (long form EEP / short form UEP)
        uep_index = get_uep_index_table()
        items = []
        for sub in spec.subchannels:
            it = bytes([(sub.subch_id << 2) | (sub.start_cu >> 8),
                        sub.start_cu & 0xFF])
            if sub.protection[0] == "eep":
                level, option = sub.protection[1], sub.protection[2]
                b0 = 0x80 | (option << 4) | ((level - 1) << 2) | (sub.size_cu >> 8)
                it += bytes([b0, sub.size_cu & 0xFF])
            else:
                it += bytes([uep_index[(sub.protection[1], sub.protection[2])] & 0x3F])
            items.append(it)
        w.add_list(0, bytes([0x01]), items)
        # FIG 0/2 service organisation (primary components, no CA)
        items = []
        packet_comps = []
        for svc in spec.services:
            it = bytes([svc.service_id >> 8, svc.service_id & 0xFF,
                        len(svc.components) & 0x0F])
            for (tmid, ty, subch_id) in svc.components:
                if tmid == TMID_PACKET_DATA:
                    # SCId == subch_id by synth convention; FIG 0/3 links it
                    scid = subch_id
                    it += bytes([(tmid << 6) | ((scid >> 6) & 0x3F),
                                 ((scid & 0x3F) << 2) | (1 << 1)])
                    packet_comps.append((scid, ty, subch_id))
                else:
                    it += bytes([(tmid << 6) | (ty & 0x3F), (subch_id << 2) | (1 << 1)])
            items.append(it)
        w.add_list(0, bytes([0x02]), items)
        # FIG 0/3 packet-mode component: SCId -> subchannel, DSCTy, packet
        # address 2 (no data groups flag)
        if packet_comps:
            w.add_list(0, bytes([0x03]), [
                bytes([(scid >> 4) & 0xFF, (scid & 0x0F) << 4, dscty & 0x3F,
                       subch_id << 2, 0x02])
                for (scid, dscty, subch_id) in packet_comps])
        # FIG 0/9 country/LTO/ECC + international table
        w.add(0, bytes([0x09, abs(spec.lto_half_hours) & 0x3F, spec.ecc,
                        spec.inter_table_id]))
        # FIG 0/17 programme type per service
        for svc in spec.services:
            w.add(0, bytes([0x11, svc.service_id >> 8, svc.service_id & 0xFF,
                            0b00000000, svc.programme_type & 0x1F]))
        # FIG 0/6 service linkage + FIG 0/21 frequency information per
        # link: FM (IdLQ 1, RDS PI; R&M 8) and DRM (IdLQ 2; R&M 6)
        for link in spec.fm_links:
            w.add(0, _fig0_6(link.link_session, 1, link.rds_pi))
            fi = bytes([link.rds_pi >> 8, link.rds_pi & 0xFF,
                        (8 << 4) | len(link.frequencies_hz)])
            fi += bytes(round((f_hz - 87_500_000) / 100_000)
                        for f_hz in link.frequencies_hz)
            w.add(0, bytes([0x15, 0x00, len(fi) & 0x1F]) + fi)
        for link in spec.drm_links:
            w.add(0, _fig0_6(link.link_session, 2, link.drm_id))
            fi = bytearray([link.drm_id >> 8, link.drm_id & 0xFF,
                            (6 << 4) | (1 + 2 * len(link.frequencies_hz)),
                            link.drm_id & 0xFF])
            for f_hz in link.frequencies_hz:
                khz = f_hz // 1000
                fi += bytes([(khz >> 8) & 0x7F, khz & 0xFF])
            w.add(0, bytes([0x15, 0x00, len(fi) & 0x1F]) + bytes(fi))
        # FIG 1/0 ensemble label, FIG 1/1 programme service labels
        w.add(1, bytes([0x00, spec.ensemble_id >> 8, spec.ensemble_id & 0xFF])
              + _label16(spec.label) + b"\x00\x00")
        for svc in spec.services:
            w.add(1, bytes([0x01, svc.service_id >> 8, svc.service_id & 0xFF])
                  + _label16(svc.label) + b"\x00\x00")
        return w

    def build_fic_bits(self, frame_idx: int) -> np.ndarray:
        """Punctured FIC bits (0/1) for one transmission frame."""
        fibs = self._build_figs(frame_idx).pack_fibs(self.dab.nb_fibs)
        groups = fibs.reshape(self.dab.nb_fib_groups,
                              self.dab.nb_fibs_per_group * FIB_BYTES)
        profile = FIC_PROFILE_MODE3 if self.mode == 3 else FIC_PROFILE
        return np.concatenate([
            puncture(conv_encode(descramble_bits(unpack_bits(g))), profile)
            for g in groups])

    # ---------------- MSC ----------------

    def payload_for(self, sub: SubchannelSpec, logical_idx: int) -> bytes:
        key = (sub.subch_id, logical_idx)
        if key not in self._payload_cache:
            fn = self.payload_fn.get(sub.subch_id)
            nbytes = sub.data_bits_per_frame // 8
            if fn is None:
                data = self.rng.integers(0, 256, nbytes).astype(np.uint8).tobytes()
            else:
                data = fn(logical_idx)
                assert len(data) == nbytes, (len(data), nbytes)
            self._payload_cache[key] = data
        return self._payload_cache[key]

    def _coded_logical_frame(self, sub: SubchannelSpec, logical_idx: int) -> np.ndarray:
        """Scramble + encode + puncture one logical frame -> slice bits,
        made once: each logical frame is spread over 16 CIFs."""
        key = (sub.subch_id, logical_idx)
        if key not in self._coded_cache:
            self._coded_cache[key] = self._code_logical_frame(sub, logical_idx)
        return self._coded_cache[key]

    def _code_logical_frame(self, sub: SubchannelSpec, logical_idx: int) -> np.ndarray:
        data = np.frombuffer(self.payload_for(sub, logical_idx), dtype=np.uint8)
        punctured = puncture(conv_encode(descramble_bits(unpack_bits(data))),
                             sub.profile())
        pad = sub.uep_padding_bits
        if pad:
            punctured = np.concatenate([punctured, np.zeros(pad, dtype=punctured.dtype)])
        assert punctured.shape[0] == sub.size_cu * CU_BITS
        return punctured

    def build_cif_bits(self, cif_idx: int) -> np.ndarray:
        """One CIF (55,296 bits) with every subchannel time-interleaved:
        bit i of a subchannel's slice is bit i of its logical frame
        cif_idx - d(i mod 16), zero before frame 0 (the last row of
        interleave_np over the 16 frames up to cif_idx)."""
        cif = np.zeros(CIF_BITS, dtype=np.uint8)
        depth = TIME_INTERLEAVE_DEPTH
        for sub in self.spec.subchannels:
            n = sub.size_cu * CU_BITS
            frames = np.stack([self._coded_logical_frame(sub, m) if m >= 0
                               else np.zeros(n, dtype=np.uint8)
                               for m in range(cif_idx - depth + 1, cif_idx + 1)])
            start = sub.start_cu * CU_BITS
            cif[start: start + n] = frames[depth - 1 - interleave_delays(n), np.arange(n)]
        return cif

    # ---------------- frames ----------------

    def frame_bits(self, frame_idx: int) -> np.ndarray:
        """All bits (FIC + MSC CIFs) of one transmission frame."""
        fic = self.build_fic_bits(frame_idx)
        cifs = [self.build_cif_bits(frame_idx * self.dab.nb_cifs + c)
                for c in range(self.dab.nb_cifs)]
        self.cif_counter += self.dab.nb_cifs
        bits = np.concatenate([fic] + cifs)
        assert bits.shape[0] == self.dab.nb_frame_bits
        return bits

    def frames_iq(self, n_frames: int) -> np.ndarray:
        """n_frames transmission frames of clean baseband IQ, concatenated."""
        self.cif_counter = 0
        return np.concatenate([modulate_frame_bits(self.frame_bits(i), self.mode)
                               for i in range(n_frames)])

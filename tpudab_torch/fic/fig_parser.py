"""FIG parser: FIB bytes -> typed events for the DAB database updater.

ETSI EN 300 401 sec 5.2, 8.1 (FIG type 0 extensions) and 8.1.13+ (type 1
labels): FIG 0/x ensemble, subchannel org, service org, components,
datetime, LTO, country, linkage FM/DRM; FIG 1/x labels. Counterpart of
tpudab.fic.fig_parser (pure Python; rewritten here because tpudab.fic
imports jax), held equal to it by tests/test_torch_parsers.py.

Events are plain dataclass records; unknown extensions are surfaced as
`unhandled` events (counted, never fatal) so coverage gaps are observable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class FIGEvent:
    kind: str           # e.g. "ensemble", "subchannel", "service_component"
    data: Dict[str, Any]


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        return (self.u8() << 8) | self.u8()

    def u32(self) -> int:
        return (self.u16() << 16) | self.u16()

    def take(self, n: int) -> bytes:
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v


def parse_fib(fib: np.ndarray) -> List[FIGEvent]:
    """Parse the 30 data bytes of one CRC-valid FIB into FIG events."""
    data = bytes(np.asarray(fib, dtype=np.uint8)[:30].tobytes())
    events: List[FIGEvent] = []
    pos = 0
    while pos < 30:
        header = data[pos]
        if header == 0xFF:  # end marker
            break
        fig_type = header >> 5
        length = header & 0x1F
        if length == 0 or pos + 1 + length > 30:
            break
        payload = data[pos + 1 : pos + 1 + length]
        pos += 1 + length
        if fig_type == 0:
            events.extend(_parse_fig0(payload))
        elif fig_type == 1:
            events.extend(_parse_fig1(payload))
        else:
            events.append(FIGEvent("unhandled", {"fig_type": fig_type}))
    return events


# ---------------- FIG type 0 ----------------

def _parse_fig0(payload: bytes) -> Iterator[FIGEvent]:
    r = _Reader(payload)
    b0 = r.u8()
    cn, oe, pd = (b0 >> 7) & 1, (b0 >> 6) & 1, (b0 >> 5) & 1
    ext = b0 & 0x1F
    ctx = {"cn": cn, "oe": oe, "pd": pd}
    handler = _FIG0_HANDLERS.get(ext)
    if handler is None:
        yield FIGEvent("unhandled", {"fig_type": 0, "extension": ext})
        return
    try:
        yield from handler(r, ctx)
    except (IndexError, ValueError):
        yield FIGEvent("parse_error", {"fig_type": 0, "extension": ext})


def _sid(r: _Reader, pd: int) -> int:
    return r.u32() if pd else r.u16()


def _fig0_0(r, ctx):
    eid = r.u16()
    b = r.u8()
    change, al = (b >> 6) & 3, (b >> 5) & 1
    hi = b & 0x1F
    lo = r.u8()
    cif = hi * 250 + lo
    if change:
        r.u8()  # occurrence change
    yield FIGEvent("ensemble", {"ensemble_id": eid, "change_flags": change,
                                "alarm": al, "cif_counter": cif})


def _fig0_1(r, ctx):
    while r.remaining() >= 3:
        b0, b1 = r.u8(), r.u8()
        subch_id = b0 >> 2
        start = ((b0 & 3) << 8) | b1
        b2 = r.u8()
        if b2 & 0x80:  # long form
            b3 = r.u8()
            option = (b2 >> 4) & 7
            level = ((b2 >> 2) & 3) + 1
            size = ((b2 & 3) << 8) | b3
            yield FIGEvent("subchannel", {
                "subch_id": subch_id, "start_cu": start, "size_cu": size,
                "is_uep": False, "eep_level": level, "eep_option": option})
        else:  # short form: UEP table index
            yield FIGEvent("subchannel", {
                "subch_id": subch_id, "start_cu": start,
                "is_uep": True, "table_switch": (b2 >> 6) & 1,
                "uep_index": b2 & 0x3F})


def _fig0_2(r, ctx):
    pd = ctx["pd"]
    while r.remaining() >= (5 if pd else 3):
        sid = _sid(r, pd)
        b = r.u8()
        n_comp = b & 0x0F
        for _ in range(n_comp):
            c0, c1 = r.u8(), r.u8()
            tmid = c0 >> 6
            if tmid in (0, 1, 2):
                yield FIGEvent("service_component", {
                    "service_id": sid, "tmid": tmid, "ty": c0 & 0x3F,
                    "subch_id": c1 >> 2, "ps": (c1 >> 1) & 1, "ca": c1 & 1})
            else:  # packet mode: SCId
                yield FIGEvent("service_component", {
                    "service_id": sid, "tmid": tmid,
                    "scid": ((c0 & 0x3F) << 6) | (c1 >> 2),
                    "ps": (c1 >> 1) & 1, "ca": c1 & 1})


def _fig0_3(r, ctx):
    # service component in packet mode with SCId
    while r.remaining() >= 5:
        b0, b1 = r.u8(), r.u8()
        scid = (b0 << 4) | (b1 >> 4)
        flag = b1 & 1  # SCCA flag
        b2, b3, b4 = r.u8(), r.u8(), r.u8()
        dscty = b2 & 0x3F
        dg_flag = (b2 >> 7) & 1
        subch_id = b3 >> 2
        packet_addr = ((b3 & 3) << 8) | b4
        if flag and r.remaining() >= 2:
            r.u16()
        yield FIGEvent("packet_component", {
            "scid": scid, "dscty": dscty, "dg_flag": dg_flag,
            "subch_id": subch_id, "packet_address": packet_addr})


def _fig0_5(r, ctx):
    # service component language (short form only)
    while r.remaining() >= 2:
        b0 = r.u8()
        if b0 & 0x80:  # long form SCId
            if r.remaining() < 2:
                break
            b1 = r.u8()
            lang = r.u8()
            yield FIGEvent("component_language", {
                "scid": ((b0 & 0x0F) << 8) | b1, "language": lang})
        else:
            lang = r.u8()
            yield FIGEvent("component_language", {
                "subch_id": b0 & 0x3F, "language": lang})


def _fig0_6(r, ctx):
    # service linking information
    while r.remaining() >= 2:
        b0, b1 = r.u8(), r.u8()
        id_list_flag = (b0 >> 7) & 1
        la = (b0 >> 6) & 1
        sh = (b0 >> 5) & 1
        ils = (b0 >> 4) & 1
        lsn = ((b0 & 0x0F) << 8) | b1
        ev = {"link_session": lsn, "active": la, "hard": sh, "international": ils}
        if not id_list_flag:
            yield FIGEvent("service_linkage", ev)
            continue
        b2 = r.u8()
        idlq = (b2 >> 5) & 3
        n_ids = b2 & 0x0F
        ids = []
        for _ in range(n_ids):
            if ctx["pd"]:
                ids.append(r.u32())
            elif ils:
                ecc = r.u8()
                ids.append((ecc << 16) | r.u16())
            else:
                ids.append(r.u16())
        ev.update({"id_list_qualifier": idlq, "ids": ids})
        yield FIGEvent("service_linkage", ev)


def _fig0_8(r, ctx):
    pd = ctx["pd"]
    while r.remaining() >= (4 if pd else 2):
        sid = _sid(r, pd)
        b = r.u8()
        ext_flag = (b >> 7) & 1
        scids = b & 0x0F
        b1 = r.u8()
        if b1 & 0x80:  # long form
            b2 = r.u8()
            scid = ((b1 & 0x0F) << 8) | b2
            ev = {"service_id": sid, "scids": scids, "scid": scid}
        else:
            ev = {"service_id": sid, "scids": scids, "subch_id": b1 & 0x3F}
        if ext_flag:
            r.u8()
        yield FIGEvent("component_global", ev)


def _fig0_9(r, ctx):
    b0 = r.u8()
    lto = b0 & 0x3F
    if (b0 >> 6) & 1:
        lto = -lto
    ecc = r.u8()
    table_id = r.u8()
    yield FIGEvent("country_lto", {"lto_half_hours": lto, "ecc": ecc,
                                   "inter_table_id": table_id})


def _fig0_10(r, ctx):
    # date & time: RFU(1) MJD(17) LSI(1) RFA(1) UTC flag(1) + time
    b = [r.u8() for _ in range(4)]
    val = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    mjd = (val >> 14) & 0x1FFFF
    lsi = (val >> 13) & 1
    utc_long = (val >> 11) & 1
    hours = (val >> 6) & 0x1F
    minutes = val & 0x3F
    ev = {"mjd": mjd, "leap_second": lsi, "hours": hours, "minutes": minutes,
          "seconds": 0, "milliseconds": 0}
    if utc_long and r.remaining() >= 2:
        b4, b5 = r.u8(), r.u8()
        ev["seconds"] = b4 >> 2
        ev["milliseconds"] = ((b4 & 3) << 8) | b5
    yield FIGEvent("datetime", ev)


def _fig0_13(r, ctx):
    pd = ctx["pd"]
    sid = _sid(r, pd)
    b = r.u8()
    scids = b >> 4
    n_apps = b & 0x0F
    for _ in range(n_apps):
        a0, a1 = r.u8(), r.u8()
        ua_type = (a0 << 3) | (a1 >> 5)
        ua_len = a1 & 0x1F
        ua_data = r.take(ua_len)
        yield FIGEvent("user_application", {
            "service_id": sid, "scids": scids, "ua_type": ua_type,
            "ua_data": ua_data})


def _fig0_14(r, ctx):
    # FEC subchannel organization (packet mode)
    while r.remaining() >= 1:
        b = r.u8()
        yield FIGEvent("subchannel_fec", {"subch_id": b >> 2, "fec_scheme": b & 3})


def _fig0_17(r, ctx):
    while r.remaining() >= 3:
        sid = r.u16()
        b = r.u8()
        sd = (b >> 7) & 1
        l_flag = (b >> 5) & 1
        cc_flag = (b >> 4) & 1
        lang = r.u8() if l_flag else None
        b2 = r.u8() if r.remaining() >= 1 else 0
        pty = b2 & 0x1F
        ev = {"service_id": sid, "dynamic": sd, "programme_type": pty}
        if lang is not None:
            ev["language"] = lang
        yield FIGEvent("programme_type", ev)


def _fig0_21(r, ctx):
    # frequency information (linked FM/DRM/other ensembles)
    while r.remaining() >= 2:
        b0, b1 = r.u8(), r.u8()
        # Rfa(11) + length of FI list(5)
        fi_len = b1 & 0x1F
        end = r.pos + fi_len
        while r.pos + 3 <= min(end, len(r.buf)):
            id_field = r.u16()
            b = r.u8()
            rm = b >> 4
            continuity = (b >> 3) & 1
            n_freq_bytes = b & 7
            freqs = []
            if rm == 0:  # DAB ensemble: 3 bytes each (control+freq)
                for _ in range(n_freq_bytes // 3):
                    f0, f1, f2 = r.u8(), r.u8(), r.u8()
                    freq = (((f0 & 0x07) << 16) | (f1 << 8) | f2) * 16_000
                    freqs.append(freq)
            elif rm == 8:  # FM with RDS: 1 byte each, 87.5 + 0.1*n MHz
                for _ in range(n_freq_bytes):
                    freqs.append(87_500_000 + 100_000 * r.u8())
            elif rm in (6,):  # DRM: 1 id byte + 2 bytes each
                drm_id = r.u8() if n_freq_bytes else 0
                for _ in range((n_freq_bytes - 1) // 2):
                    h, lo = r.u8(), r.u8()
                    freqs.append((((h & 0x7F) << 8) | lo) * 1000)
                yield FIGEvent("frequency_info", {
                    "id": id_field, "rm": rm, "drm_id": drm_id,
                    "continuity": continuity, "frequencies": freqs})
                continue
            else:
                r.take(n_freq_bytes)
            yield FIGEvent("frequency_info", {
                "id": id_field, "rm": rm, "continuity": continuity,
                "frequencies": freqs})


_FIG0_HANDLERS = {
    0: _fig0_0, 1: _fig0_1, 2: _fig0_2, 3: _fig0_3, 5: _fig0_5, 6: _fig0_6,
    8: _fig0_8, 9: _fig0_9, 10: _fig0_10, 13: _fig0_13, 14: _fig0_14,
    17: _fig0_17, 21: _fig0_21,
}


# ---------------- FIG type 1 (labels) ----------------

def _decode_label(raw: bytes, charset: int) -> str:
    if charset == 0:  # EBU Latin — approximate with latin-1 for the ASCII block
        return raw.decode("latin-1", "replace").rstrip()
    if charset == 6:  # UCS-2, big-endian (TS 101 756 table 1)
        # NOT "ucs-2": CPython has no codec of that name — a CRC-passing
        # FIB carrying charset 6 raised LookupError and crashed the
        # receiver (caught by tests/test_fuzz_parsers.py)
        return raw.decode("utf-16-be", "replace").rstrip("\x00 \ufffd\t\r\n")
    if charset == 15:
        return raw.decode("utf-8", "replace").rstrip()
    return raw.decode("latin-1", "replace").rstrip()


def _parse_fig1(payload: bytes) -> Iterator[FIGEvent]:
    r = _Reader(payload)
    b0 = r.u8()
    charset = b0 >> 4
    ext = b0 & 0x07
    try:
        if ext == 0:  # ensemble label
            eid = r.u16()
            label = _decode_label(r.take(16), charset)
            flags = r.u16()
            yield FIGEvent("ensemble_label", {"ensemble_id": eid, "label": label,
                                              "short_flags": flags})
        elif ext == 1:  # programme service label
            sid = r.u16()
            label = _decode_label(r.take(16), charset)
            flags = r.u16()
            yield FIGEvent("service_label", {"service_id": sid, "label": label,
                                             "short_flags": flags})
        elif ext == 4:  # service component label
            b = r.u8()
            pd = (b >> 7) & 1
            scids = b & 0x0F
            sid = r.u32() if pd else r.u16()
            label = _decode_label(r.take(16), charset)
            flags = r.u16()
            yield FIGEvent("component_label", {"service_id": sid, "scids": scids,
                                               "label": label, "short_flags": flags})
        elif ext == 5:  # data service label
            sid = r.u32()
            label = _decode_label(r.take(16), charset)
            flags = r.u16()
            yield FIGEvent("service_label", {"service_id": sid, "label": label,
                                             "short_flags": flags, "is_data": True})
        else:
            yield FIGEvent("unhandled", {"fig_type": 1, "extension": ext})
    except (IndexError, ValueError):
        yield FIGEvent("parse_error", {"fig_type": 1, "extension": ext})

"""MSC data groups (EN 300 401 sec 5.3.3) and MOT object transfer
(EN 301 234, header mode) — parser + synthesizer builders.
Counterpart of tpudab.mot.mot."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpudab_torch.fec.crc import crc16_ccitt


class ContentType(enum.IntEnum):
    GENERAL = 0
    TEXT = 1
    IMAGE = 2
    AUDIO = 3
    VIDEO = 4
    MOT_TRANSPORT = 5


# image subtypes (TS 101 756 table 17)
IMAGE_GIF, IMAGE_JFIF, IMAGE_BMP, IMAGE_PNG = 0, 1, 2, 3

DG_TYPE_MOT_HEADER = 3
DG_TYPE_MOT_BODY = 4
DG_TYPE_MOT_DIRECTORY = 6

# MOT parameter ids (header extension)
PARAM_EXPIRE_TIME = 0x04
PARAM_TRIGGER_TIME = 0x05
PARAM_CONTENT_NAME = 0x0C
PARAM_CATEGORY_SLIDE_ID = 0x25
PARAM_CATEGORY_TITLE = 0x26
PARAM_CLICK_THROUGH_URL = 0x27
PARAM_ALT_LOCATION_URL = 0x28


@dataclasses.dataclass
class MSCDataGroup:
    dg_type: int
    continuity: int
    repetition: int
    last_segment: bool
    segment_number: int
    transport_id: Optional[int]
    data: bytes
    crc_ok: bool


def parse_msc_data_group(raw: bytes) -> Optional[MSCDataGroup]:
    if len(raw) < 2:
        return None
    b0, b1 = raw[0], raw[1]
    ext_flag = (b0 >> 7) & 1
    crc_flag = (b0 >> 6) & 1
    seg_flag = (b0 >> 5) & 1
    ua_flag = (b0 >> 4) & 1
    dg_type = b0 & 0x0F
    continuity = (b1 >> 4) & 0x0F
    repetition = b1 & 0x0F
    pos = 2 + (2 if ext_flag else 0)
    crc_ok = True
    if crc_flag:
        if len(raw) < pos + 2:
            return None
        calc = crc16_ccitt(np.frombuffer(raw[:-2], dtype=np.uint8))
        sent = (raw[-2] << 8) | raw[-1]
        crc_ok = calc == sent
        payload_end = len(raw) - 2
    else:
        payload_end = len(raw)
    last, seg_num = True, 0
    if seg_flag:
        if payload_end < pos + 2:
            return None
        last = bool(raw[pos] >> 7)
        seg_num = ((raw[pos] & 0x7F) << 8) | raw[pos + 1]
        pos += 2
    transport_id = None
    if ua_flag:
        if payload_end < pos + 1:
            return None
        li = raw[pos] & 0x0F
        tid_flag = (raw[pos] >> 4) & 1
        pos += 1
        if tid_flag and payload_end >= pos + 2:
            transport_id = (raw[pos] << 8) | raw[pos + 1]
        pos += li
    return MSCDataGroup(dg_type, continuity, repetition, last, seg_num,
                        transport_id, raw[pos:payload_end], crc_ok)


def build_msc_data_group(dg_type: int, continuity: int, segment_number: int,
                         last: bool, transport_id: int, data: bytes) -> bytes:
    b0 = (0 << 7) | (1 << 6) | (1 << 5) | (1 << 4) | (dg_type & 0x0F)
    b1 = ((continuity & 0x0F) << 4)
    seg = bytes([((1 if last else 0) << 7) | ((segment_number >> 8) & 0x7F),
                 segment_number & 0xFF])
    ua = bytes([(1 << 4) | 2, (transport_id >> 8) & 0xFF, transport_id & 0xFF])
    body = bytes([b0, b1]) + seg + ua + data
    crc = int(crc16_ccitt(np.frombuffer(body, dtype=np.uint8)))
    return body + bytes([crc >> 8, crc & 0xFF])


# ---------------------------------------------------------------------------
# MOT header-mode objects
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MOTObject:
    transport_id: int
    content_type: int
    content_subtype: int
    body: bytes
    content_name: str = ""
    params: Dict[int, bytes] = dataclasses.field(default_factory=dict)

    @property
    def is_image(self) -> bool:
        return self.content_type == ContentType.IMAGE


def _encode_header(body_size: int, content_type: int, content_subtype: int,
                   params: Dict[int, bytes]) -> bytes:
    ext = b""
    for pid, val in params.items():
        if len(val) == 0:
            ext += bytes([(0 << 6) | pid])
        elif len(val) == 1:
            ext += bytes([(1 << 6) | pid]) + val
        elif len(val) == 4:
            ext += bytes([(2 << 6) | pid]) + val
        else:
            assert len(val) < 128
            ext += bytes([(3 << 6) | pid, len(val)]) + val
    header_size = 7 + len(ext)
    h = bytearray(7)
    h[0] = (body_size >> 20) & 0xFF
    h[1] = (body_size >> 12) & 0xFF
    h[2] = (body_size >> 4) & 0xFF
    h[3] = ((body_size & 0x0F) << 4) | ((header_size >> 9) & 0x0F)
    h[4] = (header_size >> 1) & 0xFF
    h[5] = ((header_size & 1) << 7) | ((content_type & 0x3F) << 1) \
        | ((content_subtype >> 8) & 1)
    h[6] = content_subtype & 0xFF
    return bytes(h) + ext


def _decode_header(data: bytes):
    if len(data) < 7:
        return None
    body_size = (data[0] << 20) | (data[1] << 12) | (data[2] << 4) | (data[3] >> 4)
    header_size = ((data[3] & 0x0F) << 9) | (data[4] << 1) | (data[5] >> 7)
    content_type = (data[5] >> 1) & 0x3F
    content_subtype = ((data[5] & 1) << 8) | data[6]
    params: Dict[int, bytes] = {}
    pos = 7
    while pos < min(header_size, len(data)):
        b = data[pos]
        pli = (b >> 6) & 3
        pid = b & 0x3F
        pos += 1
        if pli == 0:
            params[pid] = b""
        elif pli == 1:
            params[pid] = data[pos : pos + 1]
            pos += 1
        elif pli == 2:
            params[pid] = data[pos : pos + 4]
            pos += 4
        else:
            if pos >= len(data):
                break
            ext_flag = data[pos] >> 7
            if ext_flag:
                length = ((data[pos] & 0x7F) << 8) | data[pos + 1]
                pos += 2
            else:
                length = data[pos] & 0x7F
                pos += 1
            params[pid] = data[pos : pos + length]
            pos += length
    return body_size, header_size, content_type, content_subtype, params


# ---------------------------------------------------------------------------
# MOT directory mode (EN 301 234 sec 7.2.3 — layout reconstructed from the
# standard's structure: see STATUS.md 'reconstructed formats')
# ---------------------------------------------------------------------------

def encode_mot_directory(entries: List[Tuple[int, bytes]],
                         segment_size: int = 0,
                         carousel_period_ms: int = 0,
                         extension: bytes = b"") -> bytes:
    """entries: [(transport_id, full object header bytes)]. Uncompressed."""
    body = bytearray()
    for tid, hdr in entries:
        body += bytes([(tid >> 8) & 0xFF, tid & 0xFF]) + hdr
    dir_size = 13 + len(extension) + len(body)
    out = bytearray()
    out += bytes([(dir_size >> 24) & 0x3F, (dir_size >> 16) & 0xFF,
                  (dir_size >> 8) & 0xFF, dir_size & 0xFF])
    out += bytes([(len(entries) >> 8) & 0xFF, len(entries) & 0xFF])
    out += bytes([(carousel_period_ms >> 16) & 0xFF,
                  (carousel_period_ms >> 8) & 0xFF, carousel_period_ms & 0xFF])
    out += bytes([(segment_size >> 8) & 0x1F, segment_size & 0xFF])
    out += bytes([(len(extension) >> 8) & 0xFF, len(extension) & 0xFF])
    out += extension
    out += body
    return bytes(out)


def decode_mot_directory(raw: bytes) -> Optional[List[Tuple[int, tuple]]]:
    """Returns [(transport_id, decoded header tuple)] or None on malformed
    input. Tolerates a truncated trailing entry (drops it)."""
    if len(raw) < 13:
        return None
    if raw[0] & 0x80:
        return None  # compressed directory (type 7 payload) unsupported
    n_objects = (raw[4] << 8) | raw[5]
    ext_len = (raw[11] << 8) | raw[12]
    pos = 13 + ext_len
    entries: List[Tuple[int, tuple]] = []
    for _ in range(n_objects):
        if pos + 9 > len(raw):
            break
        tid = (raw[pos] << 8) | raw[pos + 1]
        hdr_raw = raw[pos + 2:]
        hdr = _decode_header(hdr_raw)
        if hdr is None:
            break
        header_size = hdr[1]
        if header_size < 7 or pos + 2 + header_size > len(raw):
            break
        # re-decode restricted to this entry's header bytes
        hdr = _decode_header(hdr_raw[:header_size])
        entries.append((tid, hdr))
        pos += 2 + header_size
    return entries


class MOTAssembler:
    """Assembles MOT objects from MSC data groups — header mode (type 3+4)
    AND directory mode (type 6 directory + type 4 bodies, EN 301 234).

    Reassembly hardening: segments arrive out of order (dict-keyed), bodies
    may precede the directory/header, incomplete transports are bounded by
    an LRU eviction cap, and a new directory prunes transports that left
    the carousel.
    """

    MAX_PENDING = 64            # incomplete transports kept (LRU)

    def __init__(self, on_object=None):
        self.on_object = on_object
        self._headers: Dict[int, tuple] = {}
        self._header_segs: Dict[int, Dict[int, bytes]] = {}
        self._header_last: Dict[int, int] = {}
        self._bodies: Dict[int, Dict[int, bytes]] = {}
        self._body_last: Dict[int, int] = {}
        self._dir_segs: Dict[int, Dict[int, bytes]] = {}
        self._dir_last: Dict[int, int] = {}
        self._pending_order: List[int] = []
        self.directory: Dict[int, tuple] = {}   # tid -> header (dir mode)
        self.objects: Dict[int, MOTObject] = {}
        self.stats = {"groups": 0, "crc_errors": 0, "objects": 0,
                      "directories": 0, "evicted": 0}

    def push_data_group(self, raw: bytes) -> None:
        dg = parse_msc_data_group(raw)
        if dg is None:
            return
        self.stats["groups"] += 1
        if not dg.crc_ok:
            self.stats["crc_errors"] += 1
            return
        tid = dg.transport_id
        if tid is None:
            return
        if dg.dg_type == DG_TYPE_MOT_HEADER:
            self._touch(tid)
            segs = self._header_segs.setdefault(tid, {})
            segs[dg.segment_number] = dg.data
            if dg.last_segment:
                self._header_last[tid] = dg.segment_number
            self._try_header(tid)
        elif dg.dg_type == DG_TYPE_MOT_BODY:
            self._touch(tid)
            segs = self._bodies.setdefault(tid, {})
            segs[dg.segment_number] = dg.data
            if dg.last_segment:
                self._body_last[tid] = dg.segment_number
            self._try_complete(tid)
        elif dg.dg_type == DG_TYPE_MOT_DIRECTORY:
            segs = self._dir_segs.setdefault(tid, {})
            segs[dg.segment_number] = dg.data
            if dg.last_segment:
                self._dir_last[tid] = dg.segment_number
            self._try_directory(tid)

    # ---- assembly-state bookkeeping ----

    def _touch(self, tid: int) -> None:
        if tid in self._pending_order:
            self._pending_order.remove(tid)
        self._pending_order.append(tid)
        while len(self._pending_order) > self.MAX_PENDING:
            evict = self._pending_order.pop(0)
            self._drop(evict)
            self.stats["evicted"] += 1

    def _drop(self, tid: int) -> None:
        for d in (self._header_segs, self._header_last, self._bodies,
                  self._body_last, self._headers):
            d.pop(tid, None)

    def _done(self, tid: int) -> None:
        self._bodies.pop(tid, None)
        self._body_last.pop(tid, None)
        if tid in self._pending_order:
            self._pending_order.remove(tid)

    # ---- header mode ----

    def _try_header(self, tid: int) -> None:
        last = self._header_last.get(tid)
        segs = self._header_segs.get(tid, {})
        if last is None or not all(i in segs for i in range(last + 1)):
            return
        raw = b"".join(segs[i] for i in range(last + 1))
        hdr = _decode_header(raw)
        if hdr is not None:
            self._headers[tid] = hdr
            self._try_complete(tid)

    # ---- directory mode ----

    def _try_directory(self, dir_tid: int) -> None:
        last = self._dir_last.get(dir_tid)
        segs = self._dir_segs.get(dir_tid, {})
        if last is None or not all(i in segs for i in range(last + 1)):
            return
        raw = b"".join(segs[i] for i in range(last + 1))
        entries = decode_mot_directory(raw)
        if entries is None:
            return
        self.stats["directories"] += 1
        self._dir_segs.pop(dir_tid, None)
        self._dir_last.pop(dir_tid, None)
        new_dir = dict(entries)
        # carousel management: transports that left the directory are stale
        for tid in list(self.directory):
            if tid not in new_dir:
                self._drop(tid)
                self.objects.pop(tid, None)
        self.directory = new_dir
        for tid, hdr in entries:
            self._headers[tid] = hdr
            self._try_complete(tid)

    # ---- completion ----

    def _try_complete(self, tid: int) -> None:
        hdr = self._headers.get(tid)
        last = self._body_last.get(tid)
        segs = self._bodies.get(tid, {})
        if hdr is None or last is None or not all(i in segs for i in range(last + 1)):
            return
        body = b"".join(segs[i] for i in range(last + 1))
        body_size, _, ctype, csub, params = hdr
        if len(body) < body_size:
            return
        name = params.get(PARAM_CONTENT_NAME, b"")
        content_name = name[1:].decode("latin-1", "replace") if name else ""
        obj = MOTObject(transport_id=tid, content_type=ctype,
                        content_subtype=csub, body=body[:body_size],
                        content_name=content_name, params=params)
        self.objects[tid] = obj
        self.stats["objects"] += 1
        self._done(tid)
        if self.on_object:
            self.on_object(obj)


def build_mot_directory_groups(objects: List[MOTObject],
                               segment_size: int = 128,
                               dir_transport_id: int = 0,
                               ) -> List[bytes]:
    """Synthesizer: directory-mode carousel -> MSC data groups: one
    (possibly segmented) type-6 directory group + type-4 body groups per
    object (objects in directory mode carry NO per-object header groups)."""
    entries = []
    for obj in objects:
        params = dict(obj.params)
        if obj.content_name and PARAM_CONTENT_NAME not in params:
            params[PARAM_CONTENT_NAME] = (bytes([0])
                                          + obj.content_name.encode("latin-1"))
        entries.append((obj.transport_id,
                        _encode_header(len(obj.body), obj.content_type,
                                       obj.content_subtype, params)))
    directory = encode_mot_directory(entries, segment_size=segment_size)
    groups = []
    cont = 0
    dsegs = [directory[i: i + segment_size]
             for i in range(0, len(directory), segment_size)]
    for i, seg in enumerate(dsegs):
        groups.append(build_msc_data_group(DG_TYPE_MOT_DIRECTORY, cont & 0xF,
                                           i, i == len(dsegs) - 1,
                                           dir_transport_id, seg))
        cont += 1
    for obj in objects:
        bsegs = [obj.body[i: i + segment_size]
                 for i in range(0, len(obj.body), segment_size)]
        for i, seg in enumerate(bsegs):
            groups.append(build_msc_data_group(DG_TYPE_MOT_BODY, cont & 0xF,
                                               i, i == len(bsegs) - 1,
                                               obj.transport_id, seg))
            cont += 1
    return groups


def build_mot_object_groups(obj: MOTObject, segment_size: int = 128) -> List[bytes]:
    """Synthesizer: MOT object -> list of MSC data groups (header + body)."""
    params = dict(obj.params)
    if obj.content_name and PARAM_CONTENT_NAME not in params:
        params[PARAM_CONTENT_NAME] = bytes([0]) + obj.content_name.encode("latin-1")
    header = _encode_header(len(obj.body), obj.content_type,
                            obj.content_subtype, params)
    groups = []
    cont = 0
    hsegs = [header[i : i + segment_size] for i in range(0, len(header), segment_size)]
    for i, seg in enumerate(hsegs):
        groups.append(build_msc_data_group(DG_TYPE_MOT_HEADER, cont & 0xF, i,
                                           i == len(hsegs) - 1,
                                           obj.transport_id, seg))
        cont += 1
    bsegs = [obj.body[i : i + segment_size] for i in range(0, len(obj.body), segment_size)]
    for i, seg in enumerate(bsegs):
        groups.append(build_msc_data_group(DG_TYPE_MOT_BODY, cont & 0xF, i,
                                           i == len(bsegs) - 1,
                                           obj.transport_id, seg))
        cont += 1
    return groups

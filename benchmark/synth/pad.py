"""Programme-associated data for the synthesized DAB+ services: the
dynamic label's segments and an MOT slideshow image carried in X-PAD, led
into each AU by a PAD DSE (EN 300 401 sec 7.4, EN 301 234; a frozen copy of
tpudab_torch.pad.xpad's and tpudab_torch.mot.mot's synthesizer builders and
of tpudab_torch.mot.imagemeta's TINY_PNG)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.synth.crc import crc16_ccitt

XPAD_LENGTHS = [4, 6, 8, 12, 16, 24, 32, 48]
APP_DYNAMIC_LABEL_START = 2
APP_MOT_START = 12
APP_MOT_CONT = 13
IMAGE = 2               # MOT content type (EN 301 234 table 17)
IMAGE_PNG = 3
DG_TYPE_MOT_HEADER = 3
DG_TYPE_MOT_BODY = 4
PARAM_CONTENT_NAME = 0x0C

# a tiny valid 4x4 PNG
TINY_PNG = bytes.fromhex(
    "89504e470d0a1a0a0000000d494844520000000400000004080200000026"
    "9309290000001449444154789c633c2127c700034c0c4800370700347601"
    "0caf6ab9b50000000049454e44ae426082")


def build_dynamic_label_segments(text: str, charset: int = 0,
                                 toggle: int = 0) -> List[bytes]:
    """Synthesizer: split a label into CRC'd segments of <= 16 chars."""
    raw = text.encode("latin-1" if charset == 0 else "utf-8", "replace")
    chunks = [raw[i : i + 16] for i in range(0, len(raw), 16)] or [b""]
    segs = []
    for i, chunk in enumerate(chunks):
        first = 1 if i == 0 else 0
        last = 1 if i == len(chunks) - 1 else 0
        b0 = (toggle << 7) | (first << 6) | (last << 5) | (len(chunk) - 1)
        b1 = ((charset & 0x0F) << 4) if first else ((i & 7) << 4)
        body = bytes([b0, b1]) + chunk
        crc = int(crc16_ccitt(np.frombuffer(body, dtype=np.uint8)))
        segs.append(body + bytes([crc >> 8, crc & 0xFF]))
    return segs


def build_xpad_into_au(au_payload: bytes, cis: List[Tuple[int, bytes]],
                       ci_flag: bool = True) -> bytes:
    """Prepend a PAD DSE to an AU payload (synth fixture).

    cis: list of (app_type, subfield_bytes); lengths are rounded up to the
    nearest legal X-PAD subfield size with zero padding.
    """
    xpad = b""
    ci_bytes = b""
    for app_type, data in cis:
        li = next(i for i, l in enumerate(XPAD_LENGTHS) if l >= len(data))
        length = XPAD_LENGTHS[li]
        ci_bytes += bytes([(li << 5) | (app_type & 0x1F)])
        xpad += data + b"\x00" * (length - len(data))
    if len(ci_bytes) < 4:
        ci_bytes += b"\x00"  # CI list terminator
    body = (ci_bytes if ci_flag else b"") + xpad
    fpad = bytes([(2 << 4), (1 << 1) if ci_flag else 0])  # variable size X-PAD
    data = fpad + body[::-1]
    assert len(data) < 255
    dse = bytes([(4 << 5) | 1, len(data)]) + data  # tag 0, byte-aligned
    return dse + au_payload


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


def build_mot_object_groups(transport_id: int, content_type: int, content_subtype: int,
                            body: bytes, content_name: str,
                            segment_size: int = 128) -> List[bytes]:
    """MOT object -> list of MSC data groups (header + body)."""
    params: Dict[int, bytes] = {PARAM_CONTENT_NAME: bytes([0]) + content_name.encode("latin-1")}
    header = _encode_header(len(body), content_type, content_subtype, params)
    groups = []
    cont = 0
    hsegs = [header[i : i + segment_size] for i in range(0, len(header), segment_size)]
    for i, seg in enumerate(hsegs):
        groups.append(build_msc_data_group(DG_TYPE_MOT_HEADER, cont & 0xF, i,
                                           i == len(hsegs) - 1, transport_id, seg))
        cont += 1
    bsegs = [body[i : i + segment_size] for i in range(0, len(body), segment_size)]
    for i, seg in enumerate(bsegs):
        groups.append(build_msc_data_group(DG_TYPE_MOT_BODY, cont & 0xF, i,
                                           i == len(bsegs) - 1, transport_id, seg))
        cont += 1
    return groups

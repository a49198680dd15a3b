"""X-PAD / F-PAD processing, ETSI EN 300 401 sec 7.4.

Carriage: the last two bytes of each DAB audio frame (or DAB+ access unit
payload region designated for PAD) are the F-PAD; the X-PAD field of length
indicated by the F-PAD precedes it, transmitted in REVERSE byte order.

Variable-size X-PAD carries up to 4 subfields, each described by a content
indicator (CI) byte: length index (3 bits) + application type (5 bits).
App types: 1 = data group length indicator, 2/3 = dynamic label segment
(start/continuation), 12/13 = MOT data group (start/continuation).
When the CI flag in F-PAD is 0, the previous CI configuration persists.

Counterpart of tpudab.pad.xpad.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tpudab_torch.fec.crc import crc16_ccitt

XPAD_LENGTHS = [4, 6, 8, 12, 16, 24, 32, 48]

APP_DATA_GROUP_LENGTH = 1
APP_DYNAMIC_LABEL_START = 2
APP_DYNAMIC_LABEL_CONT = 3
APP_MOT_START = 12
APP_MOT_CONT = 13


# ---------------------------------------------------------------------------
# dynamic label assembly (sec 7.4.5.2)
# ---------------------------------------------------------------------------

class DynamicLabelDecoder:
    """Assembles dynamic label segments into the current label string."""

    def __init__(self):
        self._segments: Dict[int, bytes] = {}
        self._last_seg: Optional[int] = None
        self._toggle: Optional[int] = None
        self.label: str = ""
        self.charset: int = 0
        self.stats = {"crc_errors": 0, "labels": 0}

    def push_segment(self, seg: bytes) -> None:
        """seg: one complete dynamic label segment (prefix+chars+CRC)."""
        if len(seg) < 4:
            return
        calc = crc16_ccitt(np.frombuffer(seg[:-2], dtype=np.uint8))
        sent = (seg[-2] << 8) | seg[-1]
        if calc != sent:
            self.stats["crc_errors"] += 1
            return
        b0, b1 = seg[0], seg[1]
        toggle = (b0 >> 7) & 1
        first = (b0 >> 6) & 1
        last = (b0 >> 5) & 1
        command = (b0 >> 4) & 1
        if command:
            if ((b0 & 0x0F)) == 1:  # clear display
                self.label = ""
            return
        length = (b0 & 0x0F) + 1
        seg_num = (b1 >> 4) & 7
        if first:
            # EN 300 401 sec 7.4.5.2: in the first segment the second prefix
            # byte carries the 4-bit charset in its HIGH nibble (the same
            # bits that hold SegNum in continuation segments); low nibble rfa.
            seg_num = 0
            self.charset = (b1 >> 4) & 0x0F
        if toggle != self._toggle:
            self._segments = {}
            self._toggle = toggle
        self._segments[seg_num] = seg[2 : 2 + length]
        if last:
            self._last_seg = seg_num
        if self._last_seg is not None and \
                all(i in self._segments for i in range(self._last_seg + 1)):
            raw = b"".join(self._segments[i] for i in range(self._last_seg + 1))
            try:
                if self.charset == 6:
                    text = raw.decode("utf-16-be", "replace")
                elif self.charset == 15:
                    text = raw.decode("utf-8", "replace")
                else:
                    text = raw.decode("latin-1", "replace")
            except Exception:
                text = raw.decode("latin-1", "replace")
            self.label = text.strip()
            self.stats["labels"] += 1
            self._segments = {}
            self._last_seg = None


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


# ---------------------------------------------------------------------------
# X-PAD stream processor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _AppAccumulator:
    buf: bytes = b""
    expected: Optional[int] = None  # from data group length indicator


class XPADProcessor:
    """Consumes per-frame (fpad, xpad) pairs; dispatches app subfields.

    on_mot_data_group(bytes) fires for each complete MOT data group;
    dynamic labels accumulate in .dynamic_label.
    """

    def __init__(self, on_mot_data_group: Optional[Callable] = None):
        self.dynamic_label = DynamicLabelDecoder()
        self.on_mot_data_group = on_mot_data_group
        self._last_cis: List[Tuple[int, int]] = []  # (app_type, length)
        self._dl_accum = b""
        self._dl_expected = None
        self._mot_accum = b""
        self._mot_len: Optional[int] = None
        self.stats = {"frames": 0, "mot_groups": 0}

    def push(self, fpad: bytes, xpad: bytes) -> None:
        """fpad: 2 bytes; xpad: X-PAD field in transmission order (already
        un-reversed)."""
        self.stats["frames"] += 1
        if len(fpad) < 2:
            return
        xpad_ind = (fpad[0] >> 4) & 3
        ci_flag = (fpad[1] >> 1) & 1
        if xpad_ind == 0 or not xpad:
            return
        pos = 0
        if xpad_ind == 1:
            # short X-PAD: 4 bytes, one app (type 0/1... treat as continuation)
            cis = self._last_cis or [(APP_DYNAMIC_LABEL_CONT, 4)]
            if ci_flag:
                cis = [(xpad[0] & 0x1F, 3)]
                pos = 1
        else:
            if ci_flag:
                cis = []
                while pos < min(4, len(xpad)):
                    ci = xpad[pos]
                    pos += 1
                    if (ci & 0x1F) == 0:
                        break
                    cis.append((ci & 0x1F, XPAD_LENGTHS[(ci >> 5) & 7]))
                self._last_cis = cis
            else:
                cis = self._last_cis
        for app_type, length in cis:
            chunk = xpad[pos : pos + length]
            pos += length
            self._dispatch(app_type, chunk)

    def _dispatch(self, app_type: int, chunk: bytes) -> None:
        if app_type == APP_DYNAMIC_LABEL_START:
            self._flush_dl()
            self._dl_accum = chunk
            self._try_dl()
        elif app_type == APP_DYNAMIC_LABEL_CONT:
            if self._dl_accum:
                self._dl_accum += chunk
                self._try_dl()
        elif app_type == APP_MOT_START:
            self._flush_mot()
            self._mot_accum = chunk
            self._mot_len = None
            self._parse_mot_length()
        elif app_type == APP_MOT_CONT:
            if self._mot_accum:
                self._mot_accum += chunk
                self._try_mot()
        elif app_type == APP_DATA_GROUP_LENGTH:
            if len(chunk) >= 2:
                self._mot_len = ((chunk[0] & 0x3F) << 8) | chunk[1]

    # dynamic label: the segment length is derivable from its prefix
    def _try_dl(self) -> None:
        if len(self._dl_accum) < 2:
            return
        b0 = self._dl_accum[0]
        if (b0 >> 4) & 1:  # command segment: prefix + CRC only
            need = 4
        else:
            need = 2 + ((b0 & 0x0F) + 1) + 2
        if len(self._dl_accum) >= need:
            self.dynamic_label.push_segment(self._dl_accum[:need])
            self._dl_accum = b""

    def _flush_dl(self) -> None:
        self._dl_accum = b""

    def _parse_mot_length(self) -> None:
        # MOT data groups in X-PAD are prefixed by a 2-byte length (the data
        # group length indicator convention used when app type 1 is absent)
        self._try_mot()

    def _try_mot(self) -> None:
        if self._mot_len is None and len(self._mot_accum) >= 2:
            self._mot_len = ((self._mot_accum[0] & 0x3F) << 8) | self._mot_accum[1]
            self._mot_accum = self._mot_accum[2:]
        if self._mot_len is not None and len(self._mot_accum) >= self._mot_len:
            group = self._mot_accum[: self._mot_len]
            self._mot_accum = b""
            self._mot_len = None
            self.stats["mot_groups"] += 1
            if self.on_mot_data_group:
                self.on_mot_data_group(group)

    def _flush_mot(self) -> None:
        self._mot_accum = b""
        self._mot_len = None


# ---------------------------------------------------------------------------
# DAB+ AU carriage: PAD inside an AAC Data Stream Element (TS 102 563
# sec 5.4.3). The DSE is the first syntactic element of the raw data block:
#   id_syn_ele(3)=4, element_instance_tag(4), data_byte_align_flag(1),
#   count(8) [+ esc(8) if count==255], then the data bytes.
# DSE data layout: F-PAD (2 bytes) followed by the X-PAD field in reverse
# byte order (the CI list ends up nearest the F-PAD).
# ---------------------------------------------------------------------------

def extract_pad_from_dabplus_au(au: bytes) -> Tuple[bytes, bytes, bytes]:
    """Parse a leading DSE from an AAC AU.

    Returns (remaining_au, fpad, xpad-in-transmission-order); empty pads if
    the AU does not start with a DSE.
    """
    if len(au) < 2 or (au[0] >> 5) & 7 != 4:
        return au, b"", b""
    count = au[1]
    offset = 2
    if count == 255:
        if len(au) < 3:
            return au, b"", b""
        count += au[2]
        offset = 3
    if len(au) < offset + count or count < 2:
        return au, b"", b""
    data = au[offset : offset + count]
    fpad = data[:2]
    xpad = data[2:][::-1]
    return au[offset + count:], fpad, xpad


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


def extract_pad_from_mp2_frame(frame: bytes, max_cis: int = 4
                               ) -> Tuple[bytes, bytes]:
    """(fpad, xpad-in-transmission-order) from a DAB MP2 audio frame.

    In DAB audio frames the F-PAD is the last two bytes and the X-PAD
    (reverse byte order) sits immediately before it; for variable-size X-PAD
    with a CI list, the total length is recoverable by walking the CI bytes
    backwards from the F-PAD (EN 300 401 sec 7.4.2).
    """
    if len(frame) < 2:
        return b"", b""
    fpad = frame[-2:]
    xpad_ind = (fpad[0] >> 4) & 3
    ci_flag = (fpad[1] >> 1) & 1
    if xpad_ind == 1:
        xpad_rev = frame[-2 - 4 : -2]
        return fpad, xpad_rev[::-1]
    if xpad_ind != 2 or not ci_flag:
        return fpad, b""
    # walk CI bytes backwards (they are the first X-PAD bytes, so nearest
    # the F-PAD after reversal)
    total = 0
    n_ci = 0
    pos = len(frame) - 3
    while n_ci < max_cis and pos >= 0:
        ci = frame[pos]
        n_ci += 1
        pos -= 1
        if (ci & 0x1F) == 0:
            break
        total += XPAD_LENGTHS[(ci >> 5) & 7]
    xpad_len = n_ci + total
    if len(frame) < 2 + xpad_len:
        return fpad, b""
    xpad_rev = frame[-2 - xpad_len : -2]
    return fpad, xpad_rev[::-1]

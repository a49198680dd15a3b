"""Classic DAB audio: MPEG-1/2 Layer II frame handling.

Counterpart of tpudab.audio.mp2: MPEG_Version/MPEG_Layer and the params
{sample_rate, is_stereo, bitrate_kbps} of each frame, frame sync and PAD
extraction. PCM decode (tpudab.audio.codecs) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

_BITRATES_L2_V1 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384]
_BITRATES_L2_V2 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]
_SAMPLE_RATES = {0b11: [44100, 48000, 32000], 0b10: [22050, 24000, 16000]}


@dataclasses.dataclass
class MP2FrameHeader:
    mpeg_version: str          # "MPEG-1" | "MPEG-2"
    layer: int
    bitrate_kbps: int
    sample_rate: int
    is_stereo: bool
    mode: int                  # 0 stereo, 1 joint, 2 dual, 3 mono
    frame_bytes: int

    @property
    def samples_per_frame(self) -> int:
        return 1152 if self.mpeg_version == "MPEG-1" else 576


def parse_mp2_header(data: bytes) -> Optional[MP2FrameHeader]:
    """Parse a 4-byte MPEG audio header at data[0:4]; None if invalid/not L2."""
    if len(data) < 4:
        return None
    b0, b1, b2, _ = data[0], data[1], data[2], data[3]
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    version_bits = (b1 >> 3) & 3
    layer_bits = (b1 >> 1) & 3
    if layer_bits != 0b10:  # layer II
        return None
    if version_bits not in (0b11, 0b10):
        return None
    bitrate_idx = (b2 >> 4) & 0xF
    sr_idx = (b2 >> 2) & 3
    if bitrate_idx in (0, 0xF) or sr_idx == 3:
        return None
    padding = (b2 >> 1) & 1
    mode = (data[3] >> 6) & 3
    v1 = version_bits == 0b11
    bitrate = (_BITRATES_L2_V1 if v1 else _BITRATES_L2_V2)[bitrate_idx]
    sample_rate = _SAMPLE_RATES[version_bits][sr_idx]
    spf = 1152 if v1 else 576
    frame_bytes = spf // 8 * bitrate * 1000 // sample_rate + padding
    return MP2FrameHeader(
        mpeg_version="MPEG-1" if v1 else "MPEG-2",
        layer=2,
        bitrate_kbps=bitrate,
        sample_rate=sample_rate,
        is_stereo=mode != 3,
        mode=mode,
        frame_bytes=frame_bytes,
    )


class DABChannel:
    """Streaming classic-DAB channel: logical frames -> MP2 frames.

    In DAB, one logical frame (24 ms) carries exactly one MP2 frame at
    48 kHz (1152 samples) or half a frame at 24 kHz; sync is re-checked per
    frame (reference analog: Basic_DAB_Channel).
    """

    def __init__(self, subch_bitrate_kbps: int):
        from tpudab_torch.pad.xpad import XPADProcessor
        from tpudab_torch.mot.slideshow import SlideshowManager

        self.bitrate = subch_bitrate_kbps
        self.frame_bytes = subch_bitrate_kbps * 3
        self._pending = b""
        self.stats = {"frames": 0, "sync_errors": 0}
        self.last_header: Optional[MP2FrameHeader] = None
        # PAD chain (F-PAD/X-PAD at the tail of each DAB audio frame)
        self.slideshow = SlideshowManager()
        self.xpad = XPADProcessor(on_mot_data_group=self.slideshow.push_data_group)

    @property
    def dynamic_label(self) -> str:
        return self.xpad.dynamic_label.label

    def process_frames(self, frames: np.ndarray) -> List[bytes]:
        """frames: (N, frame_bytes) -> list of complete MP2 frames (bytes)."""
        out: List[bytes] = []
        buf = self._pending + np.asarray(frames, dtype=np.uint8).tobytes()
        pos = 0
        while pos + 4 <= len(buf):
            hdr = parse_mp2_header(buf[pos:pos + 4])
            if hdr is None:
                pos += 1
                self.stats["sync_errors"] += 1
                continue
            if pos + hdr.frame_bytes > len(buf):
                break
            self.last_header = hdr
            frame = buf[pos : pos + hdr.frame_bytes]
            out.append(frame)
            self.stats["frames"] += 1
            pos += hdr.frame_bytes
            from tpudab_torch.pad.xpad import extract_pad_from_mp2_frame
            fpad, xpad = extract_pad_from_mp2_frame(frame)
            if fpad and (fpad[0] >> 4) & 3:
                self.xpad.push(fpad, xpad)
        self._pending = buf[pos:]
        return out

"""DAB+ superframe builder, TS 102 563 sec 5: AUs with their CRC, the
header with its Fire code, RS(120, 110) parity (a frozen copy of
tpudab_torch.audio.superframe's synthesizer side)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from benchmark.synth import rs
from benchmark.synth.crc import crc16_append, firecode_compute

FRAMES_PER_SUPERFRAME = 5


@dataclasses.dataclass
class SuperFrameHeader:
    dac_rate: int                  # 0 = 32 kHz DAC, 1 = 48 kHz DAC
    sbr_flag: int
    aac_channel_mode: int          # 0 = mono, 1 = stereo
    ps_flag: int
    mpeg_surround: int

    @property
    def sampling_rate(self) -> int:
        """Output sampling rate of the decoded audio."""
        return 48_000 if self.dac_rate else 32_000

    @property
    def core_sampling_rate(self) -> int:
        """AAC core rate (half the DAC rate when SBR is used)."""
        return self.sampling_rate // (2 if self.sbr_flag else 1)

    @property
    def is_stereo(self) -> bool:
        return bool(self.aac_channel_mode or self.ps_flag)

    @property
    def num_aus(self) -> int:
        return {(0, 0): 4, (1, 0): 6, (0, 1): 2, (1, 1): 3}[
            (self.dac_rate, self.sbr_flag)]


def header_size_bytes(num_aus: int) -> int:
    """TS 102 563 sec 5.2: firecode (16) + rfa/dac_rate/sbr_flag/
    aac_channel_mode/ps_flag/mpeg_surround_config (8) + au_start (12 each,
    num_aus-1 of them) + alignment to a byte boundary.

    -> 8/5/11/6 bytes for 4/2/6/3 AUs, i.e. the first AU starts at byte
    8/5/11/6 (the offsets every fielded DAB+ decoder hardcodes). Pinned by
    the hand-assembled standard fixture in tests/test_standard_fixtures.py.
    """
    bits = 24 + 12 * (num_aus - 1)
    return (bits + 7) // 8


def build_superframe(header: SuperFrameHeader, au_payloads: List[bytes],
                     subch_bitrate_kbps: int) -> np.ndarray:
    """Synthesizer: AUs (without CRC) -> 120*L superframe bytes with RS parity."""
    l_cw = subch_bitrate_kbps // 8
    n_aus = header.num_aus
    assert len(au_payloads) == n_aus
    hdr_bytes = header_size_bytes(n_aus)
    audio_len = 110 * l_cw

    total = hdr_bytes + sum(len(p) + 2 for p in au_payloads)
    assert total <= audio_len, f"AUs too large: {total} > {audio_len}"

    audio = np.zeros(audio_len, dtype=np.uint8)
    b2 = ((header.dac_rate & 1) << 6) | ((header.sbr_flag & 1) << 5) \
        | ((header.aac_channel_mode & 1) << 4) | ((header.ps_flag & 1) << 3) \
        | (header.mpeg_surround & 7)
    audio[2] = b2

    # AU start fields (12-bit, MSB first, starting at byte 3)
    starts = []
    pos = hdr_bytes
    for p in au_payloads:
        starts.append(pos)
        pos += len(p) + 2
    bitpos = 0
    for s in starts[1:]:
        byte_i, bit_i = 3 + bitpos // 8, bitpos % 8
        if bit_i == 0:
            audio[byte_i] = (s >> 4) & 0xFF
            audio[byte_i + 1] |= (s & 0xF) << 4
        else:  # bit_i == 4
            audio[byte_i] |= (s >> 8) & 0xF
            audio[byte_i + 1] = s & 0xFF
        bitpos += 12

    for s, p in zip(starts, au_payloads):
        au = crc16_append(np.frombuffer(p, dtype=np.uint8))
        audio[s : s + au.shape[0]] = au

    fc = int(firecode_compute(audio[2:11]))
    audio[0], audio[1] = fc >> 8, fc & 0xFF

    cw = rs.rs_encode(audio.reshape(110, l_cw).T.astype(np.uint8))  # (L, 120)
    return cw.T.reshape(-1)

"""Audio codec backends over the native shim (libavcodec): counterpart of
tpudab.audio.codecs.

Reference parity: faad2 (HE-AAC for DAB+) and mpg123 (MP2 for classic DAB).
Both go through the system libavcodec via host/native/codec_shim.c, built
as its own library by tpudab_torch.host.native_lib where its probe finds
FFmpeg. DAB+ AAC uses 960-sample frames (frameLengthFlag=1). The
availability probes keep tpudab's meaning (False when the codec cannot be
opened) and are also False where the probe found no FFmpeg, which
native_lib.codec_available says once on stderr; a failed build of the shim
raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tpudab_torch.audio.superframe import SuperFrameHeader
from tpudab_torch.host.native_lib import codec_available, codec_lib

_FREQ_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
               24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}
DABPLUS_PROBE_HEADER = SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1,
                                        ps_flag=0, mpeg_surround=0)


class CodecUnavailable(RuntimeError):
    """libavcodec has no such codec, or refused to open it."""


def audio_specific_config(core_rate: int, channels: int,
                          frame_960: bool = True) -> bytes:
    """MPEG-4 AudioSpecificConfig for AAC-LC (DAB+ core)."""
    aot = 2
    fi = _FREQ_INDEX[core_rate]
    bits = (aot << 11) | (fi << 7) | (channels << 3) \
        | ((1 if frame_960 else 0) << 2)
    return bytes([(bits >> 8) & 0xFF, bits & 0xFF])


def asc_for_header(header: SuperFrameHeader) -> bytes:
    ch = 2 if header.aac_channel_mode else 1
    return audio_specific_config(header.core_sampling_rate, ch)


class _ShimDecoder:
    def __init__(self, codec_name: str, extradata: bytes = b""):
        self._lib = codec_lib()
        self._h = self._lib.dab_decoder_open(codec_name.encode(), extradata, len(extradata))
        if not self._h:
            raise CodecUnavailable(f"codec {codec_name} unavailable")
        self.sample_rate = 0
        self.channels = 0

    def decode(self, packet: bytes, max_samples: int = 1 << 20) -> np.ndarray:
        out = np.empty(max_samples, dtype=np.int16)
        sr = ctypes.c_int(0)
        ch = ctypes.c_int(0)
        n = self._lib.dab_decoder_decode(
            self._h, packet, len(packet),
            out.ctypes.data_as(ctypes.c_void_p), max_samples,
            ctypes.byref(sr), ctypes.byref(ch))
        if n < 0:
            raise ValueError(f"decode error {n}")
        if sr.value:
            self.sample_rate = sr.value
            self.channels = ch.value
        if self.channels:
            return out[:n].reshape(-1, self.channels)
        return out[:0].reshape(0, 2)

    def close(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dab_decoder_close(h)

    def __del__(self):
        self.close()


class AACDecoder(_ShimDecoder):
    """DAB+ access units -> PCM (s16, (n, channels))."""

    def __init__(self, header: SuperFrameHeader):
        super().__init__("aac", asc_for_header(header))
        self.header = header


class MP2Decoder(_ShimDecoder):
    """MP2 frames -> PCM."""

    def __init__(self):
        super().__init__("mp2")


class _ShimEncoder:
    def __init__(self, codec_name: str, sample_rate: int, channels: int,
                 bit_rate: int):
        self._lib = codec_lib()
        self._h = self._lib.dab_encoder_open(codec_name.encode(), sample_rate,
                                             channels, bit_rate)
        if not self._h:
            raise CodecUnavailable(f"encoder {codec_name} unavailable")
        self.channels = channels
        self.frame_size = self._lib.dab_encoder_frame_size(self._h)

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: (frame_size, channels) int16 -> encoded packet bytes."""
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        if pcm.shape[0] != self.frame_size:
            raise ValueError(f"{pcm.shape[0]} samples, the encoder takes {self.frame_size}")
        cap = 1 << 16
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.dab_encoder_encode(
            self._h, pcm.ctypes.data_as(ctypes.c_void_p), pcm.shape[0],
            out.ctypes.data_as(ctypes.c_void_p), cap)
        if n < 0:
            raise ValueError(f"encode error {n}")
        return out[:n].tobytes()

    def flush(self) -> bytes:
        cap = 1 << 16
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.dab_encoder_encode(self._h, None, 0,
                                         out.ctypes.data_as(ctypes.c_void_p), cap)
        return out[:max(n, 0)].tobytes()

    def close(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dab_encoder_close(h)

    def __del__(self):
        self.close()


class MP2Encoder(_ShimEncoder):
    """Synthesizer fixture: PCM -> MP2 frames at DAB rates (48 kHz)."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bitrate_kbps: int = 128):
        super().__init__("mp2", sample_rate, channels, bitrate_kbps * 1000)


def _opens(codec_name: str, extradata: bytes = b"") -> bool:
    """Whether libavcodec opens the decoder (no exception involved: the
    shim returns a null handle)."""
    lib = codec_lib()
    h = lib.dab_decoder_open(codec_name.encode(), extradata, len(extradata))
    if h:
        lib.dab_decoder_close(h)
    return bool(h)


@functools.lru_cache(maxsize=None)
def aac_decode_available() -> bool:
    """Can the system decoder handle DAB+ 960-sample AAC frames?"""
    return codec_available() and _opens("aac", asc_for_header(DABPLUS_PROBE_HEADER))


@functools.lru_cache(maxsize=None)
def mp2_decode_available() -> bool:
    return codec_available() and _opens("mp2")

"""Audio mixing pipeline: N per-subchannel PCM sources -> resample -> mix ->
global gain -> sink.

Counterpart of tpudab.audio.pipeline (host numpy, a copy with its imports
pointed at the port). Reference parity: AudioPipeline / AudioPipelineSource
/ AudioPipelineSink from DAB-Radio's examples/audio/audio_pipeline.cpp (as
the reference's src/radio_block.cpp:46,61-75 and src/dab_module.h:36-55
use them):
sources accept int16 frames at the codec's native rate; the sink pulls mixed
float stereo at the sink rate (resampling inside the pipeline); global gain;
blocking source writes give backpressure. This implementation is pull-driven
(mix(n)) so it works offline and in a live thread loop alike.
"""

from __future__ import annotations

import threading
import wave
from typing import Dict, List, Optional

import numpy as np


class Resampler:
    """Streaming windowed-sinc polyphase resampler (per source).

    64-tap Kaiser polyphase kernel (tpudab_torch.utils.resample, a copy of
    tpudab's, whose image rejection tests/test_audio_aux.py measures
    against the scipy.signal oracle: < -60 dB).
    """

    def __init__(self, src_rate: int, dst_rate: int):
        from tpudab_torch.utils.resample import PolyphaseResampler

        self.src_rate = src_rate
        self.dst_rate = dst_rate
        self._poly = (None if src_rate == dst_rate else
                      PolyphaseResampler(src_rate / dst_rate, taps=64))

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: (n, 2) float32 at src_rate -> (m, 2) at dst_rate."""
        if self._poly is None:
            return x
        return self._poly.process(np.asarray(x, np.float32))


class AudioPipelineSource:
    """Ring of stereo float frames at the source's native rate."""

    def __init__(self, capacity_seconds: float = 4.0):
        self.sample_rate: Optional[int] = None
        self._buf: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._capacity_seconds = capacity_seconds
        self._dropped = 0

    def write(self, pcm: np.ndarray, sample_rate: int) -> None:
        """pcm: (n,) mono or (n, ch) int16/float; stored as stereo float32."""
        x = np.asarray(pcm)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = np.atleast_2d(x.astype(np.float32))
        if x.shape[0] == 1 and x.ndim == 2 and x.shape[1] > 2:
            x = x.T
        if x.ndim == 1 or x.shape[1] == 1:
            x = np.repeat(x.reshape(-1, 1), 2, axis=1)
        elif x.shape[1] > 2:
            x = x[:, :2]
        with self._lock:
            if self.sample_rate != sample_rate:
                self.sample_rate = sample_rate
            total = sum(b.shape[0] for b in self._buf)
            if sample_rate and total > self._capacity_seconds * sample_rate:
                self._dropped += x.shape[0]
                return
            self._buf.append(x)

    def read(self, n: int) -> np.ndarray:
        """Up to n stereo samples (padded with silence if underrun)."""
        with self._lock:
            chunks, got = [], 0
            while self._buf and got < n:
                c = self._buf[0]
                take = min(n - got, c.shape[0])
                chunks.append(c[:take])
                if take == c.shape[0]:
                    self._buf.pop(0)
                else:
                    self._buf[0] = c[take:]
                got += take
        if got < n:
            chunks.append(np.zeros((n - got, 2), dtype=np.float32))
        return np.concatenate(chunks, axis=0)

    @property
    def buffered(self) -> int:
        with self._lock:
            return sum(b.shape[0] for b in self._buf)


class AudioPipeline:
    """Mixes sources into a sink-rate stereo stream with global gain."""

    def __init__(self, sink_rate: int = 48_000):
        self.sink_rate = sink_rate
        self.global_gain = 1.0
        self.muted = False
        self._sources: Dict[int, AudioPipelineSource] = {}
        self._resamplers: Dict[int, Resampler] = {}
        self._source_gain: Dict[int, float] = {}
        self._lock = threading.Lock()

    # per-source volume/mute/boost (reference: render_radio_block.cpp
    # :842-885 volume sliders + mute + boost per channel and global)
    def set_source_gain(self, key: int, gain: float) -> None:
        with self._lock:
            self._source_gain[key] = float(gain)

    def get_source_gain(self, key: int) -> float:
        return self._source_gain.get(key, 1.0)

    def add_source(self, key: int) -> AudioPipelineSource:
        with self._lock:
            src = self._sources.get(key)
            if src is None:
                src = AudioPipelineSource()
                self._sources[key] = src
            return src

    def clear_sources(self) -> None:
        with self._lock:
            self._sources.clear()
            self._resamplers.clear()

    def set_sink_rate(self, rate: int) -> None:
        with self._lock:
            self.sink_rate = rate
            self._resamplers.clear()

    def mix(self, n_samples: int) -> np.ndarray:
        """Pull n_samples of mixed stereo float32 at sink rate."""
        out = np.zeros((n_samples, 2), dtype=np.float32)
        with self._lock:
            items = list(self._sources.items())
        for key, src in items:
            rate = src.sample_rate
            if rate is None:
                continue
            rs = self._resamplers.get(key)
            if rs is None or rs.src_rate != rate or rs.dst_rate != self.sink_rate:
                rs = Resampler(rate, self.sink_rate)
                self._resamplers[key] = rs
            need_src = int(np.ceil(n_samples * rate / self.sink_rate)) + 2
            resampled = rs.process(src.read(need_src))
            m = min(n_samples, resampled.shape[0])
            out[:m] += resampled[:m] * self._source_gain.get(key, 1.0)
        if self.muted:
            return np.zeros_like(out)
        return np.clip(out * self.global_gain, -1.0, 1.0)


class WavSink:
    """File sink: collects mixed audio into a 16-bit stereo WAV."""

    def __init__(self, path: str, sample_rate: int = 48_000):
        self.path = path
        self.sample_rate = sample_rate
        self._chunks: List[np.ndarray] = []

    def write(self, mixed: np.ndarray) -> None:
        self._chunks.append((np.clip(mixed, -1, 1) * 32767).astype(np.int16))

    def close(self) -> None:
        with wave.open(self.path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(self.sample_rate)
            if self._chunks:
                w.writeframes(np.concatenate(self._chunks).tobytes())

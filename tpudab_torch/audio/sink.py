"""Real-time audio playback sink: a pull thread feeding an OS audio device.

Counterpart of tpudab.audio.sink (a copy). Reference parity:
Audio_Player_Stream (the reference's src/dab_module.cpp:30-83): a
dedicated thread pulls mixed stereo frames from the pipeline in 100 ms
blocks into the host audio sink, sleeping when no data arrives to avoid
spinning (dab_module.cpp:71-80), and reacting to sink sample-rate changes
(dab_module.cpp:99-103).

The OS device is an `aplay` (ALSA) or `pacat` (PulseAudio) subprocess fed
s16le stereo on stdin — the subprocess's bounded pipe gives the same
backpressure pacing as a callback-driven device. A `device_factory`
injection point lets tests (and headless hosts) substitute a fake device;
pacing then falls back to a monotonic block schedule.
"""

from __future__ import annotations

import shutil
import subprocess
import threading
import time
from typing import Callable, Optional

import numpy as np


def _default_device_factory(rate: int):
    """Spawn an OS playback process reading s16le stereo from stdin."""
    if shutil.which("aplay"):
        cmd = ["aplay", "-q", "-f", "S16_LE", "-r", str(rate), "-c", "2",
               "-t", "raw"]
    elif shutil.which("pacat"):
        cmd = ["pacat", "--format=s16le", f"--rate={rate}", "--channels=2"]
    elif shutil.which("play"):  # sox
        cmd = ["play", "-q", "-t", "raw", "-e", "signed", "-b", "16",
               "-r", str(rate), "-c", "2", "-"]
    else:
        raise RuntimeError(
            "no audio playback tool found (aplay/pacat/play); "
            "pass device_factory= or use the WAV sink")
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    return proc.stdin, proc


class PlaybackSink:
    """Pulls pipeline.mix() in block_seconds chunks on its own thread and
    writes s16le stereo to the device stream."""

    def __init__(self, pipeline, rate: int = 48_000,
                 block_seconds: float = 0.1,
                 device_factory: Optional[Callable] = None):
        self.pipeline = pipeline
        self.rate = rate
        self.block_seconds = block_seconds
        self._factory = device_factory or _default_device_factory
        self._stream = None
        self._proc = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.blocks_written = 0
        self.underruns = 0

    # ---- lifecycle ----

    def start(self) -> "PlaybackSink":
        self._stream, self._proc = self._open()
        self.pipeline.set_sink_rate(self.rate)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpudab-audio-sink")
        self._thread.start()
        return self

    def _open(self):
        out = self._factory(self.rate)
        return out if isinstance(out, tuple) else (out, None)

    def set_rate(self, rate: int) -> None:
        """Sink sample-rate change: re-open the device and re-point the
        pipeline's resamplers (reference: dab_module.cpp:99-103)."""
        was_running = self._thread is not None and self._thread.is_alive()
        if was_running:
            self.stop()
        self.rate = rate
        if was_running:
            self.start()
        else:
            self.pipeline.set_sink_rate(rate)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._stream is not None:
            try:
                self._stream.close()
            except Exception:
                pass
            self._stream = None
        if self._proc is not None:
            try:
                self._proc.terminate()
                self._proc.wait(timeout=2.0)
            except Exception:
                pass
            self._proc = None

    # ---- pull loop ----

    def _run(self) -> None:
        n = int(self.rate * self.block_seconds)
        next_deadline = time.monotonic()
        while not self._stop.is_set():
            have_data = any(s.buffered for s in
                            self.pipeline._sources.values())
            if not have_data:
                # nothing buffered anywhere: sleep instead of emitting
                # silence at full speed (the reference's behaviour)
                self.underruns += 1
                self._stop.wait(self.block_seconds / 2)
                next_deadline = time.monotonic()
                continue
            mixed = self.pipeline.mix(n)
            data = (np.clip(mixed, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
            try:
                self._stream.write(data)
                if hasattr(self._stream, "flush"):
                    self._stream.flush()
            except (BrokenPipeError, ValueError, OSError):
                break
            self.blocks_written += 1
            # a real device paces us via pipe backpressure; for file-like
            # fakes keep a monotonic schedule so we don't outrun real time
            next_deadline += self.block_seconds
            delay = next_deadline - time.monotonic()
            if delay > 0:
                self._stop.wait(delay)
            else:
                next_deadline = time.monotonic()

"""rtl_tcp IQ source (native client) and a synth-fed rtl_tcp server
(counterpart of tpudab.host.rtl_tcp).

The live transport is the public rtl_tcp protocol: any RTL-SDR (or SDR++
rtl_tcp server) on the network becomes the antenna, as a VFO is the
reference plugin's (retuning it rebuilds the radio).

- TcpSource: ctypes wrapper over the native client (host/native/tcpsource.c,
  built into the ring library of host/native_lib.py): its reader thread
  converts the u8 stream to complex64 into the blocking SPSC ring;
  set_freq() retunes the remote dongle mid-stream.
- RtlTcpServer: a minimal in-process server for tests and demos. It answers
  the 12-byte header, honours SET_FREQ, and streams u8 IQ produced by a
  caller-supplied `source(freq_hz, n_samples) -> complex ndarray`, e.g. a
  dict of synthesised ensembles keyed by Band III channel frequency
  (LoopingCaptureSource).

Host code: sockets, numpy and the native thread; nothing here touches a
device.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import threading
from typing import Callable

import numpy as np

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE
from tpudab_torch.host.native_lib import RingBuffer, ring_lib


class TcpSource:
    """Native rtl_tcp client feeding a complex64 ring.

    Use .ring.read_complex64 as the StreamingRadio sample source; call
    set_freq() to retune (the radio's retune flow drains + reacquires).
    """

    def __init__(self, host: str, port: int, freq_hz: float = 0.0,
                 sample_rate: int = int(SAMPLING_RATE),
                 ring_capacity: int = 1 << 24):
        lib = ring_lib()
        self._lib = lib
        self.ring = RingBuffer(ring_capacity)
        self._h = lib.dab_tcp_source_start(
            host.encode(), int(port), self.ring._h,
            ctypes.c_uint32(int(sample_rate)), ctypes.c_uint32(int(freq_hz)))
        if not self._h:
            self.ring.close()
            raise ConnectionError(f"rtl_tcp connect failed: {host}:{port}")
        self.freq_hz = float(freq_hz)

    def set_freq(self, freq_hz: float) -> None:
        """Retune the remote dongle (rtl_tcp SET_FREQ)."""
        if self._lib.dab_tcp_set_freq(self._h, ctypes.c_uint32(int(freq_hz))):
            raise ConnectionError("rtl_tcp SET_FREQ failed")
        self.freq_hz = float(freq_hz)

    @property
    def done(self) -> bool:
        return bool(self._lib.dab_tcp_source_done(self._h))

    @property
    def tuner_type(self) -> int:
        return int(self._lib.dab_tcp_tuner_type(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.dab_tcp_source_stop(self._h)
            self._h = None
        self.ring.close()


# commands a real rtl_tcp server accepts (subset we honour)
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03


class RtlTcpServer:
    """Minimal rtl_tcp server over a sample-source callback (tests/demos).

    source(freq_hz, n) -> complex ndarray of n samples for the ensemble
    broadcast at freq_hz (off-channel frequencies should return noise).
    The stream is paced only by TCP backpressure: the client's ring and
    socket buffers provide the timing elasticity, as with a real dongle.
    """

    def __init__(self, source: Callable[[float, int], np.ndarray],
                 host: str = "127.0.0.1", port: int = 0,
                 tuner_type: int = 5, chunk_samples: int = 16384,
                 tune_latency_s: float = 0.0):
        self.source = source
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self.host = host
        self._chunk = chunk_samples
        self._stop = threading.Event()
        self.freq_hz = 0.0
        self.sample_rate = int(SAMPLING_RATE)
        self._tuner_type = tuner_type
        # Real dongles keep streaming the OLD channel for tens to hundreds
        # of ms after SET_FREQ (PLL settle + USB buffering). tune_latency_s
        # models that: the served frequency switches only after this many
        # seconds' worth of samples have been sent post-command.
        self.tune_latency_s = tune_latency_s
        self._pending_freq: float | None = None
        self._latency_left = 0
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def start(self) -> "RtlTcpServer":
        self._thread.start()
        return self

    def _serve(self) -> None:
        self._srv.settimeout(0.2)
        conn = None
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            try:
                self._session(conn)
            except (ConnectionError, BrokenPipeError, OSError):
                pass
            finally:
                conn.close()
        self._srv.close()

    def _session(self, conn: socket.socket) -> None:
        conn.sendall(b"RTL0" + struct.pack(">II", self._tuner_type, 29))
        conn.settimeout(0.01)
        pending = b""
        while not self._stop.is_set():
            # drain any queued commands (5 bytes each)
            try:
                pending += conn.recv(4096)
            except socket.timeout:
                pass
            while len(pending) >= 5:
                cmd, arg = pending[0], struct.unpack(">I", pending[1:5])[0]
                pending = pending[5:]
                if cmd == CMD_SET_FREQ:
                    if self.tune_latency_s > 0 and self.freq_hz:
                        self._pending_freq = float(arg)
                        self._latency_left = int(
                            self.tune_latency_s * self.sample_rate)
                    else:
                        self.freq_hz = float(arg)
                elif cmd == CMD_SET_SAMPLE_RATE:
                    self.sample_rate = int(arg)
            if self._pending_freq is not None and self._latency_left <= 0:
                self.freq_hz = self._pending_freq
                self._pending_freq = None
            iq = np.asarray(self.source(self.freq_hz, self._chunk))
            self._latency_left -= iq.shape[0]
            u8 = np.empty(iq.shape[0] * 2, dtype=np.uint8)
            scaled_re = np.clip(iq.real * 128.0 + 127.5, 0, 255)
            scaled_im = np.clip(iq.imag * 128.0 + 127.5, 0, 255)
            u8[0::2] = scaled_re.astype(np.uint8)
            u8[1::2] = scaled_im.astype(np.uint8)
            conn.settimeout(None)
            conn.sendall(u8.tobytes())
            conn.settimeout(0.01)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class LoopingCaptureSource:
    """source() adapter: a dict {freq_hz: complex64 capture} looped forever;
    unknown frequencies yield white noise (no ensemble on that channel)."""

    def __init__(self, captures: dict, noise_power: float = 1e-2,
                 freq_tolerance_hz: float = 1e5, seed: int = 0):
        self.captures = dict(captures)
        self.noise = noise_power
        self.tol = freq_tolerance_hz
        self._pos = {}
        self._rng = np.random.default_rng(seed)

    def __call__(self, freq_hz: float, n: int) -> np.ndarray:
        for f, cap in self.captures.items():
            if abs(f - freq_hz) <= self.tol:
                pos = self._pos.get(f, 0)
                idx = (pos + np.arange(n)) % cap.shape[0]
                self._pos[f] = (pos + n) % cap.shape[0]
                return cap[idx]
        scale = np.sqrt(self.noise / 2)
        return (scale * (self._rng.standard_normal(n)
                         + 1j * self._rng.standard_normal(n))
                ).astype(np.complex64)

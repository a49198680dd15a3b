"""ctypes loader of the port's native host libraries, built with gcc on first
use: counterpart of tpudab.host.native_lib.

Two libraries, each built into tpudab_torch/_build/ under a file name that
holds a hash of its sources, the compiler and the flags (a changed source
builds anew; a failed build raises):
- the ring (host/native/ringbuf.c and tcpsource.c, linked with -lpthread
  alone): RingBuffer, a blocking SPSC byte ring; IQReader, a C thread that
  reads a file or stdin, converts u8/s8/s16/f32 IQ to complex64 and writes
  it into a ring; and the rtl_tcp client's reader thread, which writes a
  socket's u8 IQ into a ring as complex64 (host/rtl_tcp.py drives it). It
  links no FFmpeg, so the live loop streams on a machine that has none;
- the codec shim (host/native/codec_shim.c, -lavcodec -lavutil), which
  audio/codecs.py drives. Whether it can be built is decided before any
  build by ffmpeg_probe(): libavcodec's and libavutil's headers on the
  compiler's include path and their shared libraries on its linker's path.
  Where the probe finds FFmpeg, a failed build raises; where it does not,
  codec_lib() raises without building and the codecs report themselves
  unavailable (audio/codecs.py).

tpudab builds the three native sources into one library that links
libavcodec. The ring and the reader are host code: they
touch no device and take none. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

PKG = Path(__file__).resolve().parent.parent
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = PKG / "_build"
CFLAGS = ("-O2", "-fPIC", "-shared", "-Wall", "-Wextra", "-Wno-unused-parameter")
RING = ("ring", ("ringbuf.c", "tcpsource.c"), ("-lpthread",))
CODEC = ("codec", ("codec_shim.c",), ("-lavcodec", "-lavutil"))
# what the codec shim includes and links, as the probe looks for them
FFMPEG_HEADERS = ("libavcodec/avcodec.h", "libavutil/opt.h", "libavutil/channel_layout.h")
FFMPEG_LIBS = ("libavcodec.so", "libavutil.so")

IQ_FORMATS = {"u8": 0, "s8": 1, "s16": 2, "f32": 3}


def _cc() -> str:
    cc = os.environ.get("CC") or shutil.which("gcc") or shutil.which("cc")
    if not cc:
        raise RuntimeError("no C compiler found (gcc or cc on PATH, or CC)")
    return cc


def _build(name: str, sources: Tuple[str, ...], libs: Tuple[str, ...]) -> Path:
    """Compile host/native/<sources> into one shared library in _build/
    unless this hash is built already; returns its path."""
    cc = _cc()
    srcs = [NATIVE / s for s in sources]
    h = hashlib.sha256(" ".join((os.path.basename(cc), *CFLAGS, *libs)).encode())
    for src in srcs:
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libtpudab_torch_{name}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cmd = [cc, *CFLAGS, *map(str, srcs), "-o", f"{tmp}/lib.so", *libs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cc} failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(f"{tmp}/lib.so", so)
    return so


@functools.lru_cache(maxsize=None)
def ffmpeg_probe() -> Tuple[bool, str]:
    """(found, what): whether FFmpeg's codec headers are on the C compiler's
    include path and its libraries on the linker's, asked of the compiler
    itself (its `-v` include search list and `-print-file-name`), with no
    build. `what` names the files found, or the first one missing."""
    try:
        cc = _cc()
    except RuntimeError as e:
        return False, str(e)
    proc = subprocess.run([cc, "-xc", "-E", "-v", "-"], input="", capture_output=True,
                          text=True)
    lines = proc.stderr.splitlines()
    dirs = []
    if "#include <...> search starts here:" in lines:
        for ln in lines[lines.index("#include <...> search starts here:") + 1:]:
            if ln.startswith("End of search list"):
                break
            dirs.append(ln.strip())
    found = []
    for header in FFMPEG_HEADERS:
        path = next((os.path.join(d, header) for d in dirs
                     if os.path.exists(os.path.join(d, header))), None)
        if path is None:
            return False, f"{header} is not on {cc}'s include path"
        found.append(os.path.normpath(path))
    for lib in FFMPEG_LIBS:
        path = subprocess.run([cc, f"-print-file-name={lib}"], capture_output=True,
                              text=True).stdout.strip()
        if not (os.path.isabs(path) and os.path.exists(path)):
            return False, f"{lib} is not on {cc}'s library path"
        found.append(os.path.normpath(path))
    return True, ", ".join(found)


@functools.lru_cache(maxsize=1)
def ring_lib() -> ctypes.CDLL:
    """The ring, IQ reader and rtl_tcp client library (no FFmpeg), with its
    argtypes."""
    lib = ctypes.CDLL(str(_build(*RING)))
    c = ctypes.c_void_p
    lib.dab_ring_create.restype = c
    lib.dab_ring_create.argtypes = [ctypes.c_size_t]
    lib.dab_ring_write.restype = ctypes.c_long
    lib.dab_ring_write.argtypes = [c, ctypes.c_char_p, ctypes.c_size_t]
    lib.dab_ring_read.restype = ctypes.c_long
    lib.dab_ring_read.argtypes = [c, ctypes.c_void_p, ctypes.c_size_t]
    lib.dab_ring_fill.restype = ctypes.c_size_t
    lib.dab_ring_fill.argtypes = [c]
    lib.dab_ring_close.restype = None
    lib.dab_ring_close.argtypes = [c]
    lib.dab_ring_destroy.restype = None
    lib.dab_ring_destroy.argtypes = [c]
    lib.dab_iq_reader_start.restype = c
    lib.dab_iq_reader_start.argtypes = [ctypes.c_char_p, ctypes.c_int, c]
    lib.dab_iq_reader_done.restype = ctypes.c_int
    lib.dab_iq_reader_done.argtypes = [c]
    lib.dab_iq_reader_join.restype = None
    lib.dab_iq_reader_join.argtypes = [c]
    lib.dab_tcp_source_start.restype = c
    lib.dab_tcp_source_start.argtypes = [ctypes.c_char_p, ctypes.c_int, c, ctypes.c_uint32,
                                         ctypes.c_uint32]
    lib.dab_tcp_set_freq.restype = ctypes.c_int
    lib.dab_tcp_set_freq.argtypes = [c, ctypes.c_uint32]
    lib.dab_tcp_source_done.restype = ctypes.c_int
    lib.dab_tcp_source_done.argtypes = [c]
    lib.dab_tcp_tuner_type.restype = ctypes.c_uint32
    lib.dab_tcp_tuner_type.argtypes = [c]
    lib.dab_tcp_source_stop.restype = None
    lib.dab_tcp_source_stop.argtypes = [c]
    return lib


def codec_available() -> bool:
    """ffmpeg_probe()'s verdict; where it found no FFmpeg, says why once on
    stderr."""
    found, what = ffmpeg_probe()
    if not found:
        _say_once(f"tpudab_torch: no FFmpeg codecs ({what}); audio is not decoded to PCM")
    return found


@functools.lru_cache(maxsize=None)
def _say_once(msg: str) -> None:
    print(msg, file=sys.stderr)


@functools.lru_cache(maxsize=1)
def codec_lib() -> ctypes.CDLL:
    """The codec shim library, with its argtypes. Raises without building
    where ffmpeg_probe() found no FFmpeg; a failed build raises."""
    found, what = ffmpeg_probe()
    if not found:
        raise RuntimeError(f"the codec shim needs FFmpeg: {what}")
    lib = ctypes.CDLL(str(_build(*CODEC)))
    c = ctypes.c_void_p
    lib.dab_decoder_open.restype = c
    lib.dab_decoder_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.dab_decoder_decode.restype = ctypes.c_int
    lib.dab_decoder_decode.argtypes = [
        c, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dab_decoder_close.restype = None
    lib.dab_decoder_close.argtypes = [c]
    lib.dab_encoder_open.restype = c
    lib.dab_encoder_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dab_encoder_frame_size.restype = ctypes.c_int
    lib.dab_encoder_frame_size.argtypes = [c]
    lib.dab_encoder_encode.restype = ctypes.c_int
    lib.dab_encoder_encode.argtypes = [c, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int]
    lib.dab_encoder_close.restype = None
    lib.dab_encoder_close.argtypes = [c]
    return lib


class RingBuffer:
    """Blocking SPSC byte ring (native). Reference: ThreadedRingBuffer."""

    def __init__(self, capacity: int):
        self._lib = ring_lib()
        self._h = self._lib.dab_ring_create(capacity)
        if not self._h:
            raise MemoryError("ring allocation failed")

    def write(self, data: bytes) -> int:
        return self._lib.dab_ring_write(self._h, data, len(data))

    def read(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        got = self._lib.dab_ring_read(self._h, buf, n)
        return buf.raw[:got]

    def read_complex64(self, n_samples: int) -> np.ndarray:
        """Up to n_samples complex64 (fewer only once the ring is closed)."""
        return np.frombuffer(self.read(n_samples * 8), dtype=np.complex64)

    @property
    def fill(self) -> int:
        return self._lib.dab_ring_fill(self._h)

    def close(self) -> None:
        """Unblock both sides: reads drain what is left, writes stop."""
        if self._h:
            self._lib.dab_ring_close(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dab_ring_close(h)
            self._lib.dab_ring_destroy(h)


class IQReader:
    """Background native reader: a file or stdin ("-") -> complex64 ring."""

    def __init__(self, path: str, fmt: str = "f32", ring_capacity: int = 1 << 24):
        self._lib = ring_lib()
        self.path = path
        self.ring = RingBuffer(ring_capacity)
        self._h = self._lib.dab_iq_reader_start(path.encode(), IQ_FORMATS[fmt], self.ring._h)
        if not self._h:
            self.ring.close()
            raise FileNotFoundError(path)

    @property
    def done(self) -> bool:
        return bool(self._lib.dab_iq_reader_done(self._h))

    def join(self) -> None:
        if self._h:
            self._lib.dab_iq_reader_join(self._h)
            self._h = None

    def close(self) -> None:
        """Close the ring, then join the reader thread, which stops at its
        next write. A reader of stdin is left to end at its next read (it
        may be blocked on a pipe that never closes)."""
        self.ring.close()
        if self.path != "-":
            self.join()

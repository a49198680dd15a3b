"""The port's native host libraries (tpudab_torch.host.native_lib): the ring
and the IQ reader against tpudab's, the reader on stdin, the ring library's
independence from FFmpeg, and the codec probe's verdicts.

Tolerance: none; the ring moves bytes and the reader converts each sample
format as tpudab's reader and `_load_iq` do, so the samples are equal.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tpudab_torch.audio.codecs as p_codecs
from tpudab.host.cli import _load_iq as jax_load_iq
from tpudab.host.native_lib import IQReader as JaxReader
from tpudab.host.native_lib import RingBuffer as JaxRing
from tpudab_torch.host import native_lib
from tpudab_torch.host.native_lib import IQReader, RingBuffer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = {"u8": np.uint8, "s8": np.int8, "s16": np.int16, "f32": np.float32}


def test_ring_equals_tpudab():
    data = np.random.default_rng(1).integers(0, 256, 3000).astype(np.uint8).tobytes()
    got = []
    for cls in (RingBuffer, JaxRing):
        ring = cls(1024)
        out = []
        for lo in range(0, 3000, 700):     # wraps the 1,024-byte ring
            assert ring.write(data[lo: lo + 700]) == len(data[lo: lo + 700])
            out.append(ring.read(len(data[lo: lo + 700])))
        assert ring.fill == 0
        ring.write(np.arange(3, dtype=np.complex64).tobytes())
        ring.close()
        out.append(ring.read_complex64(8).tobytes())   # fewer once closed
        out.append(ring.read(4))                       # nothing left
        assert ring.write(b"xyz") == 0                 # writes stop
        got.append(out)
    assert got[0] == got[1] and b"".join(got[0][:-2]) == data


def raw_capture(fmt: str, path: str, n: int = 100_003) -> np.ndarray:
    rng = np.random.default_rng(4)
    if fmt == "f32":
        raw = rng.standard_normal(2 * n).astype(np.float32)
    else:
        info = np.iinfo(FORMATS[fmt])
        raw = rng.integers(info.min, info.max + 1, 2 * n).astype(FORMATS[fmt])
    raw.tofile(path)
    return raw


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_iq_reader_equals_tpudab(tmp_path, fmt):
    """Every sample format, read through the ring in uneven pieces: the
    port's reader, tpudab's reader and tpudab's _load_iq agree."""
    path = str(tmp_path / f"cap.{fmt}")
    raw_capture(fmt, path)
    want = jax_load_iq(path, fmt)
    for cls in (IQReader, JaxReader):
        reader = cls(path, fmt=fmt, ring_capacity=1 << 16)
        parts = []
        while True:
            x = reader.ring.read_complex64(7777)
            parts.append(x)
            if len(x) < 7777:
                break
        got = np.concatenate(parts)
        assert got.dtype == np.complex64 and np.array_equal(got, want), cls
        reader.join()


def test_iq_reader_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        IQReader(str(tmp_path / "absent.f32"))


STDIN_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from tpudab_torch.host.native_lib import IQReader, ring_lib
    reader = IQReader("-", fmt="s16")
    x = reader.ring.read_complex64(1 << 20)
    reader.close()
    x.tofile(sys.argv[1])
    maps = open("/proc/self/maps").read()
    print(len(x), "avcodec" in maps, ring_lib()._name)
""")


def test_iq_reader_stdin_and_no_ffmpeg(tmp_path):
    """`-` reads stdin; the process that loads the ring library maps no
    libavcodec (the live loop streams where FFmpeg is absent), and the
    library's name carries its source hash."""
    path, out = str(tmp_path / "cap.s16"), str(tmp_path / "got.c64")
    raw_capture("s16", path, 5000)
    with open(path, "rb") as f:
        proc = subprocess.run([sys.executable, "-c", STDIN_SCRIPT, out], stdin=f, cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                              text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, mapped, name = proc.stdout.split()
    assert n == "5000" and mapped == "False"
    assert os.path.basename(name).startswith("libtpudab_torch_ring_")
    assert np.array_equal(np.fromfile(out, np.complex64), jax_load_iq(path, "s16"))


@pytest.fixture
def fake_cc(tmp_path, monkeypatch):
    """A C compiler that lists one empty include directory, finds no
    library and fails every build; the caches of the probe and the codecs
    cleared before and after."""
    inc = tmp_path / "include"
    inc.mkdir()
    cc = tmp_path / "fakecc"
    cc.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        case "$*" in
          *-print-file-name=*) echo "${{1#-print-file-name=}}" ;;
          *-E*) printf '#include <...> search starts here:\\n {inc}\\nEnd of search list.\\n' >&2 ;;
          *) echo "fakecc: cannot build" >&2; exit 1 ;;
        esac
        """))
    cc.chmod(0o755)
    monkeypatch.setenv("CC", str(cc))
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    caches = (native_lib.ffmpeg_probe, native_lib.codec_lib, native_lib._say_once,
              p_codecs.aac_decode_available, p_codecs.mp2_decode_available)
    for c in caches:
        c.cache_clear()
    yield cc
    for c in caches:
        c.cache_clear()


def test_codec_probe_without_ffmpeg(fake_cc, capsys):
    """No FFmpeg on the compiler's paths: the probe says which file is
    missing, nothing is built, the codecs report themselves unavailable
    and say why once on stderr, and the shim's loader refuses."""
    found, what = native_lib.ffmpeg_probe()
    assert not found and what == f"libavcodec/avcodec.h is not on {fake_cc}'s include path"
    assert not p_codecs.aac_decode_available() and not p_codecs.mp2_decode_available()
    err = capsys.readouterr().err
    assert err.count("no FFmpeg codecs") == 1 and what in err
    with pytest.raises(RuntimeError, match="needs FFmpeg"):
        native_lib.codec_lib()
    assert not (native_lib.BUILD_DIR).exists()


def test_codec_probe_finds_no_library(fake_cc, tmp_path):
    for h in native_lib.FFMPEG_HEADERS:
        (tmp_path / "include" / h).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / "include" / h).write_text("")
    assert native_lib.ffmpeg_probe() == (False, f"libavcodec.so is not on {fake_cc}'s "
                                                f"library path")


def test_failed_build_raises(fake_cc):
    with pytest.raises(RuntimeError, match="cannot build"):
        native_lib._build(*native_lib.RING)


def _code(path) -> list:
    """A C source's code lines: comments out, blank lines dropped."""
    import re
    text = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return [ln.rstrip() for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("name", ["ringbuf.c", "codec_shim.c", "tcpsource.c"])
def test_native_sources_are_copies_of_tpudab(name):
    """Each of the port's C sources is tpudab's, line for line: only the
    comments were reworded."""
    port = os.path.join(ROOT, "tpudab_torch", "host", "native", name)
    jax = os.path.join(ROOT, "tpudab", "host", "native", name)
    assert _code(port) == _code(jax)
    assert len(_code(port)) > 50


def test_ring_library_links_the_rtl_tcp_client():
    """tcpsource.c is built into the ring library (no FFmpeg): its five
    entry points are there, with their ctypes signatures."""
    lib = native_lib.ring_lib()
    for fn in ("dab_tcp_source_start", "dab_tcp_set_freq", "dab_tcp_source_done",
               "dab_tcp_tuner_type", "dab_tcp_source_stop"):
        assert getattr(lib, fn).argtypes, fn

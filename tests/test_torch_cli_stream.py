"""The port's `stream` and the PCM half of its `decode` against tpudab's, on
a capture made by tpudab's `synth` (1.5 s: a UEP 128 kbps MP2 service whose
frames carry a tone, and a DAB+ service whose AUs are AAC from the native
encoder, with PAD; CFO 1,200 Hz, 22 dB).

Tolerance: none. `stream --device cpu --no-dashboard --wav` writes the same
WAV as tpudab's `stream --no-dashboard --wav`, from a file and from stdin;
`decode --device cpu` writes the same subch<N>.wav files (and every other
payload file) as tpudab's `decode`. These skip only where the port's codec
probe finds no FFmpeg (without it neither package decodes PCM).
"""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.host.cli import main as jax_main
from tpudab_torch.host.cli import main
from tpudab_torch.host.native_lib import ffmpeg_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    found, what = ffmpeg_probe()
    if not found:
        pytest.skip(f"the codec probe found no FFmpeg: {what}")
    path = tmp_path_factory.mktemp("stream") / "cap.f32"
    assert jax_main(["synth", str(path), "--seconds", "1.5", "--snr", "22",
                     "--cfo", "1200"]) == 0
    return path


def wav_frames(path):
    with wave.open(str(path)) as w:
        return w.getnchannels(), w.getframerate(), w.readframes(w.getnframes())


def test_stream_wav_equals_tpudab(capture, tmp_path, capsys):
    port, want = tmp_path / "port.wav", tmp_path / "tpudab.wav"
    assert main(["stream", str(capture), "--device", "cpu", "--no-dashboard",
                 "--wav", str(port)]) == 0
    assert jax_main(["stream", str(capture), "--no-dashboard", "--wav", str(want)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out.count("stopped: 15 frames, 0 reacquisitions") == 2
    assert port.read_bytes() == want.read_bytes()
    channels, rate, pcm = wav_frames(port)
    x = np.frombuffer(pcm, np.int16).astype(np.float64)
    # one block of the mix a batch: 15 frames in batches of 4, 18,432 samples each
    assert (channels, rate) == (2, 48000) and len(x) == 2 * 4 * int(48_000 * 0.096 * 4)
    assert np.sqrt(np.mean(x ** 2)) > 1000      # the MP2 tone and the AAC chirp

    # the same capture on stdin, through the native reader's "-" path
    piped = tmp_path / "piped.wav"
    with open(capture, "rb") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "tpudab_torch.host.cli", "stream", "-", "--device", "cpu",
             "--no-dashboard", "--no-device-step", "--wav", str(piped)],
            stdin=f, cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert piped.read_bytes() == port.read_bytes()


def test_decode_wavs_equal_tpudab(capture, tmp_path, capsys):
    files = []
    for fn, argv in ((main, ["--device", "cpu"]), (jax_main, [])):
        out = tmp_path / fn.__module__
        assert fn(["decode", str(capture), "--out-dir", str(out), *argv]) == 0
        files.append({f: (out / f).read_bytes() for f in sorted(os.listdir(out))})
    lines = capsys.readouterr().out.splitlines()
    assert files[0] == files[1]
    assert {"subch1.wav", "subch2.wav", "subch1.mp2", "subch2.aac.raw"} <= set(files[0])
    assert lines.count("subch 1: decoded PCM -> subch1.wav") == 2
    for name in ("subch1.wav", "subch2.wav"):
        channels, rate, pcm = wav_frames(tmp_path / main.__module__ / name)
        x = np.frombuffer(pcm, np.int16).astype(np.float64)
        assert (channels, rate) == (2, 48000) and np.sqrt(np.mean(x ** 2)) > 1000, name


def test_stream_refuses_a_missing_card(capture, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["stream", str(capture), "--no-dashboard"])

"""The port's jax-free synthesizer gives tpudab.synth's bits and IQ bit for
bit for the same spec and seed."""

import numpy as np
import pytest

import tpudab.synth as jsynth
import tpudab_torch.synth as tsynth


def _spec(pkg, layout):
    return pkg.EnsembleSpec(
        ensemble_id=0xBE9C, label="Bench Ensemble",
        services=[pkg.ServiceSpec(0xC200 + sid, f"Bench {sid}", [(0, pkg.ASCTY_DAB_PLUS, sid)])
                  for sid, *_ in layout],
        subchannels=[pkg.SubchannelSpec(sid, start_cu=start, size_cu=size, protection=prot)
                     for sid, start, size, prot in layout])


LAYOUTS = {
    "bench": [(i + 1, 108 * i, 108, ("eep", 3, 0)) for i in range(6)],
    "mixed": [(1, 0, 24, ("eep", 3, 0)), (2, 30, 54, ("eep", 1, 1)),
              (3, 100, 64, ("uep", 128, 5))],
    "single": [(1, 0, 36, ("eep", 3, 0))],
}


@pytest.mark.parametrize("name,mode", [("bench", 1), ("mixed", 1), ("single", 1),
                                       ("single", 3)])
def test_synth_iq_bit_exact(name, mode):
    layout = LAYOUTS[name]
    ref = jsynth.EnsembleSynthesizer(_spec(jsynth, layout), mode=mode, seed=1)
    port = tsynth.EnsembleSynthesizer(_spec(tsynth, layout), mode=mode, seed=1)
    data = np.random.default_rng(2).integers(0, 256, (8, 432)).astype(np.uint8)
    for s in (ref, port):
        s.payload_fn[1] = lambda m: data[m, : layout[0][2] // 6 * 24].tobytes()
    n = 2
    for i in range(n):
        np.testing.assert_array_equal(port.frame_bits(i), ref.frame_bits(i))
    np.testing.assert_array_equal(port.frames_iq(n), ref.frames_iq(n))
    bits = ref.frame_bits(0)
    np.testing.assert_array_equal(tsynth.modulate_frame_bits(bits, mode),
                                  jsynth.modulate_frame_bits(bits, mode))


# ---------------------------------------------------------------------------
# the `synth` subcommand and its demo streams (need FFmpeg's encoders)
# ---------------------------------------------------------------------------

@pytest.fixture
def ffmpeg():
    from tpudab_torch.host.native_lib import ffmpeg_probe
    found, what = ffmpeg_probe()
    if not found:
        pytest.skip(f"the codec probe found no FFmpeg: {what}")


def test_demo_streams_equal_tpudab(ffmpeg):
    """synth/payload.py's demo streams against tpudab's synth's: the MP2
    tone and the DAB+ stream with its PAD, byte for byte."""
    from tpudab.host.cli import _dabplus_stream, _mp2_tone_stream
    from tpudab_torch.synth.payload import demo_dabplus_stream, mp2_tone_stream

    np.testing.assert_array_equal(mp2_tone_stream(128, 24), _mp2_tone_stream(128, 24))
    stream, aus = demo_dabplus_stream(96, 24)
    np.testing.assert_array_equal(stream, _dabplus_stream(96, 24))
    assert len(aus) == 6 * (24 // 5 + 1)


def test_demo_stream_without_pad_carries_the_tone(ffmpeg):
    """The no-PAD option (chip_smoke.py's codec capture): the receiver's
    superframe parser gets back every AU, no PAD DSE leads any, and the
    DAB+ decoder turns them into the tone."""
    from tpudab_torch.audio.codecs import AACDecoder
    from tpudab_torch.audio.superframe import SuperFrameHeader, parse_superframe
    from tpudab_torch.synth.payload import demo_dabplus_stream

    stream, aus = demo_dabplus_stream(96, 10, with_pad=False)
    got = []
    for k in range(2):
        sf = parse_superframe(stream[5 * k: 5 * k + 5].reshape(-1), 96)
        got.extend(bytes(a) for a in sf.access_units)
    assert got == aus[:12]
    assert all(a[0] >> 5 != 4 for a in got)     # no DSE (syntax element 4) leads an AU
    dec = AACDecoder(SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0,
                                      mpeg_surround=0))
    pcm = np.concatenate([dec.decode(a) for a in got[2:]]).astype(np.float64)
    assert np.sqrt(np.mean(pcm ** 2)) > 2000


def test_cli_synth_equals_tpudab(ffmpeg, tmp_path):
    """`python -m tpudab_torch.host.cli synth f --seconds 0.5` writes
    tpudab's synth's capture with the same flags, byte for byte."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = {}
    for pkg in ("tpudab_torch", "tpudab"):
        files[pkg] = tmp_path / f"{pkg}.f32"
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.host.cli", "synth",
                               str(files[pkg]), "--seconds", "0.5", "--snr", "20"],
                              cwd=root, env=dict(os.environ, PYTHONPATH=root),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "Wrote 5 frames (0.48 s)" in proc.stdout
    assert files["tpudab_torch"].read_bytes() == files["tpudab"].read_bytes()
    assert files["tpudab"].stat().st_size == 5 * 196608 * 8


def test_cli_synth_without_ffmpeg_writes_nothing(tmp_path, monkeypatch, capsys):
    """Where the codec probe finds no FFmpeg, synth fails with the
    encoder's "unavailable" error and writes no capture without audio."""
    from tpudab_torch.host import cli, native_lib

    monkeypatch.setattr(native_lib, "ffmpeg_probe", lambda: (False, "no avcodec.h"))
    assert cli.main(["synth", str(tmp_path / "cap.f32"), "--seconds", "0.5"]) == 1
    assert "encoder mp2 unavailable (no FFmpeg: no avcodec.h)" in capsys.readouterr().err
    assert not (tmp_path / "cap.f32").exists()

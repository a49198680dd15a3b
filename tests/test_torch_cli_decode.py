"""The port's `decode` and `info` subcommands against tpudab's, with
--device cpu, on one impaired IQ file: a DAB+ service (superframes of
seeded random AUs led by PAD with a dynamic label and a slide) on a 36-CU
EEP 3-A subchannel, 10 frames, CFO 3,400 Hz, 777 samples of delay, 18 dB
SNR.

Tolerances: the payload files (the PCM of subch<N>.wav among them) and the
printed listing are equal, except the printed net frequency (held
within 1 Hz: the acquisitions sum in other orders); `info`'s frame_start
and coarse_bins equal, its Hz within 1 Hz and its qualities within a
relative 1e-3 (as tests/test_torch_sync.py).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.host.cli import _load_iq as jax_load_iq
from tpudab.host.cli import main as jax_main
from tpudab.host.config import ConfigManager as JaxConfigManager
from tpudab.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer, ServiceSpec,
                          SubchannelSpec)
from tpudab.synth.modulator import Impairments, apply_impairments, modulate_frame_bits
from tpudab_torch.host.cli import _load_iq, main
from tpudab_torch.synth.payload import dabplus_stream

N_FRAMES, DELAY, FRAME_LEN = 10, 777, 196608


def write_iq(iq, path):
    inter = np.empty(iq.shape[0] * 2, dtype=np.float32)
    inter[0::2], inter[1::2] = iq.real, iq.imag
    inter.tofile(path)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    spec = EnsembleSpec(0xD0DE, "Decode Mux",
                        [ServiceSpec(0xC631, "Plus Svc", [(0, ASCTY_DAB_PLUS, 5)],
                                     programme_type=12)],
                        [SubchannelSpec(5, start_cu=0, size_cu=36, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=5)
    stream, aus = dabplus_stream(48, N_FRAMES * 4 + 20, seed=6, with_pad=True)
    synth.payload_fn[5] = lambda m: stream[m].tobytes()
    iq = np.concatenate([modulate_frame_bits(synth.frame_bits(i)) for i in range(N_FRAMES)])
    iq = apply_impairments(iq, Impairments(freq_offset_hz=3400.0, delay_samples=DELAY,
                                           snr_db=18, seed=7))
    path = tmp_path_factory.mktemp("cli") / "cap.f32"
    write_iq(iq, path)
    return path, iq, aus


def run_cli(fn, argv, out_dir, capsys):
    """(printed lines, {payload file: bytes}) of one CLI run."""
    capsys.readouterr()
    assert fn(argv + (["--out-dir", str(out_dir)] if out_dir else [])) == 0
    lines = capsys.readouterr().out
    if out_dir:
        lines = lines.replace(str(out_dir), "OUT")
    files = {f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))} \
        if out_dir else {}
    return lines.splitlines(), files


def net_freq(lines):
    (line,) = [ln for ln in lines if ln.startswith("Sync:")]
    return float(line.split("net_freq=")[1].split()[0])


def assert_same_run(got, want):
    (glines, gfiles), (wlines, wfiles) = got, want
    assert abs(net_freq(glines) - net_freq(wlines)) < 1.0
    strip = lambda lines: [ln for ln in lines if not ln.startswith(("Sync:", "Resumed"))]
    assert strip(glines) == strip(wlines)
    assert gfiles == wfiles


def both(argv, tmp_path, capsys, tag=""):
    return (run_cli(main, argv + ["--device", "cpu"], tmp_path / f"port{tag}", capsys),
            run_cli(jax_main, argv, tmp_path / f"jax{tag}", capsys))


@pytest.mark.parametrize("device_step", [False, True], ids=["host", "step"])
def test_decode_matches_tpudab(capture, device_step, tmp_path, capsys):
    path, _, aus = capture
    argv = ["decode", str(path), "--batch-frames", "4"] + (["--device-step"] if device_step else [])
    got, want = both(argv, tmp_path, capsys)
    assert_same_run(got, want)
    lines, files = got
    assert set(files) == {"subch5.aac.raw", "subch5_demo.png"}
    assert f"FIC: {12 * N_FRAMES} FIBs, 0 CRC errors" in lines
    assert any("Ensemble: 'Decode Mux'" in ln for ln in lines)
    assert any(f"frame_start={DELAY}" in ln for ln in lines)
    assert any("dynamic label: 'tpudab demo - Now Playing: Chirp'" in ln for ln in lines)
    # the AU file: each AU behind its 4-byte length, the known AUs in order
    raw, got_aus = files["subch5.aac.raw"], []
    while raw:
        n = int.from_bytes(raw[:4], "little")
        got_aus.append(raw[4: 4 + n])
        raw = raw[4 + n:]
    assert len(got_aus) >= 6 and got_aus == aus[: len(got_aus)]


def test_decode_with_config_matches_tpudab(capture, tmp_path, capsys):
    """--config: a RadioConfig JSON written by tpudab's ConfigManager sets
    the batch (2 frames) and the sync tunables for both."""
    path, _, _ = capture
    cfg = str(tmp_path / "radio.json")
    JaxConfigManager(cfg).set(batch_frames=2, max_coarse_bins=20)
    got, want = both(["decode", str(path), "--config", cfg], tmp_path, capsys)
    assert_same_run(got, want)
    assert "subch5.aac.raw" in got[1]


def test_decode_checkpoint_resume_matches_tpudab(capture, tmp_path, capsys):
    """--checkpoint on the first part, --resume on the rest (split at the
    printed next_pos), in both packages: each run prints and writes the
    same as tpudab's; the first part's checkpoint holds the next_pos where
    the second part starts."""
    path, iq, _ = capture
    split = DELAY + 6 * FRAME_LEN
    write_iq(iq[:split], tmp_path / "a.f32")
    write_iq(iq[split:], tmp_path / "b.f32")
    runs = {}
    for key, fn, extra in (("port", main, ["--device", "cpu"]), ("jax", jax_main, [])):
        ck = str(tmp_path / f"{key}_ck")
        a = run_cli(fn, ["decode", str(tmp_path / "a.f32"), "--device-step", "--batch-frames",
                         "4", "--checkpoint", ck] + extra, tmp_path / f"{key}_a", capsys)
        assert f"Checkpoint -> {ck} (next_pos={split})" in a[0]
        b = run_cli(fn, ["decode", str(tmp_path / "b.f32"), "--device-step", "--batch-frames",
                         "4", "--resume", ck] + extra, tmp_path / f"{key}_b", capsys)
        assert any(ln.startswith(f"Resumed from {ck}") for ln in b[0])
        runs[key] = (a, b)
    for k in range(2):
        got, want = runs["port"][k], runs["jax"][k]
        want = ([ln.replace("jax_ck", "port_ck") for ln in want[0]], want[1])
        assert_same_run(got, want)
    assert "subch5.aac.raw" in runs["port"][1][1]


def test_info_matches_tpudab(capture, capsys):
    path, _, _ = capture
    got = dict(ln.split(": ") for ln in run_cli(main, ["info", str(path), "--device", "cpu"],
                                                None, capsys)[0])
    want = dict(ln.split(": ") for ln in run_cli(jax_main, ["info", str(path)], None, capsys)[0])
    assert list(got) == list(want)
    for k in ("frame_start", "coarse_bins"):
        assert got[k] == want[k]
    assert (int(got["frame_start"]), int(got["coarse_bins"])) == (DELAY, 3)
    for k in ("coarse_hz", "fine_hz", "net_freq_hz"):
        assert abs(float(got[k]) - float(want[k])) < 1.0
    for k in ("null_quality", "coarse_quality", "time_quality"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-3 * abs(float(want[k]))


@pytest.mark.parametrize("fmt", ["u8", "s8", "s16", "f32"])
def test_load_iq_equals_tpudab(fmt, tmp_path):
    rng = np.random.default_rng(9)
    dtype = {"u8": np.uint8, "s8": np.int8, "s16": np.int16, "f32": np.float32}[fmt]
    raw = (rng.standard_normal(4000).astype(np.float32) if fmt == "f32" else
           rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, 4000, dtype=dtype))
    raw.tofile(tmp_path / "x")
    got, want = _load_iq(str(tmp_path / "x"), fmt), jax_load_iq(str(tmp_path / "x"), fmt)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("cmd", ["decode", "info"])
def test_refuses_missing_gpu(cmd, capture, monkeypatch):
    """The default device is the card: with none, an error, not a quiet
    run on the CPU."""
    path, _, _ = capture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([cmd, str(path)])

"""The port's terminal UI (host/dashboard.py, host/termimage.py,
host/controls.py) and profiling helpers against tpudab's.

One capture (a DAB+ service whose AUs carry PAD with a dynamic label and a
slide, and a UEP MP2-type service, 24 frames of soft bits) is decoded by
each package's Receiver; the two status screens are equal line for line,
the per-stage timer line excepted (it prints wall times). Tolerance: none.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import tpudab.host.controls as j_controls
import tpudab.host.dashboard as j_dash
import tpudab.host.streaming as j_stream
import tpudab.host.termimage as j_img
import tpudab_torch.host.controls as p_controls
import tpudab_torch.host.dashboard as p_dash
import tpudab_torch.host.streaming as p_stream
import tpudab_torch.host.termimage as p_img
from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.audio.pipeline import AudioPipeline as JaxAudio
from tpudab.host.config import ConfigManager as JaxConfig
from tpudab.host.profiling import StageTimer as JaxTimer
from tpudab.host.streaming import StreamingStats as JaxStats
from tpudab.models.receiver import Receiver as JaxReceiver
from tpudab.synth import (ASCTY_DAB, ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                          ServiceSpec, SubchannelSpec)
from tpudab_torch.audio.pipeline import AudioPipeline
from tpudab_torch.constants.channels import channel_labels
from tpudab_torch.host.config import ConfigManager
from tpudab_torch.host.profiling import StageTimer, trace
from tpudab_torch.host.streaming import StreamingStats
from tpudab_torch.models.receiver import Receiver
from tpudab_torch.mot.imagemeta import TINY_PNG
from tpudab_torch.synth.payload import dabplus_stream

N_FRAMES = 24


@pytest.fixture(scope="module")
def receivers():
    spec = EnsembleSpec(0xCE15, "UI Mux", [
        ServiceSpec(0xC221, "Tone Radio", [(0, ASCTY_DAB, 1)], programme_type=10),
        ServiceSpec(0xC222, "Chirp DAB+", [(0, ASCTY_DAB_PLUS, 2)], programme_type=12)],
        [SubchannelSpec(1, start_cu=0, size_cu=96, protection=("uep", 128, 3)),
         SubchannelSpec(2, start_cu=96, size_cu=36, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=1)
    stream, _ = dabplus_stream(48, N_FRAMES * 4 + 20, seed=3, with_pad=True)
    mp2 = np.random.default_rng(4).integers(0, 256, (N_FRAMES * 4 + 20, 384)).astype(np.uint8)
    synth.payload_fn[1] = lambda m: mp2[m].tobytes()
    synth.payload_fn[2] = lambda m: stream[m].tobytes()
    bits = np.stack([synth.frame_bits(i) for i in range(N_FRAMES)])
    soft = 1.0 - 2.0 * bits.astype(np.float32)
    out = []
    for rx in (Receiver(1, "cpu"), JaxReceiver(1)):
        for lo in range(0, N_FRAMES, 8):
            rx.process_frame_bits(soft[lo: lo + 8])
        out.append(rx)
    assert out[0].channels[2].dynamic_label and out[0].channels[2].slideshow.slides
    return out


def screen_inputs(stats_cls, timer_cls, audio_cls):
    rng = np.random.default_rng(9)
    stats = stats_cls(state="READING_SYMBOLS", total_frames=24, reacquisitions=1,
                      net_freq_hz=3401.25, fine_freq_hz=401.25, coarse_freq_hz=3000.0,
                      timing_adjustments=2, signal_power=0.98, snr_db=21.5,
                      const_re=rng.standard_normal(480).astype(np.float32),
                      const_im=rng.standard_normal(480).astype(np.float32))
    timers = timer_cls()
    for name in ("read", "demod", "decode", "track"):
        with timers.stage(name, items=4):
            pass
    # the stages line orders the stages by wall time, which empty stages
    # leave to chance: give both timers the same totals, read slowest
    for k, name in enumerate(("read", "demod", "decode", "track")):
        timers.totals[name] = 0.004 * (4 - k)
    audio = audio_cls(48000)
    audio.add_source(2)
    audio.global_gain = 1.25
    return stats, timers, audio


def screens(receivers, monkeypatch, show_slides: bool):
    monkeypatch.setenv("TPUDAB_TERMIMG", "half")
    out = []
    for rx, dash, ctl, cls in zip(receivers, (p_dash, j_dash), (p_controls, j_controls),
                                  ((StreamingStats, StageTimer, AudioPipeline),
                                   (JaxStats, JaxTimer, JaxAudio))):
        stats, timers, audio = screen_inputs(*cls)
        controls = ctl.KeyController(rx, audio, read_key=lambda: None)
        controls.show_slides = show_slides
        sink = io.StringIO()
        dash.Dashboard(rx, stats, audio, out=sink, controls=controls,
                       timers=timers).update(force=True)
        text = sink.getvalue()
        assert text == "\x1b[2J\x1b[H" + dash.render_text(
            rx, stats, audio, controls=controls, timers=timers) + "\n"
        out.append(text.splitlines())
    return out


@pytest.mark.parametrize("show_slides", [False, True], ids=["text", "slides"])
def test_render_text_equals_tpudab(receivers, monkeypatch, show_slides):
    got, want = screens(receivers, monkeypatch, show_slides)
    stages = [k for k, ln in enumerate(want) if ln.startswith(" stages: ")]
    assert len(stages) == 1 and len(got) == len(want)
    assert [ln for k, ln in enumerate(got) if k not in stages] == \
        [ln for k, ln in enumerate(want) if k not in stages]
    assert got[stages[0]].split("=")[0] == want[stages[0]].split("=")[0]
    text = "\n".join(got)
    assert "UI Mux" in text and "Chirp DAB+" in text and "tpudab demo" in text
    assert ("slide: " in text) == show_slides


def test_constellation_equal():
    rng = np.random.default_rng(2)
    for n, sigma in ((480, 0.1), (480, 0.5), (5, 0.1), (0, 0.1)):
        sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
        z = sym + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
        assert p_dash.constellation_snr_db(re, im) == j_dash.constellation_snr_db(re, im)
        assert p_dash.render_constellation(re, im) == j_dash.render_constellation(re, im)


def test_termimage_equal(monkeypatch):
    rgb = p_img.decode_image(TINY_PNG)
    assert rgb is not None and np.array_equal(rgb, j_img.decode_image(TINY_PNG))
    assert p_img.decode_image(b"not an image") is None
    assert p_img.render_halfblock(rgb) == j_img.render_halfblock(rgb)
    assert p_img.render_sixel(rgb) == j_img.render_sixel(rgb)
    assert p_img.render_kitty(TINY_PNG) == j_img.render_kitty(TINY_PNG)
    for env in ({"TPUDAB_TERMIMG": "sixel"}, {"TPUDAB_TERMIMG": "off"},
                {"TPUDAB_TERMIMG": "", "TERM": "xterm-kitty"},
                {"TPUDAB_TERMIMG": "", "TERM": "xterm-256color", "KITTY_WINDOW_ID": ""}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert p_img.detect_mode() == j_img.detect_mode()
        assert p_img.render_slide(TINY_PNG) == j_img.render_slide(TINY_PNG)


class FakeRadio:
    def __init__(self, tuner):
        self.tuner = tuner
        self.channel = "12C"
        self.requested = []
        self.desync_threshold = 0.35
        self.fine_freq_beta = 0.9
        self.is_coarse_freq_correction = True

    def retune(self, ch):
        self.requested.append(ch)
        self.channel = ch


KEYS = list("p\tdxm++-c[[]fFFi") + ["\t", "9", "p", "<", ">", ">", "a", "s", "q"]


def test_key_controller_equals_tpudab(receivers, tmp_path):
    """Every key, on each package's receiver, audio, a fake radio with a
    tuner and a ConfigManager: the same channel flags, gains, tunables,
    retunes, status line and autosaved JSON."""
    states = []
    for rx, ctl, audio_cls, cfg_cls, name in (
            (receivers[0], p_controls, AudioPipeline, ConfigManager, "port.json"),
            (receivers[1], j_controls, JaxAudio, JaxConfig, "tpudab.json")):
        radio, audio = FakeRadio(tuner=object()), audio_cls()
        keys = list(KEYS)
        kc = ctl.KeyController(rx, audio, read_key=lambda: keys.pop(0) if keys else None,
                               radio=radio, config_manager=cfg_cls(str(tmp_path / name)))
        lines = []
        while keys:
            keys, rest = keys[:3], keys[3:]
            alive = kc.poll()
            lines.append((alive, kc.status_line()))
            keys = rest
        flags = {cid: (ch.is_play_audio, ch.is_decode_audio, ch.is_decode_data)
                 for cid, ch in rx.channels.items()}
        states.append((lines, flags, radio.requested, vars(radio).copy(), audio.muted,
                       audio.global_gain, kc.show_slides, kc.quit,
                       json.loads((tmp_path / name).read_text())))
        rx.run_all()
    states[0][3].pop("tuner")
    states[1][3].pop("tuner")
    assert states[0] == states[1]
    assert states[0][2] == [channel_labels()[channel_labels().index("12C") + k] for k in (-1, 0, 1)]
    assert states[0][7] is True


def test_key_controller_without_tty_is_a_no_op(receivers, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("q"))
    kc = p_controls.KeyController(receivers[0], AudioPipeline())
    assert kc.read_key is None and kc.poll() and not kc.quit
    kc.close()


def test_stage_timer_and_trace(tmp_path, monkeypatch):
    """StageTimer's summary and report keep tpudab's form; trace() writes a
    Chrome trace of the CPU's activity, and refuses a missing card."""
    p, j = StageTimer(), JaxTimer()
    for t in (p, j):
        for name, items, secs in (("read", 0, 0.5), ("step", 786432, 0.25), ("step", 786432, 0.5)):
            with t.stage(name, items):
                pass
            t.totals[name] += secs
    for t in (p, j):
        for e in t.totals:
            t.totals[e] = round(t.totals[e], 2)
    assert p.summary() == j.summary() and p.report() == j.report()
    with trace(str(tmp_path / "tr"), device="cpu"):
        torch.ones(64).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path / "tr2")):
            pass


def test_streaming_stats_fields_equal():
    assert [f.name for f in dataclasses.fields(StreamingStats)] == \
        [f.name for f in dataclasses.fields(JaxStats)]
    assert dataclasses.asdict(StreamingStats()) == dataclasses.asdict(JaxStats())
    assert p_stream._TCP_INFLIGHT_SAMPLES == j_stream._TCP_INFLIGHT_SAMPLES

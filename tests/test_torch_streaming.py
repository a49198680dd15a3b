"""The port's StreamingRadio (tpudab_torch.host.streaming, device="cpu")
against tpudab's (tpudab.host.streaming) on the same captures, fed through
the same array source: the live loop's state machine (acquire, read
symbols, reacquire) and its tracking (fine-frequency EMA, coarse check and
triage, timing recheck, drift servo, retune).

Tolerances: the decoded subchannel frames byte-equal, batch by batch, and
the FIB CRC errors of each batch equal; the stats equal (total_frames,
total_frames_desync, reacquisitions, timing_adjustments,
coarse_adjustments, the final state); net_freq_hz within 1 Hz (the taps
sum in other orders: tpudab's FFTs are matmuls, the port's torch.fft);
the drift servo's ppm and the resampler's presence equal (they integrate
integer timing adjustments). Where the lock breaks on purpose, frames
decoded from noise (no row of the payload) may differ: their Viterbi
decisions follow the rounding of the soft bits (ROADMAP.md, Queue 3). The
captures are small (24- and 36-CU subchannels, at most 18 mode-I frames).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_live_source import _array_source, _capture
from test_modes import _payload_capture
from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.dab_params import get_dab_params
from tpudab.host.streaming import StreamingRadio as JaxRadio
from tpudab.synth.modulator import Impairments, apply_impairments
from tpudab_torch.host.streaming import StreamingRadio, StreamingStats

COUNTS = ("total_frames", "total_frames_desync", "reacquisitions", "timing_adjustments",
          "coarse_adjustments", "state")


def run(radio_cls, iq, on_batch=None, **kw):
    """Run a radio over iq; returns (radio, [(the batch's decoded frames, its
    FIB CRC errors)], labels seen)."""
    if radio_cls is StreamingRadio:
        kw["device"] = "cpu"
    radio = radio_cls(_array_source(iq), **kw)
    batches, labels, seen = [], [], {"errs": 0, "rx": None}

    def on_outputs(outputs):
        labels.append(radio.receiver.db.ensemble.label)
        if seen["rx"] is not radio.receiver.stats:     # a retune resets the receiver
            seen["rx"], seen["errs"] = radio.receiver.stats, 0
        errs = radio.receiver.stats["fib_crc_errors"] - seen["errs"]
        seen["errs"] += errs
        frames = [np.asarray(o.raw_frames) for o in outputs.values()
                  if o.raw_frames is not None and len(o.raw_frames)]
        batches.append((np.concatenate(frames) if frames else None, errs))
        if on_batch is not None:
            on_batch(radio)

    radio.run(on_outputs=on_outputs)
    return radio, batches, labels


def decoded(batches) -> np.ndarray:
    return np.concatenate([f for f, _ in batches if f is not None])


def assert_same(port, jax_run, payload=None):
    """Equal batches, labels and stats, and byte-equal decoded frames. With
    `payload` (a capture whose lock breaks): a frame decoded from noise
    (one that is no row of the payload) follows the rounding of its soft
    bits in its Viterbi decisions, so only the frames that either radio
    decodes to a payload row must be equal, and the other radio's in the
    same place; every batch holds as many frames."""
    (p, pb, pl), (j, jb, jl) = port, jax_run
    assert [e for _, e in pb] == [e for _, e in jb]
    assert [None if f is None else f.shape for f, _ in pb] == \
        [None if f is None else f.shape for f, _ in jb]
    pf, jf = decoded(pb), decoded(jb)
    if payload is None:
        assert np.array_equal(pf, jf)
    else:
        rows = {r.tobytes() for r in payload}
        real = [k for k in range(len(pf)) if pf[k].tobytes() in rows or jf[k].tobytes() in rows]
        assert np.array_equal(pf[real], jf[real]) and len(real) >= 8
    assert pl == jl
    for k in COUNTS:
        assert getattr(p.stats, k) == getattr(j.stats, k), (k, p.stats, j.stats)
    assert abs(p.stats.net_freq_hz - j.stats.net_freq_hz) < 1.0
    assert p._drift_ppm == j._drift_ppm
    assert (p._resampler is None) == (j._resampler is None)
    assert p.receiver.stats == j.receiver.stats
    assert set(p.timers.summary()) == set(j.timers.summary())


@pytest.fixture(scope="module")
def impaired():
    """The 24-CU DAB+ capture of tests/test_live_source.py (10 frames), with
    CFO 3,400 Hz (three carriers and 400 Hz), 777 samples of delay, 18 dB."""
    iq, payload = _capture(10)
    iq = apply_impairments(iq, Impairments(freq_offset_hz=3400.0, delay_samples=777,
                                           snr_db=18, seed=7))
    return iq, payload


@pytest.mark.parametrize("device_step", [False, True], ids=["host", "step"])
def test_stream_equals_tpudab(impaired, device_step):
    iq, payload = impaired
    port = run(StreamingRadio, iq, batch_frames=4, use_device_step=device_step)
    want = run(JaxRadio, iq, batch_frames=4, use_device_step=device_step)
    assert_same(port, want)
    radio, frames = port[0], decoded(port[1])
    assert all(e == 0 for _, e in port[1])
    assert (radio._driver.step is not None) == device_step
    assert frames.shape[0] >= 10 * 4 - 18
    np.testing.assert_array_equal(frames[1:], payload[1: frames.shape[0]])
    assert radio.receiver.stats["fib_crc_errors"] == 0
    assert abs(radio.stats.net_freq_hz - 3400.0) < 20.0
    assert radio.stats.const_re.shape == (480,) and radio.stats.snr_db > 10
    assert ("step" if device_step else "decode") in radio.timers.summary()


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_stream_modes_host_path(mode):
    """Modes II-IV under tests/test_modes.py's streaming impairments (CFO
    700 Hz, 20 dB, 400 samples of delay)."""
    n_frames = -(-24 // get_dab_params(mode).nb_cifs)
    frames, data = _payload_capture(mode, n_frames, seed=50 + mode)
    iq = apply_impairments(frames.reshape(-1), Impairments(
        freq_offset_hz=700.0, snr_db=20, delay_samples=400, seed=mode))
    port = run(StreamingRadio, iq, mode=mode, batch_frames=4, use_device_step=False)
    assert_same(port, run(JaxRadio, iq, mode=mode, batch_frames=4, use_device_step=False))
    radio = port[0]
    assert all(e == 0 for _, e in port[1])
    assert radio.receiver.db.ensemble.label == f"Mode {mode} Mux"
    assert radio.receiver.stats["fib_crc_errors"] == 0


def test_stream_clock_drift_engages_resampler():
    """+100 ppm sample clock, batches of 2: the timing recheck's +32 jumps
    train the drift servo, which switches the fractional resampler on."""
    iq, payload = _capture(8, seed=7)
    iq = apply_impairments(iq, Impairments(freq_offset_hz=800.0, snr_db=22, clock_ppm=100.0,
                                           seed=3))
    port = run(StreamingRadio, iq, batch_frames=2)
    assert_same(port, run(JaxRadio, iq, batch_frames=2))
    radio, frames = port[0], decoded(port[1])
    assert radio._resampler is not None and radio.stats.timing_adjustments >= 1
    assert radio._resampler.ratio == 1.0 + radio._drift_ppm * 1e-6
    np.testing.assert_array_equal(frames[1:], payload[1: frames.shape[0]])


def desync_capture(n_frames: int, seed: int, impair):
    iq, payload = _capture(n_frames, seed=seed)
    iq = apply_impairments(iq, Impairments(freq_offset_hz=500.0, snr_db=24, seed=6))
    return impair(iq), payload


def carrier_slip(iq):
    """+1 carrier (1 kHz) from frame 3 on."""
    lo = 3 * 196608
    n = np.arange(iq.shape[0] - lo, dtype=np.float64)
    iq[lo:] *= np.exp(1j * 2 * np.pi * 1000.0 * n / 2.048e6).astype(np.complex64)
    return iq


def broken_timing(iq):
    """1,300 samples dropped in frame 3."""
    cut = 3 * 196608 + 999
    return np.concatenate([iq[:cut], iq[cut + 1300:]])


@pytest.mark.parametrize("impair,n_frames", [(carrier_slip, 12), (broken_timing, 14)],
                         ids=["carrier_slip", "broken_timing"])
def test_stream_desync_paths(impair, n_frames):
    """The desync paths, batches of 2: a +1-carrier step mid-stream kills
    every FIB of a batch and the coarse triage repairs it in place; a
    timing break raises the graded FIB-error EMA and the loop reacquires.
    Decoding resumes in both."""
    iq, payload = desync_capture(n_frames, 12, impair)
    port = run(StreamingRadio, iq, batch_frames=2)
    assert_same(port, run(JaxRadio, iq, batch_frames=2), payload)
    radio, batches = port[0], port[1]
    assert any(e > 0 for _, e in batches) and batches[-1][1] == 0
    if impair is carrier_slip:
        assert radio.stats.coarse_adjustments >= 1 and radio.stats.reacquisitions == 0
    else:
        assert radio.stats.reacquisitions >= 1


class FakeTuner:
    def __init__(self):
        self.freqs = []

    def set_freq(self, hz):
        self.freqs.append(hz)


def test_stream_retune_resets_stats_in_place():
    """A retune from the loop's callback: the tuner is commanded, the old
    channel's samples drained, the receiver, step and stats reset (the
    stats object in place, as the dashboard holds it), then the next
    ensemble is acquired and decoded."""
    iq_c, _ = _capture(6, label="Mux Charlie", eid=0xC12C, seed=5)
    iq_d, _ = _capture(12, label="Mux Delta", eid=0xD12D, seed=6)
    iq = np.concatenate([iq_c, iq_d])
    results = []
    for cls in (StreamingRadio, JaxRadio):
        tuner, seen = FakeTuner(), {}

        def on_batch(radio):
            if radio.receiver.db.ensemble.label == "Mux Charlie" and not seen:
                seen["stats"] = radio.stats
                radio.retune("12D")

        radio, batches, labels = run(cls, iq, on_batch, batch_frames=2, tuner=tuner,
                                     channel="12C", drift_resample=False)
        assert radio.stats is seen["stats"]
        results.append(((radio, batches, labels), tuner.freqs))
    (port, port_freqs), (want, want_freqs) = results
    assert_same(port, want)
    radio, _, labels = port
    assert port_freqs == want_freqs == [223.936e6 + 1.712e6 * 3]
    assert radio.channel == "12D" and radio.receiver.db.ensemble.ensemble_id == 0xD12D
    assert "Mux Charlie" in labels and labels[-1] == "Mux Delta"
    assert radio.stats.total_frames < 18   # counted from the retune on


def test_device_default(monkeypatch):
    """use_device_step defaults to the device: off on the CPU; the default
    device is the card, and without one the radio refuses to start."""
    iq, _ = _capture(3)
    radio = StreamingRadio(_array_source(iq), device="cpu")
    assert radio.use_device_step is False and radio.device == torch.device("cpu")
    assert dataclasses.asdict(radio.stats) == dataclasses.asdict(StreamingStats())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingRadio(_array_source(iq), **kw)

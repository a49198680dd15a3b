"""A tracked stream on the receive step (ofdm/track.py): free-running
rtl_sdr dongles whose crystal error moves both the carrier and the sample
clock. The tracked step against the plain float64 reference
(ofdm/track_ref.py), the tracker's convergence from acquisition, the lock
flag, HostFeed's copies from rings at read pointers, and the aligned
callers as they were. The streams are the benchmark's
(benchmark/drivers/driftfed.py: resampled exactly onto each dongle's
clock). CPU only, the plain twins in place of the kernels; this file
imports no jax."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.signal import RAMP_CIFS, step_truth  # noqa: E402
from benchmark.synth.dab_params import get_dab_params  # noqa: E402
from tpudab_torch.constants.ofdm_params import get_ofdm_params  # noqa: E402
from tpudab_torch.models import demod_graph  # noqa: E402
from tpudab_torch.models.ingest import HostFeed  # noqa: E402
from tpudab_torch.models.step import ReceiveStep  # noqa: E402
from tpudab_torch.ofdm import demod, track_ref  # noqa: E402
from tpudab_torch.ofdm.track import HEAD, LOCK_QUALITY, Tracker  # noqa: E402
from tpudab_torch.tools.bench import bench_subchannels  # noqa: E402

T = get_ofdm_params(1).nb_frame_length
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def cell(e: int, f: int):
    c = harness.load_cell("rtl6free.drift32x16")
    c.traffic.update({"n_ensembles": e, "n_frames": f, "distinct": min(e, 3)})
    return c, harness.driver_module(c)


def m_of(ppm, f: int) -> np.ndarray:
    """Each dongle's clock excess a period, whole samples, toward 0 from ppm."""
    return np.trunc(np.asarray(ppm) * 1e-6 * f * T).astype(np.int64)


class Stream:
    """The benchmark's streams for E dongles and a tracker's segments read
    from them at read pointers that follow the tracker's counts, one step
    ahead as a feed reads them."""

    def __init__(self, e, f, ppm, seed=SEED):
        self.cell, self.drv = cell(e, f)
        self.seg_len = f * T + 1024
        self.s = self.drv.drift_streams(self.cell.config, self.cell.traffic, seed, CPU,
                                        self.seg_len, m=m_of(ppm, f))
        self.s.truth.phase = "check"
        self.truth = self.s.truth.open()
        self.period = self.truth["period"]
        self.ptr = (self.period - self.s.lead) % self.period

    def segments(self, ptr=None):
        ptr = self.ptr if ptr is None else ptr
        return torch.stack([r[int(p):int(p) + self.seg_len] for r, p in zip(self.s.rings, ptr)])

    def lock(self, track: Tracker):
        """Set-up: acquisition, the pointers to frame 0, the first state;
        the pointers then follow the counts (Pointers)."""
        acq = track.acquire(self.segments())
        self.ptr = (self.ptr + acq["advance"].numpy()) % self.period
        state = track.train(self.segments(), acq)
        self.pointers = self.drv.Pointers(self.ptr, self.period)
        self.pointers.report(state["c_prev"].numpy())
        return state

    def timing_gap(self, ptr, rs):
        """The next frame 0 against the period's (truth: 0 mod period)."""
        x = (ptr + rs.numpy() + self.period / 2) % self.period - self.period / 2
        return np.abs(x)


def test_tracked_step_matches_track_ref():
    """E = 3 dongles at -24, 0, +24 ppm (whole samples a period at F = 4),
    4 steps of the tracked ReceiveStep against track_ref from the same
    state: the frame starts and the consumed counts equal, the next state's
    rate within 1e-9, rs within 1e-6 samples, the CFO within 0.05 Hz; the
    mean powers within 1e-6 and the tap within 0.02 RMS of the reference;
    every due byte of the FIC and of subchannel 1 (the step decodes that
    one alone: the plain Viterbi is the CPU's cost) equal to the bytes
    sent."""
    e, f = 3, 4
    st = Stream(e, f, [-25.0, 0.0, 25.0])
    step = ReceiveStep(1, bench_subchannels()[:1], n_ensembles=e, track_frames=f)
    state = st.lock(step.track)
    sig = st.s.sig
    dab = get_dab_params(1)
    c = f * dab.nb_cifs
    want = {1: step_truth(sig, e, c, 0)[1]}
    carry = {**step.init_carry(CPU), "track": state}
    total = np.zeros(e, dtype=np.int64)
    for k in range(4):
        ptr = st.pointers.take()
        seg = st.segments(ptr)
        ref = track_ref.track_step(seg, carry["track"], f)
        carry, out = step(carry, seg, None, None)
        got = carry["track"]
        assert torch.equal(step.track.starts.view(e, f) - torch.arange(e)[:, None] * st.seg_len,
                           ref["starts"])
        assert torch.equal(out["consumed"], ref["consumed"])
        assert torch.equal(got["c_prev"], ref["state"]["c_prev"]) and bool(out["locked"].all())
        assert torch.allclose(got["rate"], ref["state"]["rate"], atol=1e-9, rtol=0)
        assert torch.allclose(got["rs"], ref["state"]["rs"], atol=1e-6, rtol=0)
        assert torch.allclose(got["coarse_hz"] + got["fine_hz"],
                              ref["state"]["coarse_hz"] + ref["state"]["fine_hz"], atol=0.05,
                              rtol=0)
        mp = out["mean_power"].double().view(e, f)
        assert ((mp - ref["mean_power"]).abs() / ref["mean_power"]).max() < 1e-6
        tap = torch.stack([out["const_re"], out["const_im"]]).double()
        assert ((tap - ref["tap"]) ** 2).sum(dim=0).mean().sqrt() < 0.02
        lo = max(0, RAMP_CIFS - k * c)
        fic = sig.fibs.reshape(3, f * dab.nb_fib_groups, -1)[np.arange(e) % 3]
        assert np.array_equal(out["fic_bytes"].numpy().reshape(fic.shape), fic)
        assert out["subch"].keys() == want.keys()
        for sid, t in want.items():
            assert np.array_equal(out["subch"][sid].numpy()[:, lo:], t[:, lo:]), (k, sid)
        st.pointers.report(out["consumed"].numpy())
        total += out["consumed"].numpy()
    assert np.array_equal(total, 4 * st.period)


def test_tracker_converges_from_acquisition():
    """Two dongles at +-24 ppm, the cell's 16 frames a step: acquisition
    and training alone leave the rate within 0.5 ppm; ten tracked steps
    bring it within 0.2 ppm, every next frame 0 within half a sample of
    the period's, and the counts sum to the steps' periods exactly."""
    e, f = 2, 16
    st = Stream(e, f, [25.0, -25.0])
    track = Tracker(1, e, f)
    state = st.lock(track)
    ppm = st.truth["ppm"]
    assert np.abs((state["rate"].numpy() - 1) * 1e6 - ppm).max() < 0.5
    total = np.zeros(e, dtype=np.int64)
    for _ in range(10):
        ptr = st.pointers.take()
        track.cut(state)
        state, consumed = track.update(st.segments(ptr), state)
        st.pointers.report(consumed.numpy())
        total += consumed.numpy()
        assert bool(state["locked"].all())
        assert st.timing_gap(st.pointers.next(), state["rs"]).max() < 0.5
    assert np.abs((state["rate"].numpy() - 1) * 1e6 - ppm).max() < 0.2
    assert np.array_equal(total, 10 * st.period)
    n = track.counters()
    assert n["calls"] == 10 and n["frames"] == 10 * e * f and n["lock_lost"] == 0
    assert n["consumed"] == int(total.sum())


@pytest.mark.parametrize("plant_hz", [300.0, 1300.0])
def test_tracker_takes_out_a_planted_cfo_error(plant_hz):
    """A CFO error planted in the state after set-up, 0.3 of a carrier, or
    one carrier and 0.3 of one: the fine EMA, the whole-carrier check and
    the fold take it out, every ensemble in lock, within 5 Hz after three
    steps and within 2 Hz after five, where the state it started from
    reads the plant."""
    e, f = 2, 16
    st = Stream(e, f, [20.0, -20.0])
    track = Tracker(1, e, f)
    state = st.lock(track)
    state = {**state, "fine_hz": state["fine_hz"] + plant_hz}
    held = state["coarse_hz"] + state["fine_hz"]
    cfo = st.truth["cfo_hz"]
    for k in range(5):
        track.cut(state)
        state, consumed = track.update(st.segments(st.pointers.take()), state)
        st.pointers.report(consumed.numpy())
        assert bool(state["locked"].all())
        gap = np.abs((state["coarse_hz"] + state["fine_hz"]).numpy() - cfo).max()
        if k == 2:
            assert gap < 5.0
    assert gap < 2.0
    assert np.abs(held.numpy() - cfo).min() > plant_hz - 5.0


def test_lock_loss_is_flagged_and_held():
    """A dongle whose segment turns to noise reads a PRS quality below
    LOCK_QUALITY: it is flagged (locked False, lock_lost counted) and held
    (its state moves by its prediction alone); the other two go on
    tracked."""
    e, f = 3, 4
    st = Stream(e, f, [10.0, -10.0, 20.0])
    track = Tracker(1, e, f)
    state = st.lock(track)
    seg = st.segments(st.pointers.take())
    seg[1] = torch.randint(0, 256, seg[1].shape, dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    track.cut(state)
    held = track.hold(state)
    new, consumed = track.update(seg, state)
    assert new["locked"].tolist() == [True, False, True]
    assert float(new["quality"][1]) < LOCK_QUALITY <= float(new["quality"][[0, 2]].min())
    for key in ("rs", "rate", "coarse_hz", "fine_hz", "c_prev"):
        assert torch.equal(new[key][1], held[key][1]), key
    assert int(consumed[1]) == int(held["c_prev"][1])
    assert track.counters()["lock_lost"] == 1


def test_step_refuses_a_cfo_and_frames_in_a_tracked_stream():
    """The tracked step takes neither a CFO nor frames beside the
    segments: the tracker's state is all it has."""
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=2, track_frames=2)
    seg = torch.zeros((2, step.track.segment_len, 2), dtype=torch.uint8)
    carry = step.init_carry(CPU)
    with pytest.raises(ValueError, match="tracker"):
        step(carry, seg, None, torch.zeros(2))
    with pytest.raises(ValueError, match="tracker"):
        step(carry, seg, seg, None)
    with pytest.raises(ValueError, match="segments"):
        step.demod_stream(carry, seg[:, :-8])


def test_hostfeed_copies_rows_from_rings_at_offsets():
    """feed(rings, offsets) copies row e of the buffer from ring e at pair
    offsets[e], counts the row's bytes, and refuses an offset that leaves
    the ring; a feed without offsets copies the regions whole as before."""
    e, seg = 3, 40
    g = torch.Generator().manual_seed(5)
    rings = [torch.randint(0, 256, (n, 2), dtype=torch.uint8, generator=g) for n in (50, 77, 40)]
    feed = HostFeed((e, seg, 2), CPU)
    feed.feed(rings, [10, 37, 0])
    got = feed.take()
    for row, ring, off in zip(got, rings, (10, 37, 0)):
        assert torch.equal(row, ring[off:off + seg])
    feed.release()
    assert feed.bytes_copied == e * seg * 2
    with pytest.raises(ValueError):
        feed.feed(rings, [11, 0, 0])
    with pytest.raises(ValueError):
        feed.feed(rings, [0, 0, 1])
    whole = [r[:seg].contiguous() for r in rings]
    feed.feed(whole)
    assert all(torch.equal(row, w) for row, w in zip(feed.take(), whole))
    feed.release()


def test_aligned_paths_unchanged():
    """The frames at starts are the aligned frames where the starts are
    f x frame_len: demod_frames_split gives the same soft bits, mean power
    and tap either way; an aligned step has no tracker and no tracker's
    outputs; a tracked segment buffer and an aligned frames buffer never
    share a demod graph key."""
    f = 3
    g = torch.Generator().manual_seed(9)
    u8 = torch.randint(0, 256, (f, T, 2), dtype=torch.uint8, generator=g)
    ops = demod.dft_operands(1)
    freq = torch.tensor([120.0, -3400.0, 999.0])
    soft_a, stats_a = demod.demod_frames_split(u8, None, freq, ops, out_dtype=torch.bfloat16)
    starts = torch.arange(f, dtype=torch.int64) * T
    soft_s, stats_s = demod.demod_frames_split(u8.reshape(1, f * T, 2), None, freq, ops,
                                               out_dtype=torch.bfloat16, starts=starts)
    assert torch.equal(soft_a, soft_s)
    assert all(torch.equal(stats_a[k], stats_s[k]) for k in stats_a)
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=2)
    assert step.track is None
    _, out = step(step.init_carry(CPU), u8[None, :2].expand(2, 2, T, 2).contiguous(), None,
                  torch.zeros(2))
    assert "consumed" not in out and "locked" not in out
    aligned = HostFeed((2, 2, T, 2), CPU).buffers[0]
    tracked = HostFeed((2, 2 * T + 1024, 2), CPU).buffers[0]
    assert demod_graph.frames_key(aligned, None) != demod_graph.frames_key(tracked, None)
    assert demod_graph.frames_key(aligned, None)[0][1:] == ((2, 2, T, 2), (4 * T, 2 * T, 2, 1),
                                                            torch.uint8)


def test_train_puts_frame0_at_head():
    """Acquisition moves each read pointer to frame 0 less HEAD; training
    then finds frame 0 within a sample of HEAD."""
    st = Stream(2, 4, [5.0, -20.0])
    track = Tracker(1, 2, 4)
    state = st.lock(track)
    assert np.abs(state["rs"].numpy() - HEAD).max() <= 1.0
    assert st.timing_gap(st.ptr, state["rs"]).max() < 0.5

"""The free-running rtl_sdr cell (benchmark/drivers/driftfed.py): it
resolves, its streams are what the configuration says (each period N + m
samples, the CFO whole cycles a period, the truth sealed), the cell runs
end to end at a tiny size on the CPU (the plain torch twins in place of
the kernels) with every check within its limit, and `correct` comes out
false for the frozen-tracker control, for a feed that skips a sample, for
a step handed the true CFO while its tracker is held and for a CFO error
planted and held; the tracker span's reader sums the kernels launched
inside the span."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness

CELL = "rtl6free.drift32x16"
SEED = 2 ** 31 + 43
T = 196_608


def tiny_cell(e: int = 3, f: int = 4) -> harness.Cell:
    cell = harness.load_cell(CELL)
    cell.traffic.update({"n_ensembles": e, "n_frames": f, "distinct": min(e, 3)})
    return cell


def run_tiny(cell, control=None):
    return harness.driver_module(cell).run(cell, SEED, 0.0, False, "cpu", 0.0, control=control)


def test_cell_resolves():
    cell = harness.load_cell(CELL)
    assert cell.driver == "driftfed" and cell.chips == 1
    assert cell.config["name"] == "rtl6free" and cell.config["reduced"] == []
    fe = cell.config["front_end"]
    assert fe["format"] == "u8" and fe["offset"] == 127.5 and fe["clock_ppm_max"] == 25.0
    assert len(fe["blocks"]) == len(fe["block_mhz"]) == 32
    assert CELL in cell.config["deployment"]
    assert {m["name"] for m in cell.end_to_end} == {"rtf_per_gpu", "step_ms_p95", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"span.demod.track_ms", "span.ingest_ms", "ingest_overlap", "carve_u8_roofline",
            "stats_u8_roofline", "viterbi_roofline", "h2d_link_share"} <= names
    assert not names & {"carve_roofline", "idle_share.step", "ddc_roofline",
                        "span.demod.ddc_ms"}
    assert set(cell.limits) == {"bytes_wrong", "bytes_copied_gap", "consumed_gap",
                                "timing_gap_samples", "ppm_gap", "freq_gap_hz", "lock_lost",
                                "mean_power_gap", "const_rms_gap"}


def test_streams_follow_the_configuration():
    """Each dongle's period is N + m whole samples within clock_ppm_max,
    its ring repeats the period past its end, its CFO is -ppm x its
    block's centre to one cycle a period, and the truth stays sealed
    until the check phase."""
    cell = tiny_cell(4, 4)
    drv = harness.driver_module(cell)
    n, seg = 4 * T, 4 * T + 1024
    s = drv.drift_streams(cell.config, cell.traffic, SEED, "cpu", seg)
    with pytest.raises(RuntimeError):
        s.truth.open()
    s.truth.phase = "window"
    with pytest.raises(RuntimeError):
        s.truth.open()
    s.truth.phase = "check"
    t = s.truth.open()
    assert np.all(np.abs(t["m"]) <= 25e-6 * n) and np.array_equal(t["period"], n + t["m"])
    assert np.allclose(t["ppm"], t["m"] / n * 1e6)
    centre = np.array(cell.config["front_end"]["block_mhz"])[t["block"]] * 1e6
    cycles = t["cfo_hz"] * t["period"] / 2.048e6
    assert np.allclose(cycles, np.rint(cycles), atol=1e-6)
    assert np.abs(cycles + t["ppm"] * 1e-6 * centre * n / 2.048e6).max() <= 0.5 + 1e-9
    for ring, p in zip(s.rings, t["period"]):
        assert ring.shape == (p + seg, 2) and ring.dtype == torch.uint8
        assert torch.equal(ring[p:], ring[:seg])
    assert len(set(t["block"].tolist())) == 4


def test_pointers_follow_the_counts_one_step_behind():
    """take() gives each step's pointers; the step after next moves by the
    oldest count reported (train's first), modulo each period."""
    cell = tiny_cell()
    drv = harness.driver_module(cell)
    p = drv.Pointers(np.array([5, 990]), np.array([1000, 1000]))
    p.report(np.array([100, 20]))
    assert p.take().tolist() == [5, 990]
    assert p.next().tolist() == [105, 10]
    p.report(np.array([101, 21]))
    assert p.take().tolist() == [105, 10]
    assert p.take().tolist() == [206, 31]


def test_driver_end_to_end_cpu():
    """The tiny cell runs end to end on the CPU: every check within its
    limit, the counts summed to the steps' periods, the tracker's counters
    in the readings."""
    res, checks = run_tiny(tiny_cell())
    assert res["correct"], checks
    assert checks["consumed_gap"][0] == 0 and checks["timing_gap_samples"][0] < 0.5
    assert res["readings"]["track.calls"] == res["attempted"] + 2
    assert res["readings"]["track.lock_lost"] == 0
    assert set(res["metrics"]) == {"rtf_per_gpu", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("control", ["frozen", "true_cfo", "skip"])
def test_controls_are_not_correct(control):
    """The frozen tracker, the tracker held with the true CFO, and a feed
    that skips one sample each fail a check."""
    res, checks = run_tiny(tiny_cell(), control)
    assert not res["correct"]
    assert checks["consumed_gap"][0] > checks["consumed_gap"][1]


def test_cfo_held_control_fails_on_frequency():
    """A CFO error of PLANT_HZ planted after set-up and held there (the
    timing tracked) reads it in freq_gap_hz, past the limit, and its
    bytes are wrong."""
    cell = tiny_cell()
    drv = harness.driver_module(cell)
    res, checks = run_tiny(cell, "cfo_held")
    assert not res["correct"]
    assert abs(checks["freq_gap_hz"][0] - drv.PLANT_HZ) < 5.0
    assert checks["freq_gap_hz"][0] > checks["freq_gap_hz"][1]


def test_track_kernel_ms_sums_the_span_launches(tmp_path):
    """The tracker span's device time: the kernels and copies whose launch
    lies inside a `demod.track` range, matched by correlation id, summed a
    span, the median over the spans; nothing where there is no span."""
    drv = harness.driver_module(tiny_cell())

    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [ev("user_annotation", "demod.track", 0, 100),
              ev("user_annotation", "demod.track", 1000, 100),
              ev("cuda_runtime", "cudaLaunchKernel", 10, 5, 1),
              ev("cuda_driver", "cuLaunchKernel", 50, 5, 2),
              ev("cuda_runtime", "cudaLaunchKernel", 500, 5, 3),     # outside both
              ev("cuda_runtime", "cudaMemcpyAsync", 1010, 5, 4),
              ev("kernel", "k1", 200, 30, 1), ev("kernel", "k2", 240, 50, 2),
              ev("kernel", "k3", 600, 400, 3), ev("gpu_memcpy", "Memcpy DtoD", 1200, 60, 4)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert drv.track_kernel_ms(str(path)) == pytest.approx((0.08 + 0.06) / 2)
    path.write_text(json.dumps({"traceEvents": events[2:]}))
    assert drv.track_kernel_ms(str(path)) is None


def test_span_reader_finds_nothing_off_the_card():
    reader = harness.load_module(harness.BENCH / "metrics" / "span.demod.track_ms.py")
    assert reader.read({"cuda": False, "steps": 20}) is None
    assert reader.read({"cuda": True, "steps": 20, "track_kernel_ms": 0.25}) == 0.25

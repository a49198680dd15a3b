"""The reduction of a profiler trace (benchmark/trace.py) on a trace made
by hand: the window from the step annotations, the union of device
activity, kernel sums and the idle gaps by the innermost host op."""

import json

import pytest

from benchmark import trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.fixture
def path(tmp_path):
    events = [_x("user_annotation", "bench.step", 0, 100), _x("user_annotation", "bench.step", 100, 100),
              _x("cpu_op", "aten::mul", 0, 30), _x("cuda_runtime", "cudaLaunchKernel", 10, 5),
              _x("cpu_op", "copy", 120, 70), _x("cuda_runtime", "cudaMemcpyAsync", 130, 50),
              _x("kernel", "void viterbi_kernel<bf16>(int)", 20, 40),
              _x("kernel", "void carve_kernel<bf16>(int)", 50, 30),      # overlaps the first
              _x("gpu_memcpy", "Memcpy DtoH", 185, 10),
              _x("kernel", "void late_kernel(int)", 190, 50)]            # runs past the window
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def test_summary(path):
    s = trace.summarize(path, "bench.step")
    assert s["window_s"] == pytest.approx(200e-6)
    # device busy: [20, 80] and [185, 200] (clipped to the window)
    assert s["busy_s"] == pytest.approx(75e-6)
    assert s["launches"] == 3 and s["marks"] == 2
    assert trace.kernel_seconds(s, "viterbi_kernel") == (pytest.approx(40e-6), 1)
    gaps = dict(s["idle_gaps"])
    # idle: [0, 20] under aten::mul (and its launch), [80, 185]: none, copy,
    # then cudaMemcpyAsync inside copy
    assert gaps["aten::mul"] == pytest.approx(15e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(5e-6)
    assert gaps["(no host op)"] == pytest.approx(40e-6)
    assert gaps["copy"] == pytest.approx(15e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(125e-6)


def test_no_marks(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(RuntimeError):
        trace.summarize(str(p), "bench.step")


def test_summary_on_the_device_clock(path):
    """Without a marker the window runs from the first device operation to
    the end of the last: [20, 240]."""
    s = trace.summarize(path, None)
    assert s["window_s"] == pytest.approx(220e-6) and s["marks"] == 0
    assert s["busy_s"] == pytest.approx(60e-6 + 55e-6)
    assert s["launches"] == 3


def test_no_device_events(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [_x("cpu_op", "aten::mul", 0, 30)]}))
    assert trace.summarize(str(p), None) is None

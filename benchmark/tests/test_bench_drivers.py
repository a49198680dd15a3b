"""Both drivers end to end at a tiny size on the CPU (the plain torch
twins in place of the kernels), and a run without a card fails."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, run as bench_run
from benchmark.tests.conftest import run_tiny, tiny_cell


def test_step_driver():
    result, checks = run_tiny(tiny_cell("bench6.ens32x16"))
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"rtf_per_gpu", "step_ms_p95", "setup_s"}
    assert checks["bytes_wrong"][0] == 0


def test_step_driver_traced(monkeypatch):
    cell = tiny_cell("bench6.ens32x16")
    drv = harness.driver_module(cell)
    monkeypatch.setattr(drv, "TRACED_STEPS", 1)      # the CPU twins trace slowly
    monkeypatch.setattr(drv, "GAP_STEPS", 1)
    result, _ = drv.run(cell, 5, 0.0, True, "cpu", 0.0)
    # every step checked, the profiled ones after their profiler stopped
    assert result["correct"] and result["steps_checked"] == result["attempted"]
    assert set(result["step_ms_median"]) == {"plain", "device", "host"}
    # no device on the CPU: the device readers find nothing and are left out
    assert result["metrics"] == {} and "busy_s" not in result["device"]
    assert result["breakdown"]["device_ops"] == [] and result["breakdown"]["idle_gaps"]


def test_decode_driver():
    result, checks = run_tiny(tiny_cell("bench6.decode1"))
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"decode_rtf", "setup_s"}
    assert all(v == 0 for v, lim in checks.values() if lim == 0)
    assert checks["net_freq_gap_hz"][0] < 10 and set(result["readings"]) == {"const_rms_gap"}


def test_no_card_is_an_error(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_run.main(["--workload", "bench6.ens32x16", "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "bench6.ens32x16", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    with pytest.raises(ValueError):
        json.loads(out.stdout.strip().splitlines()[-1] if out.stdout.strip() else "")

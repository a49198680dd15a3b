"""The port's weak-scaling sweep (tpudab_torch/tools/bench_scaling.py)
against the repo's bench_scaling.py, on the CPU over gloo.

- a world of one, in this process: the row holds bench_scaling.py's
  RESULT keys (read from its worker's source) and a collective of 0.0;
- summary() equals bench_scaling.py's summary formula (rebuilt here from
  its main) on fixed rows;
- the size-2 world in two subprocesses (one rep, one trial, 180 s): the
  row names gloo, its collective ms is >= 0 and its slowest rank bounds it;
- a world whose workers fail raises, with the ranks' output on stderr.
"""

import ast
import os

import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab_torch.tools import bench_scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def repo_result_keys() -> list:
    """The keys bench_scaling.py's worker puts in its RESULT dict, in order."""
    with open(os.path.join(ROOT, "bench_scaling.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "worker")
    keys = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "out":
            keys += [k.value for k in node.value.keys]
        elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", None) == "out"):
            keys.append(node.targets[0].slice.value)
    return keys


def repo_summary(results, dcn, cores, have_taskset):
    """bench_scaling.py's summary, as its main computes it (:301-323)."""
    base = results[0]["samples_per_s_per_device"]
    honest = [r for r in results if not r["oversubscribed"]] or results[:1]
    eff_h = honest[-1]["samples_per_s_per_device"] / base
    eff_all = results[-1]["samples_per_s_per_device"] / base
    return {
        "metric": "weak_scaling_efficiency",
        "value": round(eff_h, 3),
        "unit": "fraction_of_linear",
        "vs_baseline": round(eff_h / 0.8, 3),
        "host_cores": cores,
        "pinned": have_taskset,
        "efficiency_within_cores": round(eff_h, 3),
        "within_cores_devices": honest[-1]["n_devices"],
        "efficiency_8dev_oversubscribed": round(eff_all, 3),
        "collective_fraction_largest_honest": honest[-1]["collective_fraction"],
        "two_process_gloo": dcn,
        "two_process_gloo_efficiency": (
            round(dcn["samples_per_s_per_device"] / base, 3)
            if "samples_per_s_per_device" in dcn else None),
        "results": results,
    }


def row(n, per_dev, coll_frac, over):
    return {"n_devices": n, "samples_per_s_per_device": per_dev,
            "collective_fraction": coll_frac, "oversubscribed": over}


@pytest.mark.parametrize("rows, dcn", [
    ([row(1, 4.0e6, 0.0, False), row(2, 3.7e6, 0.004, False), row(4, 3.1e6, 0.01, False),
      row(8, 1.9e6, 0.02, True)], {"samples_per_s_per_device": 3.3e6, "step_ms": 400.0}),
    ([row(1, 4.0e6, 0.0, True), row(2, 3.7e6, 0.004, True), row(4, 3.1e6, 0.01, True),
      row(8, 1.9e6, 0.02, True)], {"error": "dcn row timed out"}),
    ([row(1, 5.0e6, 0.0, False), row(2, 5.2e6, 0.001, False), row(4, 4.8e6, 0.002, False),
      row(8, 4.1e6, 0.003, False)], {"samples_per_s_per_device": 5.1e6}),
], ids=["8-oversubscribed", "all-oversubscribed", "none-oversubscribed"])
def test_summary_equals_bench_scaling_py(rows, dcn):
    got = bench_scaling.summary(rows, dcn, 4, True, "label")
    assert got.pop("device") == "label"
    assert got == repo_summary(rows, dcn, 4, True)


def test_world_of_one_in_process():
    got = bench_scaling.worker(1, (1, 1), 1, device="cpu")
    want = repo_result_keys()
    assert want[:4] == ["n_devices", "mesh", "ensembles", "frames"] and len(want) == 9
    assert set(want) <= set(got)
    assert got["collective_ms"] == 0.0 and got["collective_fraction"] == 0.0
    assert got["backend"] == "gloo" and got["cards"] == 0
    assert (got["n_devices"], got["mesh"], got["ensembles"], got["frames"]) == (1, [1, 1], 2, 4)
    assert got["step_ms"] > 0
    assert not torch.distributed.is_initialized()


def test_size_two_over_gloo():
    got = bench_scaling.size_row(2, reps=1, trials=1, device="cpu", timeout=TIMEOUT_S)
    assert got["backend"] == "gloo" and got["cards"] == 0
    assert (got["n_devices"], got["mesh"], got["ensembles"], got["frames"]) == (2, [1, 2], 2, 8)
    assert got["collective_ms"] >= 0.0
    assert got["trials"] == 1 and isinstance(got["oversubscribed"], bool)
    assert set(repo_result_keys()) <= set(got)


def test_failed_worker_raises(capfd):
    # a (3, 1) mesh does not hold a world of 2: make_mesh raises on both ranks
    with pytest.raises(RuntimeError, match="2-rank world failed"):
        bench_scaling.run_world(2, ["--worker", "--devices", "2", "--mesh", "3,1",
                                    "--reps", "1"], "cpu", TIMEOUT_S)
    err = capfd.readouterr().err
    assert "--- rank 0 of 2" in err and "does not hold the world" in err

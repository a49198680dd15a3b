"""On the card: one short run of each cell through the command, correct,
with its end-to-end metrics, and traced with its per-layer metrics.
Run with `python3 -m pytest -m cuda benchmark/tests` on a machine with a
card; skips elsewhere."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card(card, name, trace):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    cell = harness.load_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    assert list(line)[-1] == "checks"

"""Nothing a run executes loads jax, jaxlib, flax or tpudab: each driver
runs at a tiny size on the CPU in a fresh interpreter, which then lists
the top-level names of every module loaded (compared whole, so
tpudab_torch is not tpudab)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark.tests.conftest import run_tiny, tiny_cell
result, _ = run_tiny(tiny_cell({cell!r}))
print(json.dumps({{"correct": result["correct"],
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("cell", ["bench6.ens32x16", "bench6.decode1"])
def test_run_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(harness.ROOT), cell=cell)],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert "tpudab_torch" in line["modules"]
    assert not set(line["modules"]) & set(harness.REFUSED_MODULES)

"""The step and its driver sit below the synthesiser and the live loop: a
subprocess imports tpudab_torch.models.step and
tpudab_torch.models.step_driver and finds neither tpudab_torch.synth nor
tpudab_torch.host.streaming loaded. (tpudab_torch.models imports the offline
pipeline for tpudab's package-level names, so any import under models loads
it; nothing is asserted of it.)"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys

    import tpudab_torch.models.step
    import tpudab_torch.models.step_driver

    above = ("tpudab_torch.synth", "tpudab_torch.host.streaming")
    loaded = sorted(m for m in sys.modules if m.startswith(above))
    assert not loaded, loaded
    print("OK")
""")


def test_step_and_driver_load_nothing_above_them():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")

"""The benchmark's command: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell (benchmark/harness.py),
makes its inputs from the seed, warms up the shapes the cell uses, runs
the window of --seconds through the cell's driver and prints, as the last
line of stdout, {"correct", "attempted", "failed", "metrics", "device"}
(with --trace 1 the per-layer metrics, busy_s and window_s, and a
"breakdown"), each number compared beside its limit under its last key
"checks" and as the last lines of stderr. Without a CUDA device, or
with jax, jaxlib, flax or tpudab loaded, it exits non-zero and prints no
result. setup_s runs from the start of the process to the start of the
window; the first run in a checkout also builds the program's CUDA
library (tpudab_torch/_build/, keyed by a hash of its sources), reported
as build_s beside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches at fixed paths inside the checkout (the program's own CUDA
    # library is built into tpudab_torch/_build/ there)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(harness.ROOT / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"
    cell = harness.load_cell(args.workload)
    device = harness.card(cell.chips)
    result, checks = harness.driver_module(cell).run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    harness.refuse_jax()
    result["device"] = {**device, **result.get("device", {}),
                        "power": harness.power_limit()}
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

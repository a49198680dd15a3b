"""Readings that the limits of a cell's checks are set from: the program's
(a run of the cell with a short window on each seed, all in one process),
the control's (the driver's control(), on each control seed), and the
program's with a fault planted (--fault, on each seed of --seeds). One
JSON line each on stdout, and in --out.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2 [--fault NAME] [--out FILE]

A cell taken out of BENCHMARK.json (benchmark/withdrawn.json) is
calibrated as well. Faults of the decode cells: `carrier`, acquisition's
net frequency off by one carrier spacing; `capture_bf16`, the capture's
samples rounded to bf16 before the program reads them (the program's own
path one precision below the configuration's f32 capture).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np

from benchmark import harness


@contextlib.contextmanager
def carrier(drv, cell):
    from tpudab_torch.models.pipeline import OfflinePipeline
    from benchmark.synth.ofdm_params import SAMPLING_RATE, get_ofdm_params

    spacing = SAMPLING_RATE / get_ofdm_params(cell.config["mode"]).nb_fft
    orig = OfflinePipeline._acquire

    def shifted(self, iq):
        res = dict(orig(self, iq))
        res["net_freq_hz"] += spacing
        return res
    OfflinePipeline._acquire = shifted
    try:
        yield
    finally:
        OfflinePipeline._acquire = orig


@contextlib.contextmanager
def capture_bf16(drv, cell):
    import torch

    orig = drv.capture_signal

    def rounded(*a):
        cap = orig(*a)
        x = torch.from_numpy(cap.iq.view(np.float32)).to(torch.bfloat16).float().numpy()
        return dataclasses.replace(cap, iq=x.view(np.complex64))
    drv.capture_signal = rounded
    try:
        yield
    finally:
        drv.capture_signal = orig


FAULTS = {"carrier": carrier, "capture_bf16": capture_bf16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, withdrawn=True)
    if args.device == "cuda":
        harness.card(cell.chips)
    drv = harness.driver_module(cell)
    out = open(args.out, "a") if args.out else None
    try:
        for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
            for seed in (int(s) for s in seeds.split(",") if s):
                if kind == "program":
                    fault = FAULTS[args.fault] if args.fault else None
                    with fault(drv, cell) if fault else contextlib.nullcontext():
                        res, checks = drv.run(cell, seed, args.seconds, False, args.device,
                                              time.perf_counter())
                    line = {"correct": res["correct"], "failed": res["failed"],
                            **{k: v for k, (v, _) in checks.items()},
                            **res.get("readings", {})}
                else:
                    line = drv.control(cell, seed)
                line = {"cell": cell.name, "kind": args.fault or kind, "seed": seed, **line}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

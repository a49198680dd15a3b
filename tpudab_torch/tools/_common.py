"""What the kernel-experiment tools share: their arguments, the card's name
and CUDA-event timing."""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from tpudab_torch.utils.device import resolve_device


def parse(argv, doc: str, iters: int = 20):
    """[iters] positional, as tpudab's tools take it, and --device (default
    cuda)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("iters", nargs="?", type=int, default=iters)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card is an error) or cpu, the plain "
                         "torch twins with host times, for rehearsal")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or a
    label that says the times are host times."""
    if dev.type != "cuda":
        return "cpu (host times, not device times)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def timer(dev: torch.device):
    """ms(fn, iters): mean milliseconds of fn() over iters calls after one
    warm-up call, by CUDA events on the card (the host clock on the CPU)."""
    def ms(fn, iters: int) -> float:
        fn()
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    return ms

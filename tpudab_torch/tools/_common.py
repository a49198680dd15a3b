"""What the kernel-experiment tools share: their arguments, the card's name
and CUDA-event timing."""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from tpudab_torch.constants.ofdm_params import get_ofdm_params
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


def gaussian_frames(f: int, dev: torch.device, mode: int = 1):
    """(re3, im3) of tpudab's demod tools: f frames of Gaussian IQ,
    default_rng(0), drawn in f32 and rounded to bf16, in the
    (f, frame_len//128, 128) tiling."""
    p = get_ofdm_params(mode)
    rng = np.random.default_rng(0)
    shape = (f, p.nb_frame_length // 128, 128)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(dev).to(torch.bfloat16) for _ in range(2))


def noise_args(step, n_frames: int, seed: int, dev: torch.device):
    """(carry, frames_re, frames_im, freq_hz) for step: what tpudab's
    example_args(n_frames, seed) gives the tools (a zero carry, Gaussian IQ
    in the step's frame tiling, 0 Hz), with the IQ drawn in bf16 by a
    torch.Generator on dev. The bench's 512 frames are 200M samples, which
    numpy would take seconds to draw on the host; the step's work does not
    depend on the values."""
    shape = (n_frames, step.params.nb_frame_length // 128, 128)
    if step.n_ensembles > 1:
        shape = (step.n_ensembles,) + shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    re, im = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    return step.init_carry(dev), re, im, torch.tensor(0.0, device=dev)

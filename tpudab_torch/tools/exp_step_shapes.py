"""Batch-shape sweep of the whole receive step on the card (the port of
tools/exp_step_shapes.py): the real-time factor per card and the peak
memory at each (ensembles, frames a step). A larger batch spreads the
fixed cost of a call over more signal and holds more on the card; the
bench's E = 32 x F = 16 was tpudab's pick on its chip. Ten steps a shape,
the carry chained from step to step, queued with no sync between them. A
shape the card cannot hold prints FAIL, as tpudab's tool does, and fails
its check.

Run: python -m tpudab_torch.tools.exp_step_shapes [iters]
"""

from __future__ import annotations

import torch

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.tools._common import card, noise_args, parse, timer
from tpudab_torch.tools.bench import bench_subchannels

SHAPES = ((16, 16), (16, 24), (16, 32), (24, 16), (32, 16), (8, 32))


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, shapes=SHAPES) -> dict:
    """The sweep over shapes; returns {"ms": {"e{E}_f{F}": {"step_ms",
    "rtf", "peak_gib", "above_start_gib"}}, "checks": {"e{E}_f{F}": ran}}:
    the peak of torch.cuda.max_memory_allocated over the shape's run, and
    that peak less what the process held when the shape began (None on
    the CPU)."""
    label = card(dev)
    ms = timer(dev)
    res, checks = {}, {}
    for e, f in shapes:
        key = f"e{e}_f{f}"
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        try:
            step = ReceiveStep(1, bench_subchannels(), n_ensembles=e).to(dev)
            carry, fr, fi, freq = noise_args(step, f, 0, dev)
            state = [carry]

            def one():
                state[0], out = step(state[0], fr, fi, freq)
                return out

            dt = ms(one, iters)
        except torch.OutOfMemoryError as ex:
            checks[key] = False
            print(f"e={e:<3} f={f:<3} FAIL {type(ex).__name__}: {str(ex)[:120]}", flush=True)
            continue
        sig_s = e * f * step.params.nb_frame_length / SAMPLING_RATE
        peak = above = None
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            above = peak - start / 2 ** 30
        res[key] = {"step_ms": dt, "rtf": sig_s / (dt / 1e3), "peak_gib": peak,
                    "above_start_gib": above}
        checks[key] = True
        mem = (f"peak {peak:6.2f} GiB ({above:6.2f} above the start)" if peak is not None
               else "peak not measured on the CPU")
        print(f"e={e:<3} f={f:<3} step={dt:8.2f} ms  {res[key]['rtf']:7.0f}x realtime  "
              f"{mem}  [{label}]", flush=True)
        del step, carry, fr, fi, state
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

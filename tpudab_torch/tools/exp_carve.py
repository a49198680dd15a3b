"""Carve-kernel ablations on the card (the port of tools/exp_carve.py, X7):
K5 with frames per block fb in (4, 8, 16), and at fb = 8 without the
window roll (wrong numerics), without the PLL rotation (wrong numerics) and
with neither (a cast copy, the lower bound), beside the production carve
(K5) on 256 mode-I frames of f32 IQ; then the no-rotate variant's library
yardstick, torch's .to(bfloat16) of the windows' strided view of re and
of im (one call a plane). Every variant runs K5's body (csrc/carve.cu).

Run: python -m tpudab_torch.tools.exp_carve [iters]
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.ops.carve import _windows, carve_rotate
from tpudab_torch.ops.carve_exp import carve_variant
from tpudab_torch.tools._common import card, parse, timer


def make_variant(fb: int, do_roll: bool = True, do_rotate: bool = True):
    """run(re3, im3, freq) -> (xr, xi) of the ablation."""
    return lambda re3, im3, freq: carve_variant(re3, im3, freq, fb, do_roll, do_rotate)


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, f: int = 256) -> dict:
    """The tool's work on f frames; returns {"ms": times by name,
    "checks": {}}: like tpudab's, it times and checks nothing
    (tests/test_torch_carve_exp.py and chip_smoke.py hold the variants to
    their twins and to K5)."""
    label = card(dev)
    ms = timer(dev)
    p = get_ofdm_params(1)
    rng = np.random.default_rng(0)
    shape = (f, p.nb_frame_length // 128, 128)
    re3 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    im3 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    freq = torch.zeros((f,), dtype=torch.float32, device=dev)

    res = {}

    def timeit(name, fn):
        res[name] = ms(fn, iters)
        print(f"{name:<56} {res[name]:8.2f} ms  [{label}]", flush=True)

    timeit("production carve_rotate (K5)", lambda: carve_rotate(re3, im3, freq))
    for fb in (4, 8, 16):
        v = make_variant(fb)
        timeit(f"variant fb={fb} full", lambda: v(re3, im3, freq))
    v = make_variant(8, do_roll=False)
    timeit("variant fb=8 NO-ROLL (wrong numerics)", lambda: v(re3, im3, freq))
    v = make_variant(8, do_rotate=False)
    timeit("variant fb=8 NO-ROTATE (wrong numerics)", lambda: v(re3, im3, freq))
    v = make_variant(8, do_roll=False, do_rotate=False)
    timeit("variant fb=8 copy-only (lower bound)", lambda: v(re3, im3, freq))
    flat = [t.reshape(f, -1) for t in (re3, im3)]
    timeit("torch .to(bfloat16) of the windows (NO-ROTATE yardstick)",
           lambda: [_windows(t, 1, 12).to(torch.bfloat16) for t in flat])
    return {"ms": res, "checks": {}}


if __name__ == "__main__":
    main()

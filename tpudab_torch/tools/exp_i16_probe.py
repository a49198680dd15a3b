"""int16 op probe on the card (the port of tools/exp_i16_probe.py, X4):
each of the 13 int16 elementwise ops that the int16 Viterbi needs, run by
the probe kernel (csrc/i16_probe.cu) on two seeded (64, 256) int16 arrays.
tpudab's tool printed OK where the TPU's compiler lowered the op; here
nvcc builds every op, so OK means the kernel's result equals the plain
torch twin's (JAX's semantics) on the card.

Run: python -m tpudab_torch.tools.exp_i16_probe
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.ops.i16_probe import OPS, i16_probe, i16_probe_ref
from tpudab_torch.tools._common import card, parse


def inputs(dev) -> tuple:
    """The tool's two (64, 256) int16 arrays in [-100, 100), seeds 0 and 1."""
    x = np.random.default_rng(0).integers(-100, 100, (64, 256)).astype(np.int16)
    y = np.random.default_rng(1).integers(-100, 100, (64, 256)).astype(np.int16)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def probe(name: str, x: torch.Tensor, y: torch.Tensor) -> bool:
    """Run op `name` through the probe and hold it to the twin; print
    OK or FAIL."""
    out = i16_probe(x, y, name)
    ok = torch.equal(out.cpu(), i16_probe_ref(x.cpu(), y.cpu(), name))
    print(f"{name:30s} {'OK' if ok else 'FAIL: differs from the plain torch twin'}")
    return ok


def main(argv=None) -> dict:
    """Run the tool; returns {"ms": {}, "checks": {op: OK}}."""
    args = parse(argv, __doc__, iters=1)
    print(f"device: {card(args.device)}")
    x, y = inputs(args.device)
    return {"ms": {}, "checks": {name: probe(name, x, y) for name in OPS}}


if __name__ == "__main__":
    main()

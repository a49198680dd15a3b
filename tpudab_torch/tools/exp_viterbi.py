"""Viterbi forward-kernel experiment on the card (the port of
tools/exp_viterbi.py, X1): the branch metrics of 4 super-steps computed
at once ("wide"; on the TPU one matmul over a lane-sliced (T2/4, 8, 4B)
relayout) against the base forward pass.

On the card the wide kernel is the forward variant gmm4 of
csrc/viterbi.cu, which reads the base (T2p, 8, B) layout: the TPU's
lane-slice relayout only fed its matrix unit.

Run: python -m tpudab_torch.tools.exp_viterbi [iters]
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.ops.viterbi_cuda import signs_on
from tpudab_torch.ops.viterbi_exp import forward_decisions
from tpudab_torch.tools._common import card, parse, timer


def fwd_wide(mother_soft: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """(B, T, 4) mother soft bits -> decisions (B, T2p/4, 64), branch
    metrics of each group's 4 super-steps computed at the group's start."""
    return forward_decisions(mother_soft, signs_on(mother_soft.device), chunk, "gmm4")[0]


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, b: int = 6144, n_bits: int = 3456) -> dict:
    """The tool's work on b codewords of n_bits; returns {"ms": times by
    name, "checks": {name: bool}}."""
    label = card(dev)
    ms = timer(dev)
    rng = np.random.default_rng(1)
    t = n_bits + 6
    soft = torch.from_numpy(rng.standard_normal((b, t, 4)).astype(np.float32)).to(dev)
    signs = signs_on(dev)

    base = lambda: forward_decisions(soft, signs, 32)[0]
    wide = lambda: fwd_wide(soft)
    d0, d1 = base(), wide()
    checks = {"identical": torch.equal(d0, d1)}
    print(f"decisions identical: {checks['identical']}  shapes {tuple(d0.shape)} {tuple(d1.shape)}")
    res = {"base": ms(base, iters), "wide": ms(wide, iters)}
    print(f"{'fwd base (per-step branch metrics)':<56} {res['base']:8.2f} ms  [{label}]")
    print(f"{'fwd wide (4-step branch metrics)':<56} {res['wide']:8.2f} ms  [{label}]")
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

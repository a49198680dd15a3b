"""Traceback experiment on the card (the port of tools/exp_tb_tree.py,
X5): the pre-r5 traceback, a masked reduction over the 64 decision rows,
against the 6-level binary select tree on the current state's bits that
replaced it, and the production traceback (a warp shuffle) beside them,
on the production forward pass's decisions.

Run: python -m tpudab_torch.tools.exp_tb_tree [iters]
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.ops.viterbi_cuda import signs_on
from tpudab_torch.ops.viterbi_exp import forward_decisions, traceback_bytes
from tpudab_torch.tools._common import card, parse, timer

B, NBITS = 6144, 3456
CHUNK = 32


def run_tb(mode: str):
    """fn(decs) -> packed bytes (B, T2p/4) by the traceback mode."""
    return lambda decs: traceback_bytes(decs, mode)


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, b: int = B, nbits: int = NBITS) -> dict:
    """The tool's work on b codewords of nbits; returns {"ms": times by
    name, "checks": {name: bool}}."""
    label = card(dev)
    ms = timer(dev)
    rng = np.random.default_rng(1)
    soft = torch.from_numpy(rng.standard_normal((b, nbits + 6, 4)).astype(np.float32)).to(dev)
    decs = forward_decisions(soft, signs_on(dev), CHUNK)[0]
    old, new, prod = run_tb("masked"), run_tb("tree"), run_tb("shuffle")
    o1, o2, o3 = old(decs), new(decs), prod(decs)
    checks = {"identical": torch.equal(o1, o2), "shuffle_identical": torch.equal(o1, o3)}
    print("identical:", checks["identical"], "(production shuffle too:",
          checks["shuffle_identical"], ")")
    res = {}
    for name, fn in (("masked-reduce", old), ("select-tree", new), ("shuffle", prod)):
        res[name] = ms(lambda: fn(decs), iters)
        print(f"{name:14s} {res[name]:7.3f} ms  [{label}]")
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

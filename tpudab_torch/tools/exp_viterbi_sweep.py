"""Viterbi decode rate at the MSC's batch, on the card (the port of
tools/exp_viterbi_sweep.py): viterbi_decode_bytes_best (the flush-padded
transposed copy, then K1+K2) on (6144, 3462, 4) f32 mother soft bits,
3456 data bits, seed 1, 15 queued calls, in decoded Gbit/s. tpudab's tool
sweeps the Pallas kernel's tiling (chunk, b_tile); csrc/viterbi.cu has no
such knob (its thread layout follows B: ops/viterbi_cuda.py::k12_layout),
so this tool prints one row. Checks the
first TWIN_B codewords' bytes against the plain twin.

Run: python -m tpudab_torch.tools.exp_viterbi_sweep [iters]
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from tpudab_torch.ops.viterbi import mother_to_t, viterbi_decode_bytes_t_ref
from tpudab_torch.ops.viterbi_cuda import (K12_LAYOUTS, signs_on, viterbi_decode_bytes_best,
                                           viterbi_decode_bytes_t_cuda)
from tpudab_torch.tools._common import card, parse, timer

B, NBITS = 6144, 3456
TWIN_B = 32


def soft_input(b: int = B, n_bits: int = NBITS,
               dev: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(b, n_bits + 6, 4) f32 mother soft bits, seed 1."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.standard_normal((b, n_bits + 6, 4)).astype(np.float32)).to(dev)


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=15)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, b: int = B, n_bits: int = NBITS) -> dict:
    """The decode on b codewords of n_bits; returns {"ms": {"decode",
    "gbit_s"}, "checks": {"twin": bool}}."""
    label = card(dev)
    ms = timer(dev)
    soft = soft_input(b, n_bits, dev)
    by = viterbi_decode_bytes_best(soft, n_bits)
    n = min(TWIN_B, b)
    twin = viterbi_decode_bytes_t_ref(mother_to_t(soft[:n]), signs_on(dev), n_bits)
    checks = {"twin": torch.equal(by[:n], twin)}
    print(f"first {n} codewords equal the plain twin's: {checks['twin']}", flush=True)
    before = collections.Counter(viterbi_decode_bytes_t_cuda.layout_launches)
    dt = ms(lambda: viterbi_decode_bytes_best(soft, n_bits), iters)
    taken = {K12_LAYOUTS[k]: n
             for k, n in (viterbi_decode_bytes_t_cuda.layout_launches - before).items()}
    res = {"decode": dt, "gbit_s": b * n_bits / (dt / 1e3) / 1e9}
    print(f"K1+K2 (launches by layout: {taken or 'none, the plain twin'})  {dt:7.3f} ms  "
          f"{res['gbit_s']:6.2f} Gbit/s  [{label}]", flush=True)
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

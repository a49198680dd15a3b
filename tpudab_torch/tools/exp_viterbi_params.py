"""The MSC's Viterbi chain at the bench's shape, on the card (the port of
tools/exp_viterbi_params.py): depuncture_t, then K1+K2, on the bench
subchannel's geometry (eep_profile(108, 3, 0)), B = 6 x 16 x 64 = 6144
codewords (6 subchannels x 16 ensembles x 64 CIFs) of Gaussian bf16 soft
bits, seed 0. tpudab's tool sweeps the Pallas kernel's tiling (chunk,
b_tile); csrc/viterbi.cu has no such knob (its thread layout follows B,
ops/viterbi_cuda.py::k12_layout; the rebase is fixed), so this tool
times the chain once and prints one row: the
decode alone on the depunctured input, as tpudab's rows do, and the
chain. Checks the first TWIN_B codewords' bytes against the plain twin.

Run: python -m tpudab_torch.tools.exp_viterbi_params [iters]
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from tpudab_torch.constants.puncture import eep_profile
from tpudab_torch.fec.depuncture import depuncture_index, depuncture_t
from tpudab_torch.ops.viterbi_cuda import (K12_LAYOUTS, signs_on, viterbi_decode_bytes_t,
                                           viterbi_decode_bytes_t_cuda)
from tpudab_torch.ops.viterbi import viterbi_decode_bytes_t_ref
from tpudab_torch.tools._common import card, parse, timer

B = 6 * 16 * 64
TWIN_B = 32


def soft_input(b: int = B, dev: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(b, n_punct) bf16 punctured soft bits of the bench subchannel, seed 0."""
    prof = eep_profile(108, 3, 0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, prof.punctured_bits)).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(torch.bfloat16)


def chain(soft: torch.Tensor):
    """(fns, st): fns = {"decode": K1+K2 on st, "chain": depuncture_t +
    K1+K2}, st the depunctured (T2p, 8, B) input."""
    prof = eep_profile(108, 3, 0)
    index = torch.from_numpy(depuncture_index(prof)).to(soft.device)
    signs = signs_on(soft.device)
    st = depuncture_t(soft, index)
    return ({"decode": lambda: viterbi_decode_bytes_t(st, signs, prof.data_bits),
             "chain": lambda: viterbi_decode_bytes_t(depuncture_t(soft, index), signs,
                                                     prof.data_bits)}, st)


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, b: int = B) -> dict:
    """The chain on b codewords; returns {"ms": {"decode", "chain"},
    "checks": {"twin": bool}}."""
    label = card(dev)
    ms = timer(dev)
    prof = eep_profile(108, 3, 0)
    fns, st = chain(soft_input(b, dev))
    print(f"T2p={st.shape[0]} B={b} n_bits={prof.data_bits}", flush=True)
    by = fns["decode"]()
    n = min(TWIN_B, b)
    twin = viterbi_decode_bytes_t_ref(st[:, :, :n].contiguous(), signs_on(dev), prof.data_bits)
    checks = {"twin": torch.equal(by[:n], twin)}
    print(f"first {n} codewords equal the plain twin's: {checks['twin']}", flush=True)
    before = collections.Counter(viterbi_decode_bytes_t_cuda.layout_launches)
    res = {name: ms(fn, iters) for name, fn in fns.items()}
    taken = {K12_LAYOUTS[k]: n
             for k, n in (viterbi_decode_bytes_t_cuda.layout_launches - before).items()}
    print(f"K1+K2 (launches by layout: {taken or 'none, the plain twin'}) decode "
          f"{res['decode']:7.2f} ms, "
          f"depuncture_t + decode {res['chain']:7.2f} ms  [{label}]", flush=True)
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

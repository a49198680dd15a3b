"""int16 path-metric Viterbi forward kernel on the card (the port of
tools/exp_viterbi_i16.py, X3).

Soft bits quantised to integers in [-127, 127], branch metrics summed in
int16, int16 path metrics starting at -16000 and rebased by state 0 after
every group of 4 super-steps (|pm| stays far from the int16 wrap). On
integer-valued soft bits every sum is exact in f32 as well, yet the int16
decisions differ from the f32 kernel's in the first group: there the f32
start value -1e9 rounds each branch metric added to an unreachable state
to a multiple of 64, while int16's -16000 keeps it exact. From the second
group on, when every state is reachable, the two are equal.

Run: python -m tpudab_torch.tools.exp_viterbi_i16 [iters]
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.ops.viterbi_cuda import signs_on
from tpudab_torch.ops.viterbi import mother_to_t
from tpudab_torch.ops.viterbi_exp import forward_decisions, fwd_variant
from tpudab_torch.tools._common import card, parse, timer

B, NBITS = 6144, 3456
CHUNK = 32
REBASE = 4      # super-steps between rebases of the int16 metrics


def run_i16(soft_t_i16: torch.Tensor):
    """(fn, args): fn(*args) runs the int16 forward pass on int16 soft bits
    (T2p, 8, B), T2p % CHUNK == 0, and returns its decisions."""
    if soft_t_i16.dtype != torch.int16 or soft_t_i16.shape[0] % CHUNK:
        raise ValueError(f"run_i16 takes int16 (T2p % {CHUNK} == 0, 8, B), got "
                         f"{soft_t_i16.dtype} {tuple(soft_t_i16.shape)}")
    signs = signs_on(soft_t_i16.device)
    return (lambda sg, x: fwd_variant(x, sg, "full", REBASE)[0]), (signs, soft_t_i16)


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, b: int = B, nbits: int = NBITS) -> dict:
    """The tool's work on b codewords of nbits; returns {"ms": times by
    name, "checks": {name: bool}} (the int16 decisions against f32's from
    the second group on; in the first they differ by design, which is
    printed)."""
    label = card(dev)
    ms = timer(dev)
    print(f"device: {label}, B={b}, NBITS={nbits}, iters={iters}")
    rng = np.random.default_rng(1)
    # integer-valued soft in [-127, 127]: exact in both f32 and int16
    soft_i = torch.from_numpy(rng.integers(-127, 128, (b, nbits + 6, 4)).astype(np.int16))
    soft_f = soft_i.to(dev, torch.float32)
    signs = signs_on(dev)

    # production f32 kernel decisions for the exactness check
    decs_f = forward_decisions(soft_f, signs, CHUNK)[0]
    # the same relayout of the int16 input, flush pad +1 as the f32 path's
    soft_t16 = mother_to_t(soft_i.to(dev), 8 * CHUNK, value=1)
    print(f"soft_t16 {tuple(soft_t16.shape)}")

    fn, a = run_i16(soft_t16)
    d16 = fn(*a)
    print(f"int16 decisions identical to f32 kernel: {torch.equal(d16, decs_f)}")
    checks = {"from_group_1": torch.equal(d16[:, 1:], decs_f[:, 1:])}
    print(f"int16 decisions identical to f32 kernel from the second group on: "
          f"{checks['from_group_1']}")

    res = {"i16": ms(lambda: fn(*a), iters)}
    print(f"i16 fwd     {res['i16']:8.3f} ms  [{label}]")
    res["f32"] = ms(lambda: forward_decisions(soft_f, signs, CHUNK), iters)
    print(f"f32 fwd     {res['f32']:8.3f} ms  (speedup {res['f32'] / res['i16']:.2f}x)  [{label}]")
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

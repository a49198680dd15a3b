"""Transposed depuncture feeding the Viterbi forward kernel directly in the
(T2p, 8, B) layout, on the card (the port of tools/exp_depunct_t.py, X6):
depuncture_t, then the forward pass (fwd_t) and the traceback (tb_t) as
two kernels, against the production path (depuncture, then
viterbi_decode_bytes_best: relayout + fused forward and traceback).

Validates bit-identical packed bytes against the production path and the
decode against the sent bits, then times both at production shape.

Run: python -m tpudab_torch.tools.exp_depunct_t [iters]
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.constants.puncture import eep_profile
from tpudab_torch.fec.conv import conv_encode
from tpudab_torch.fec.depuncture import depuncture, depuncture_index, depuncture_t
from tpudab_torch.fec.depuncture import puncture as puncture_np
from tpudab_torch.ops.viterbi_cuda import signs_on, viterbi_decode_bytes_best
from tpudab_torch.ops.viterbi_exp import fwd_variant, traceback_bytes
from tpudab_torch.tools._common import card, parse, timer
from tpudab_torch.utils.bits import pack_bits


def fwd_t(soft_t: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """Forward pass on pre-transposed (T2p, 8, B) soft bits, T2p % chunk ==
    0, rebased every chunk -> packed decisions (B, T2p/4, 64)."""
    return fwd_variant(soft_t, signs_on(soft_t.device), "full", chunk)[0]


def tb_t(decs: torch.Tensor) -> torch.Tensor:
    """Traceback of packed decisions -> (B, T2p/4) bytes."""
    return traceback_bytes(decs, "shuffle")


def decode_t(punctured: torch.Tensor, profile) -> torch.Tensor:
    """Punctured soft (B, n_punct) -> (B, data_bits // 8) bytes."""
    index = torch.as_tensor(depuncture_index(profile), device=punctured.device)
    by = tb_t(fwd_t(depuncture_t(punctured, index)))
    return by[:, : profile.data_bits // 8]


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, b: int = 6144) -> dict:
    """The tool's work, timed on b codewords (checked on up to 1024);
    returns {"ms": times by name, "checks": {name: bool}}."""
    label = card(dev)
    ms = timer(dev)
    rng = np.random.default_rng(5)

    # correctness on a real coded signal (EEP 3-A geometry, small batch)
    prof = eep_profile(108, 3, 0)
    n_bits = prof.data_bits
    b_small = min(1024, b)
    msgs = rng.integers(0, 2, (b_small, n_bits)).astype(np.uint8)
    coded = np.stack([puncture_np(conv_encode(m), prof) for m in msgs])
    soft = (1.0 - 2.0 * coded + 0.3 * rng.standard_normal(coded.shape)).astype(np.float32)
    softj = torch.from_numpy(soft).to(dev, torch.bfloat16)

    ref = viterbi_decode_bytes_best(depuncture(softj, prof).reshape(b_small, -1, 4), n_bits)
    got = decode_t(softj, prof)
    same = torch.equal(got, ref)
    exp = torch.from_numpy(pack_bits(msgs)).to(dev)
    checks = {"bytes_identical": same, "decode_correct": torch.equal(got, exp)}
    print(f"bytes identical to production path: {same}; "
          f"decode correct: {checks['decode_correct']}")
    if not same:
        bad = torch.nonzero(got != ref)
        print("first mismatches:", bad[:5].tolist())
        return {"ms": {}, "checks": checks}

    # timing at production shape
    s_kept = prof.punctured_bits
    punct = torch.from_numpy(rng.standard_normal((b, s_kept)).astype(np.float32)
                             ).to(dev, torch.bfloat16)
    prod = lambda: viterbi_decode_bytes_best(depuncture(punct, prof).reshape(b, -1, 4), n_bits)
    newp = lambda: decode_t(punct, prof)
    checks["prod_shape_identical"] = torch.equal(prod(), newp())
    print("production == transposed at prod shape:", checks["prod_shape_identical"])
    res = {"production": ms(prod, iters), "transposed": ms(newp, iters)}
    print(f"{'depunct + transpose + fwd + tb (production)':<52} "
          f"{res['production']:8.2f} ms  [{label}]")
    print(f"{'depunct_t + fwd + tb (transposed)':<52} {res['transposed']:8.2f} ms  [{label}]")
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

"""Decompose the Viterbi forward kernel's time at production shape, on the
card (the port of tools/exp_viterbi_decompose.py, X2).

Variants (csrc/viterbi.cu::viterbi_fwd_variant_kernel; one 64-thread
block per codeword, the production kernel's forward pass with one part
switched):
  full      production forward (branch metrics + ACS + decision pack + store)
  nodec     branch metrics + ACS chain, no decision extract or pack (zero
            rows stored): isolates the decisions
  noacs     all four branch metrics + decisions from them alone, no
            recursion: isolates the ACS dependency chain
  bmonly    the same kernel as noacs, as in tpudab (its `not do_acs` branch
            returns before `do_dec` is read)
  prefetch  next step's branch metrics computed before this step's ACS
  dbuf      the same through a double buffer in shared memory (f32 and bf16)
  gmm4      branch metrics of a group's 4 super-steps at the group's start
  tbonly    the traceback kernel alone on precomputed decisions
  e2e       viterbi_decode_bytes_best (relayout + fused forward + traceback)

Timing: CUDA events around iters launches after one warm-up.

Run: python -m tpudab_torch.tools.exp_viterbi_decompose [iters]
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.ops.viterbi_cuda import signs_on, viterbi_decode_bytes_best
from tpudab_torch.ops.viterbi import mother_to_t
from tpudab_torch.ops.viterbi_exp import forward_decisions, fwd_variant, traceback_bytes
from tpudab_torch.tools._common import card, parse, timer

B, NBITS = 6144, 3456
CHUNK = 32


def run_variant(variant: str, soft_t: torch.Tensor, chunk: int = CHUNK):
    """(fn, args): fn(*args) runs the forward variant on soft_t (T2p, 8, B),
    rebased every chunk, and returns its decisions (B, T2p/4, 64)."""
    signs = signs_on(soft_t.device)
    return (lambda sg, x: fwd_variant(x, sg, variant, chunk)[0]), (signs, soft_t)


def run_dbuf(soft_t: torch.Tensor, chunk: int = CHUNK, sdt=None):
    """The double-buffered variant, on soft_t cast to sdt (bf16 for
    dbuf_bf16)."""
    return run_variant("dbuf", soft_t.to(sdt or soft_t.dtype), chunk)


def run_gmm4(soft_t: torch.Tensor, chunk: int = CHUNK):
    """The group-of-4 branch-metric variant."""
    return run_variant("gmm4", soft_t, chunk)


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, b: int = B, nbits: int = NBITS) -> dict:
    """The tool's work on b codewords of nbits; returns {"ms": times by
    name, "checks": {name: bool}} with checks that hold on any input (the
    dbuf decisions against production are printed, not checked: the two
    relayouts pad T differently, so they part in the pad groups)."""
    label = card(dev)
    ms = timer(dev)
    print(f"device: {label}, B={b}, NBITS={nbits}, iters={iters}")
    rng = np.random.default_rng(1)
    soft = torch.from_numpy(rng.standard_normal((b, nbits + 6, 4)).astype(np.float32)).to(dev)
    signs = signs_on(dev)

    # production relayout once (not timed): decisions of the flush-padded
    # input; the variants run on the 0.0-padded relayout, as tpudab's do
    decs = forward_decisions(soft, signs, CHUNK)[0]
    soft_t = mother_to_t(soft, 8 * CHUNK, value=0.0)
    print(f"soft_t {tuple(soft_t.shape)} decs {tuple(decs.shape)}")
    results = {}

    fn, a = run_dbuf(soft_t)
    d_db = fn(*a)
    print(f"dbuf decisions identical to production: {torch.equal(d_db, decs)}")
    data_groups = (nbits + 6) // 2 // 4     # groups whose 4 super-steps are all data
    checks = {"dbuf_before_pad": torch.equal(d_db[:, :data_groups], decs[:, :data_groups])}
    print(f"dbuf decisions identical to production before the pad (groups < "
          f"{data_groups}): {checks['dbuf_before_pad']}")
    results["dbuf"] = ms(lambda: fn(*a), iters)
    print(f"{'dbuf':10s} {results['dbuf']:8.3f} ms")

    fn, a16 = run_dbuf(soft_t, sdt=torch.bfloat16)
    results["dbuf_bf16"] = ms(lambda: fn(*a16), iters)
    print(f"{'dbuf_bf16':10s} {results['dbuf_bf16']:8.3f} ms")

    for name in ("full", "nodec", "noacs", "bmonly"):
        fn, a = run_variant(name, soft_t)
        results[name] = ms(lambda: fn(*a), iters)
        print(f"{name:10s} {results[name]:8.3f} ms")

    # traceback alone, on the production decisions
    results["tbonly"] = ms(lambda: traceback_bytes(decs, "shuffle"), iters)
    print(f"{'tbonly':10s} {results['tbonly']:8.3f} ms")

    # end to end (the (B,T,4)->(T2,8,B) relayout + fused forward and traceback)
    results["e2e"] = ms(lambda: viterbi_decode_bytes_best(soft, nbits), iters)
    print(f"{'e2e':10s} {results['e2e']:8.3f} ms  "
          f"({b * nbits / (results['e2e'] * 1e-3) / 1e9:.2f} Gbit/s)")

    print(f"\nDecomposition (ms) [{label}]:")
    print(f"  branch metrics      : {results['bmonly']:.3f}  (bmonly)")
    print(f"  + ACS chain         : {results['nodec'] - results['bmonly']:.3f}")
    print(f"  + decisions+store   : {results['full'] - results['nodec']:.3f}")
    print(f"  fwd total           : {results['full']:.3f}")
    print(f"  traceback           : {results['tbonly']:.3f}")
    print(f"  e2e                 : {results['e2e']:.3f}")
    return {"ms": results, "checks": checks}


if __name__ == "__main__":
    main()

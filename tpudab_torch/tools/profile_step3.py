"""Cumulative in-step breakdown of the receive step on the card (the port
of tools/profile_step3.py), timed as the step runs: calls queued with no
sync between them. Stages, at the port's own cuts:
1. the demod alone (ReceiveStep.demod: K5, the three DFT products, the
   demap and the normalisation);
2. + the MSC's K4 mode (b) launches, from the soft bits and the 15-CIF
   carry to the Viterbi input (ReceiveStep.msc_viterbi_inputs);
3. + K1+K2 and the PRBS XOR on the MSC (ReceiveStep._decode_descramble);
4. the whole ReceiveStep.forward, which adds the FIC.
tpudab's step deinterleaves and depunctures in two stages; the port's K4
mode (b) does both in one launch a subchannel, so they are one stage here.
Runs at tpudab's E = 16 x F = 16 and the bench's E = 32 x F = 16, six
108-CU EEP 3-A subchannels, bf16 IQ. Checks that stage 3's MSC bytes are
the full step's.

Run: python -m tpudab_torch.tools.profile_step3 [iters]
"""

from __future__ import annotations

import torch

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.tools._common import card, noise_args, parse, timer
from tpudab_torch.tools.bench import bench_subchannels

SHAPES = ((16, 16), (32, 16))   # (ensembles, frames a step)


def stages(step: ReceiveStep, carry, frames_re, frames_im, freq_hz):
    """{name: fn()} of the four cumulative stages on one set of inputs;
    every stage starts from carry, as the step does."""
    e = step.n_ensembles
    f = frames_re.reshape(-1, step.params.nb_frame_length).shape[0] // e

    def demod():
        return step.demod(frames_re, frames_im, freq_hz)[0]

    def viterbi_input():
        return step.msc_viterbi_inputs(carry, demod())

    def msc_bytes():
        _, inputs = viterbi_input()
        return {cfg.subch_id: by
                for profile, cfgs, soft_t in inputs
                for cfg, by in zip(cfgs, step._decode_descramble(soft_t, profile)
                                   .reshape(len(cfgs), e, f * step.dab.nb_cifs, -1))}

    return {"demod only": demod,
            "+ K4 (b): deinterleave + depuncture (MSC)": viterbi_input,
            "+ K1+K2 + descramble (MSC only, no FIC)": msc_bytes,
            "FULL ReceiveStep": lambda: step(carry, frames_re, frames_im, freq_hz)[1]}


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, shapes=SHAPES) -> dict:
    """The breakdown at each (E, F) of shapes; returns {"ms": {"e{E}_f{F}":
    {stage: ms, "rtf": x}}, "checks": {"e{E}_f{F}_msc_bytes": bool}}."""
    label = card(dev)
    ms = timer(dev)
    res, checks = {}, {}
    for e, f in shapes:
        step = ReceiveStep(1, bench_subchannels(), n_ensembles=e).to(dev)
        args = noise_args(step, f, 0, dev)
        fns = stages(step, *args)
        got = fns["+ K1+K2 + descramble (MSC only, no FIC)"]()
        full = fns["FULL ReceiveStep"]()["subch"]
        key = f"e{e}_f{f}"
        checks[f"{key}_msc_bytes"] = all(torch.equal(got[sid].reshape(full[sid].shape), full[sid])
                                         for sid in full)
        print(f"E={e} x F={f}: stage 3's MSC bytes equal the step's: "
              f"{checks[f'{key}_msc_bytes']}", flush=True)
        t = {name: ms(fn, iters) for name, fn in fns.items()}
        for name, v in t.items():
            print(f"  {name:<56} {v:8.2f} ms  [{label}]", flush=True)
        cum = list(t.values())
        deltas = dict(zip(("deint+depunct", "viterbi", "fic+rest"),
                          (b - a for a, b in zip(cum, cum[1:]))))
        sig_s = e * f * step.params.nb_frame_length / SAMPLING_RATE
        t["rtf"] = sig_s / (cum[-1] / 1e3)
        t["deltas"] = deltas
        print("  deltas: " + "  ".join(f"{k}={v:.2f}" for k, v in deltas.items())
              + f" ms;  full step -> {t['rtf']:.0f}x realtime  [{label}]", flush=True)
        res[key] = t
        del step, args, fns, got, full
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

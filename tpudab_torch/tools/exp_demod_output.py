"""The demod's output side on the card (the port of
tools/exp_demod_output.py): the price of the soft array's concat and
normalisation after the port's demod front (K5, the three DFT products,
the differential demap; ofdm/demod.py::spectra_split, differential_demap).
Four variants: the parts (dr, di) alone; + the concat to (F,
nb_frame_bits); + the normalisation on the flat array; the parts
normalised and not concatenated. The last is the one the port's eager
chain runs (demod_frames_split on the CPU normalises the parts, then
concatenates; on the card its tail is csrc/demod_tail.cu, which writes
the same layout), so its check holds it, concatenated, within 1 bf16 ulp
of demod_frames_split's soft bits. 256 frames of Gaussian bf16 IQ, seed 0, 1200 Hz.

Run: python -m tpudab_torch.tools.exp_demod_output [iters]
"""

from __future__ import annotations

import torch

from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.ofdm.demod import (demod_frames_split, dft_operands, differential_demap,
                                     spectra_split)
from tpudab_torch.tools._common import card, gaussian_frames, parse, timer

FREQ_HZ = 1200.0


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 ulps at the larger magnitude of the two."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    return (got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def variants(re3, im3, freq, operands, mode: int = 1):
    """{name: fn()} of the four output-side variants."""
    p = get_ofdm_params(mode)
    f = re3.shape[0]

    def parts():
        return differential_demap(*spectra_split(re3, im3, freq, operands, mode))

    def concat():
        return torch.cat(parts(), dim=-1).reshape(f, p.nb_frame_bits)

    def concat_norm():
        soft = concat()
        norm = soft.abs().float().mean(dim=-1, keepdim=True)
        return (soft.float() / norm.clamp_min(1e-20)).to(torch.bfloat16)

    def norm_parts():
        dr, di = parts()
        s = (dr.abs().float().mean(dim=(1, 2), keepdim=True)
             + di.abs().float().mean(dim=(1, 2), keepdim=True)) * 0.5
        inv = 1.0 / s.clamp_min(1e-20)
        return (dr.float() * inv).to(torch.bfloat16), (di.float() * inv).to(torch.bfloat16)

    return {"parts (dr,di)": parts, "concat": concat, "concat+norm": concat_norm,
            "norm parts": norm_parts}


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, f: int = 256) -> dict:
    """The four variants on f frames; returns {"ms": times by name,
    "checks": {"norm_parts_is_the_demod": bool}}."""
    label = card(dev)
    ms = timer(dev)
    p = get_ofdm_params(1)
    re3, im3 = gaussian_frames(f, dev)
    freq = torch.full((f,), FREQ_HZ, dtype=torch.float32, device=dev)
    ops = tuple(w.to(dev) for w in dft_operands(1))
    fns = variants(re3, im3, freq, ops)

    soft = torch.cat(fns["norm parts"](), dim=-1).reshape(f, p.nb_frame_bits)
    want = demod_frames_split(re3, im3, freq, ops, out_dtype=torch.bfloat16)[0]
    worst = float(bf16_ulps(soft, want).max())
    checks = {"norm_parts_is_the_demod": worst <= 1.0}
    print(f"norm parts, concatenated, against demod_frames_split: at most {worst:.2f} "
          f"bf16 ulp (1 allowed)", flush=True)
    res = {}
    for name, fn in fns.items():
        res[name] = ms(fn, iters)
        print(f"{name:16s} {res[name]:7.3f} ms  [{label}]", flush=True)
    return {"ms": res, "checks": checks}


if __name__ == "__main__":
    main()

"""FFT windows snapped to 128-sample rows, on the card (the port of
tools/exp_aligned_demod.py).

K5 exists because the symbol stride (2552) is not a multiple of the
128-sample row: each window starts at another phase of the row. But the
window's start is free inside the cyclic prefix. Snapping each start down
to the previous row boundary keeps it inside the prefix and the symbol
(the window offset then runs 12..139, under the prefix's 504), and the
windows become whole rows of the rotated frame: a plain row gather, no
hand kernel. The price: symbol s's shift delta_s in (-128, 0] puts a known
linear phase exp(2 pi j k delta_s / N) on its spectrum, which the
differential demap does not cancel (delta differs between neighbours).
One static (n_sym - 1, K) complex product after the demap undoes it.

Compares the demapped soft parts (relative difference and the share of
equal hard decisions) and the times against the production path (K5, the
three DFT products, the demap; ofdm/demod.py) on real OFDM: four frames of
seeded random bits from the port's modulator with 1234.5 Hz of offset and
no noise (a shifted window sees a cyclic rotation of the same symbol only
for a signal with a cyclic prefix), tiled to the bench's 256 frames.

Run: python -m tpudab_torch.tools.exp_aligned_demod [iters]
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpudab_torch.constants.interleaver import get_carrier_map_positions
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.ofdm.demod import (active_bin_indices, dft_operands, differential_demap,
                                     spectra_split)
from tpudab_torch.synth.modulator import Impairments, apply_impairments, modulate_frame_bits
from tpudab_torch.tools._common import card, parse, timer

WINDOW_OFFSET = 12
FREQ_HZ = 1234.5
# the share of hard decisions (signs of the demapped real part) on which
# the two paths must agree: on a clean signal both decide every carrier
# of every symbol pair the same way
SIGN_MATCH_MIN = 0.999


@functools.lru_cache(maxsize=None)
def aligned_tables(mode: int = 1, window_offset: int = WINDOW_OFFSET):
    """(r0, corr_c, corr_s, t3) in numpy: each window's first row, the
    cos and sin (n_sym - 1, K) of the post-demap correction (columns in
    logical carrier order), and the (rows, 128) f32 sample times."""
    p = get_ofdm_params(mode)
    n_sym, n_fft, n_cp = p.nb_symbols, p.nb_fft, p.nb_cyclic_prefix
    stride, start = n_fft + n_cp, n_cp - window_offset
    a_nom = [p.nb_null_period + stride * s + start for s in range(n_sym)]
    r0 = np.array([a // 128 for a in a_nom])
    delta = r0 * 128 - np.array(a_nom)                       # in (-128, 0]
    bins = active_bin_indices(mode)
    pos = get_carrier_map_positions(mode)
    k_signed = (bins[pos.astype(np.int64)] + n_fft // 2) % n_fft - n_fft // 2
    dd = delta[1:] - delta[:-1]
    ang = -2.0 * np.pi * np.outer(dd, k_signed) / n_fft      # conj to undo
    t_abs = (np.arange(p.nb_frame_length) / SAMPLING_RATE).astype(np.float32)
    return (r0, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            t_abs.reshape(-1, 128))


def aligned_path(re3, im3, freq, operands, mode: int = 1):
    """Full-frame rotate, row-gathered windows, the three products, the
    demap and the correction: (dr, di) (f, n_sym - 1, K) bf16."""
    p = get_ofdm_params(mode)
    r0, corr_c, corr_s, t3 = aligned_tables(mode)
    dev = re3.device
    f, rows_win = re3.shape[0], p.nb_fft // 128
    ph = (-2.0 * math.pi) * freq[:, None, None] * torch.from_numpy(t3).to(dev)[None]
    c, s = torch.cos(ph), torch.sin(ph)
    vr, vi = re3.float(), im3.float()
    xr = (vr * c - vi * s).to(torch.bfloat16)
    xi = (vr * s + vi * c).to(torch.bfloat16)
    rows = torch.from_numpy((r0[:, None] + np.arange(rows_win)[None]).reshape(-1)).to(dev)
    ar = xr.index_select(1, rows).view(f, p.nb_symbols, p.nb_fft)
    ai = xi.index_select(1, rows).view(f, p.nb_symbols, p.nb_fft)
    wc, wcd, wdc = operands
    m1 = torch.matmul(ar + ai, wc)
    m2 = torch.matmul(ai, wcd)
    m3 = torch.matmul(ar, wdc)
    dr, di = differential_demap(m1 - m2, m3 + m1)
    cc = torch.from_numpy(corr_c).to(dev, dr.dtype)[None]
    ss = torch.from_numpy(corr_s).to(dev, dr.dtype)[None]
    return dr * cc - di * ss, di * cc + dr * ss


def production(re3, im3, freq, operands, mode: int = 1):
    """K5, the three products and the demap: (dr, di)."""
    return differential_demap(*spectra_split(re3, im3, freq, operands, mode, WINDOW_OFFSET))


def ofdm_frames(f: int, mode: int = 1) -> np.ndarray:
    """(f, frame_len) complex64: four frames of random bits (seed 0) from
    the modulator with FREQ_HZ of offset, tiled to f."""
    p = get_ofdm_params(mode)
    rng = np.random.default_rng(0)
    base = []
    for _ in range(4):
        bits = rng.integers(0, 2, p.nb_frame_bits).astype(np.uint8)
        iq = modulate_frame_bits(bits, mode)
        base.append(apply_impairments(iq, Impairments(freq_offset_hz=FREQ_HZ))[:p.nb_frame_length])
    return np.stack(base * (f // 4))


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, f: int = 256) -> dict:
    """Both paths on f frames (a multiple of 4); returns {"ms":
    {"production", "aligned", "rel_diff", "sign_match", "speedup"},
    "checks": {"sign_match": bool}}."""
    label = card(dev)
    ms = timer(dev)
    frames = ofdm_frames(f)
    re3, im3 = (torch.from_numpy(np.ascontiguousarray(v, np.float32).reshape(f, -1, 128))
                .to(dev).to(torch.bfloat16) for v in (frames.real, frames.imag))
    freq = torch.full((f,), FREQ_HZ, dtype=torch.float32, device=dev)
    ops = tuple(w.to(dev) for w in dft_operands(1))

    res = {"production": ms(lambda: production(re3, im3, freq, ops), iters)}
    print(f"{'production carve (K5) + matmul + demap':<56} {res['production']:8.2f} ms  "
          f"[{label}]", flush=True)
    res["aligned"] = ms(lambda: aligned_path(re3, im3, freq, ops), iters)
    print(f"{'aligned rows + matmul + demap + correction':<56} {res['aligned']:8.2f} ms  "
          f"[{label}]", flush=True)
    dr_p = production(re3, im3, freq, ops)[0].float()
    dr_a = aligned_path(re3, im3, freq, ops)[0].float()
    res["rel_diff"] = float((dr_p - dr_a).abs().mean() / dr_p.abs().mean())
    res["sign_match"] = float((torch.sign(dr_p) == torch.sign(dr_a)).float().mean())
    res["speedup"] = res["production"] / res["aligned"]
    print(f"mean|diff|/mean|ref| = {res['rel_diff']:.2e}")
    print(f"hard-decision sign match = {res['sign_match']:.6f}")
    print(f"speedup: {res['speedup']:.2f}x")
    return {"ms": res, "checks": {"sign_match": res["sign_match"] >= SIGN_MATCH_MIN}}


if __name__ == "__main__":
    main()

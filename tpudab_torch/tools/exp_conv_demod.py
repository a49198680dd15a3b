"""The carve and the DFT as one strided product, on the card (the port of
tools/exp_conv_demod.py).

The DAB symbol stride (nb_fft + nb_cyclic_prefix = 2552 in mode I)
exceeds the FFT window (2048), so the windows never overlap: window s of
the PLL-rotated frame is the strided view x[a0 + 2552 s : + 2048] with
a0 = null + (cp - 12), and the demod's products could read the (f, 76,
2048) windows straight from the rotated frame. Then K5 and the
materialised window tensor go; what is left is one full-frame rotate
(eager torch here, as tpudab's is an XLA elementwise pass).

Compares the three DFT products on that view with the production path (K5
+ the products, ofdm/demod.py::spectra_split) at the bench's 256 frames
(Gaussian IQ, bf16, 1234.5 Hz, seed 0): mean|diff|/mean|ref| of the real
spectra and the ratio of the times. Then traces one product on the view
to find out whether torch.matmul reads it in place or first copies it
(aten::copy_ / clone / contiguous, a copy kernel on the card) and which
matrix-product op and kernel it runs.

Run: python -m tpudab_torch.tools.exp_conv_demod [iters]
"""

from __future__ import annotations

import math

import torch

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.ofdm.demod import dft_operands, spectra_split
from tpudab_torch.tools._common import card, gaussian_frames, parse, timer

WINDOW_OFFSET = 12
FREQ_HZ = 1234.5
# the mean relative difference of the two paths' spectra that the check
# allows: each path rounds its rotated windows to bf16 (half an ulp,
# 2^-9 relative) from phases computed apart, so their products differ by
# a few 2^-9; 2^-7 is four of them
REL_DIFF_MAX = 2.0 ** -7
COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous")


def windows_view(x: torch.Tensor, mode: int = 1, window_offset: int = WINDOW_OFFSET):
    """(f, frame_len) -> (f, n_sym, n_fft) strided view of the FFT windows:
    offset a0 = null + cp - window_offset, stride nb_fft + cp, no copy."""
    p = get_ofdm_params(mode)
    a0 = p.nb_null_period + p.nb_cyclic_prefix - window_offset
    return x.as_strided((x.shape[0], p.nb_symbols, p.nb_fft),
                        (x.stride(0), p.nb_fft + p.nb_cyclic_prefix, 1),
                        x.storage_offset() + a0)


def rotate_frames(re3, im3, freq, mode: int = 1):
    """The full-frame PLL rotate: (f, frame_len) bf16 ar, ai, the phase of
    each sample from its time in the frame, in f32."""
    p = get_ofdm_params(mode)
    f = re3.shape[0]
    fr = re3.reshape(f, p.nb_frame_length).float()
    fi = im3.reshape(f, p.nb_frame_length).float()
    t = torch.arange(p.nb_frame_length, dtype=torch.float32, device=fr.device) / SAMPLING_RATE
    ph = (-2.0 * math.pi) * freq[:, None] * t[None, :]
    c, s = torch.cos(ph), torch.sin(ph)
    return (fr * c - fi * s).to(torch.bfloat16), (fr * s + fi * c).to(torch.bfloat16)


def conv_path(re3, im3, freq, operands, mode: int = 1):
    """Full-frame rotate, then the three products on the windows' strided
    view: (cr, ci) (f, n_sym, K) bf16."""
    wc, wcd, wdc = operands
    ar, ai = rotate_frames(re3, im3, freq, mode)
    m1 = torch.matmul(windows_view(ar + ai, mode), wc)
    m2 = torch.matmul(windows_view(ai, mode), wcd)
    m3 = torch.matmul(windows_view(ar, mode), wdc)
    return m1 - m2, m3 + m1


def production(re3, im3, freq, operands, mode: int = 1):
    """K5 + the three products: (cr, ci)."""
    return spectra_split(re3, im3, freq, operands, mode, WINDOW_OFFSET)


def trace_product(x: torch.Tensor, w: torch.Tensor) -> dict:
    """The ATen ops and the device kernels of one torch.matmul(x, w), from
    torch.profiler: {"ops": {name: calls}, "kernels": {name: device us},
    "copies": bool}. The ATen ops come from a trace of the host's
    activity; the kernels from traces of the card's alone, taken up to
    three times until one records device activity (in a process that has
    run other traces and collectives, one may record none: "kernels" is
    then empty, and "copies" rests on the ATen ops, the copy that a
    kernel would have made being an aten::copy_)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(activity):
        with profile(activities=[activity]) as prof:
            torch.matmul(x, w)
            if x.is_cuda:
                torch.cuda.synchronize()
        return prof.key_averages()

    torch.matmul(x, w)
    ops = {k.key: k.count for k in trace(ProfilerActivity.CPU) if k.key.startswith("aten::")}
    kernels = {}
    for _ in range(3 if x.is_cuda else 0):
        kernels = {k.key: k.self_device_time_total for k in trace(ProfilerActivity.CUDA)
                   if k.device_type == DeviceType.CUDA}
        if kernels:
            break
    copy_kernels = [k for k in kernels if "copy" in k.lower()]
    return {"ops": ops, "kernels": kernels,
            "copies": any(op in ops for op in COPY_OPS) or bool(copy_kernels)}


def main(argv=None) -> dict:
    """Run the tool at its shapes; returns run()'s result."""
    args = parse(argv, __doc__, iters=10)
    return run(args.device, args.iters)


def run(dev: torch.device, iters: int, f: int = 256) -> dict:
    """Both paths on f frames; returns {"ms": {"production", "conv",
    "rel_diff", "speedup", "view_product": trace_product's result},
    "checks": {"rel_diff": bool}}."""
    label = card(dev)
    ms = timer(dev)
    re3, im3 = gaussian_frames(f, dev)
    freq = torch.full((f,), FREQ_HZ, dtype=torch.float32, device=dev)
    ops = tuple(w.to(dev) for w in dft_operands(1))

    res = {"production": ms(lambda: production(re3, im3, freq, ops), iters)}
    print(f"{'production carve (K5) + matmul':<52} {res['production']:8.2f} ms  [{label}]",
          flush=True)
    res["conv"] = ms(lambda: conv_path(re3, im3, freq, ops), iters)
    print(f"{'full-frame rotate + products on the strided view':<52} {res['conv']:8.2f} ms  "
          f"[{label}]", flush=True)
    cr_p = production(re3, im3, freq, ops)[0].float()
    cr_c = conv_path(re3, im3, freq, ops)[0].float()
    res["rel_diff"] = float((cr_p - cr_c).abs().mean() / cr_p.abs().mean())
    res["speedup"] = res["production"] / res["conv"]
    print(f"mean|diff|/mean|ref| = {res['rel_diff']:.2e}")
    print(f"speedup: {res['speedup']:.2f}x")

    ar, _ = rotate_frames(re3, im3, freq)
    view = windows_view(ar)
    tr = trace_product(view, ops[2])
    res["view_product"] = tr
    print(f"torch.matmul on the (f, 76, 2048) view, strides {tuple(view.stride())}: "
          f"copies the windows first: {tr['copies']}")
    print("  ATen ops: " + ", ".join(f"{k} x{v}" for k, v in sorted(tr["ops"].items())))
    for name, us in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
        print(f"  kernel {us / 1e3:8.3f} ms  {name[:100]}  [{label}]")
    if view.is_cuda and not tr["kernels"]:
        print("  kernels: not recorded (three traces of the card held no device activity)")
    return {"ms": res, "checks": {"rel_diff": res["rel_diff"] <= REL_DIFF_MAX}}


if __name__ == "__main__":
    main()

"""carve_roofline: 100 x the bound of a step's K5 work
(csrc/carve.cu::carve_kernel: the FFT windows of every frame carved out
of the bf16 IQ, rotated by the CFO and written as bf16 re, im and their
sum) / the kernel's device time a step in the profiler's trace.

The bound (chip_smoke.py's carve_bound with three outputs): bytes, the re
and im samples of the windows read once (E F x 76 symbols x 2048, bf16;
the null symbol and the guards are never read), the f32 rotator tables
(E F x (76 + 2048) x 2) and three bf16 windows written; operations, 13 a
window sample (the rotator by angle addition 6, the rotation 6, the sum
1). The peak is benchmark/peaks.py's."""

from benchmark.peaks import bound_s
from benchmark.trace import kernel_seconds
from benchmark.synth.ofdm_params import get_ofdm_params

IQ_BYTES = 2            # bf16
OPS_PER_SAMPLE = 13


def step_bound_s(mode: int, n_frames_total: int) -> float:
    p = get_ofdm_params(mode)
    n = n_frames_total * p.nb_symbols * p.nb_fft
    tables = n_frames_total * (p.nb_symbols + p.nb_fft) * 2 * 4
    return bound_s(2 * n * IQ_BYTES + tables + 3 * n * 2, n * OPS_PER_SAMPLE)


def read(r):
    s = r.get("trace")
    if not s:
        return None
    sec, n = kernel_seconds(s, "carve_kernel")
    if sec <= 0:
        return None
    tr = r["cell"].traffic
    bound = step_bound_s(r["cell"].config["mode"], tr["n_ensembles"] * tr["n_frames"])
    return 100.0 * bound / (sec / r["steps"])

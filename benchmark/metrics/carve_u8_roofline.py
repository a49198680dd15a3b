"""carve_u8_roofline: 100 x the bound of a step's K5 work on rtl_sdr's raw
IQ (csrc/carve.cu::carve_kernel<unsigned char>: the FFT windows of every
frame carved out of the interleaved u8 I/Q, converted to f32, rotated by
the CFO and written as bf16 re, im and their sum) / that kernel's device
time a step in the profiler's trace.

The bound: bytes, the I and Q bytes of the windows read once (E F x 76
symbols x 2048 samples x 2 B; the null symbol and the guards are never
read), the f32 rotator tables (E F x (76 + 2048) x 2 x 4 B) and three bf16
windows written; operations, 17 a window sample (carve_roofline's 13, and
the conversion's subtract and multiply of I and of Q). The peak is
benchmark/peaks.py's."""

from benchmark.peaks import bound_s
from benchmark.trace import kernel_seconds
from benchmark.synth.ofdm_params import get_ofdm_params

IQ_BYTES = 2            # one byte of I and one of Q
OPS_PER_SAMPLE = 17
KERNEL = "carve_kernel<unsigned char>"


def step_bytes_ops(mode: int, n_frames_total: int):
    p = get_ofdm_params(mode)
    n = n_frames_total * p.nb_symbols * p.nb_fft
    tables = n_frames_total * (p.nb_symbols + p.nb_fft) * 2 * 4
    return n * IQ_BYTES + tables + 3 * n * 2, n * OPS_PER_SAMPLE


def step_bound_s(mode: int, n_frames_total: int) -> float:
    return bound_s(*step_bytes_ops(mode, n_frames_total))


def read(r):
    s = r.get("trace")
    if not s:
        return None
    sec, _ = kernel_seconds(s, KERNEL)
    if sec <= 0:
        return None
    tr = r["cell"].traffic
    bound = step_bound_s(r["cell"].config["mode"], tr["n_ensembles"] * tr["n_frames"])
    return 100.0 * bound / (sec / r["steps"])

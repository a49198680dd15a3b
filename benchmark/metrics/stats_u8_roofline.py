"""stats_u8_roofline: 100 x the bound of a step's stats_kernel work on
rtl_sdr's raw IQ (csrc/demod_tail.cu::stats_kernel<unsigned char>: each
frame's mean power from its interleaved u8 I/Q, converted to f32, and the
last frame's 480-point constellation tap from the DFT products) / that
kernel's device time a step in the profiler's trace.

The bound: bytes, the frames read once (E F x frame_len x 2 B), the
products the tap reads (480 points x 2 symbols x 3 products x 2 B, bf16)
and what it writes (E F mean powers and 2 x 480 tap values, f32);
operations, 8 a sample (the conversion's 4, the square sum's 3 and the
running sum's 1). The peak is benchmark/peaks.py's."""

from benchmark.peaks import bound_s
from benchmark.trace import kernel_seconds
from benchmark.synth.ofdm_params import get_ofdm_params

IQ_BYTES = 2
OPS_PER_SAMPLE = 8
N_TAP = 480
KERNEL = "stats_kernel<unsigned char>"


def step_bytes_ops(mode: int, n_frames_total: int):
    n = n_frames_total * get_ofdm_params(mode).nb_frame_length
    tap = N_TAP * 2 * 3 * 2 + 2 * N_TAP * 4
    return n * IQ_BYTES + tap + n_frames_total * 4, n * OPS_PER_SAMPLE


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

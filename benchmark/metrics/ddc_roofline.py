"""ddc_roofline: 100 x the bound of a step's channeliser work
(csrc/channelise.cu::channelise_kernel: each receiver's s8 I/Q mixed to its
blocks, filtered by the taps and decimated, written as the ensembles' bf16
frames) / the channeliser kernels' device time a step in the profiler's
trace.

The bound: bytes, the s8 wideband samples read once (R receivers x N new
samples x 2 B), the carried tail (T = decimation x frame_len + taps - 1
samples a receiver) read once and written once, and the bf16 frames
written once (E ensembles x F x frame_len x re and im x 2 B): 629,147,504
B at 4 receivers, 32 ensembles and 16 frames; operations, 8 flop (a
complex sample times a complex tap) x taps a complex output, 96.6 GFLOP
there. Against HBM's 3.35e12 B/s (benchmark/peaks.py) and the dense
f16/bf16 tensor-core peak, 989.4e12 flop/s (NVIDIA's H100 SXM data sheet,
700 W): the largest rate the card offers for any unit the kernel may use,
so the share cannot pass 100%. Where the trace holds no channeliser
kernel, nothing to read."""

from benchmark.peaks import HBM_BYTES_PER_S
from benchmark.synth.ofdm_params import get_ofdm_params
from benchmark.trace import kernel_seconds

TENSOR_FLOPS_PER_S = 989.4e12
KERNEL = "channelise_kernel"
IQ_BYTES = 2            # one s8 byte of I and one of Q
FRAME_BYTES = 4         # bf16 re and im
FLOP_PER_TAP = 8


def step_bytes_flops(mode: int, receivers: int, n_ensembles: int, n_frames: int,
                     decimation: int, taps: int):
    frame_len = get_ofdm_params(mode).nb_frame_length
    n_new = decimation * n_frames * frame_len
    n_tail = decimation * frame_len + taps - 1
    outputs = n_ensembles * n_frames * frame_len
    n_bytes = receivers * (n_new + 2 * n_tail) * IQ_BYTES + outputs * FRAME_BYTES
    return n_bytes, FLOP_PER_TAP * taps * outputs


def step_bound_s(*args) -> float:
    n_bytes, flops = step_bytes_flops(*args)
    return max(n_bytes / HBM_BYTES_PER_S, flops / TENSOR_FLOPS_PER_S)


def read(r):
    s = r.get("trace")
    if not s:
        return None
    sec, _ = kernel_seconds(s, KERNEL)
    if sec <= 0:
        return None
    cfg, tr = r["cell"].config, r["cell"].traffic
    bound = step_bound_s(cfg["mode"], tr["receivers"], tr["n_ensembles"], tr["n_frames"],
                         cfg["front_end"]["decimation"], cfg["channeliser"]["taps"])
    return 100.0 * bound / (sec / r["steps"])

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the roofline bound that the
kernels' per-layer metrics are shares of."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# 67 TFLOP/s of f32 FMA outside the tensor cores counts an FMA as 2, so
# 33.5e12 simple f32 lane operations a second (132 SMs x 128 lanes x
# 1.98 GHz). Not a published figure itself: derived from that one. It
# stands for every simple operation, integer ones too; the H100 has half
# as many INT32 lanes, so a bound of integer work against it is low and
# the share it gives is never too high.
ALU_OPS_PER_S = 33.5e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the HBM rate and the operations over the ALU rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S)

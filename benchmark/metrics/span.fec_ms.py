"""span.fec_ms: the program's `fec` span, ReceiveStep.decode_soft: the FEC
half (K4 mode (b) for the FIC and each subchannel, K1+K2 and the PRBS XOR
for the FIC and each coding group); summed over a step, on the card's
clock (the CUDA events the program records on the stream at the span's
edges), the median over the traced run's steps profiled on the card alone
(benchmark/spans.py)."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("fec",))

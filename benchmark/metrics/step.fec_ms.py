"""step.fec_ms: the median over the traced run's steps of
ReceiveStep.decode_soft on the demod's output (K4 mode (b) a FIC batch
and a subchannel, K1+K2 a coding group and the FIC, the PRBS XOR), from
the CUDA event after the demod to one after the call."""

import statistics


def read(r):
    ms = r.get("fec_ms")
    return statistics.median(ms) if ms and r.get("cuda") else None

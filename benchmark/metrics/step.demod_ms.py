"""step.demod_ms: the median over the traced run's steps of
ReceiveStep.demod (K5's carve and rotate, the three bf16 DFT products, the
differential demap and the normalisation), from a CUDA event before the
harness's call to one after it; the next half starts at that event."""

import statistics


def read(r):
    ms = r.get("demod_ms")
    return statistics.median(ms) if ms and r.get("cuda") else None

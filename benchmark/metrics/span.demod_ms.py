"""span.demod_ms: the program's `demod` span, ReceiveStep.demod: the demod
half (K5 and its tables, the three bf16 DFT products, the differential
demap, the normalisation, the tap and mean_power); summed over a step, on
the card's clock (the CUDA events the program records on the stream at the
span's edges), the median over the traced run's steps profiled on the card
alone (benchmark/spans.py)."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("demod",))

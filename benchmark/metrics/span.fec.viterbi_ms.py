"""span.fec.viterbi_ms: the program's `fec.viterbi` spans: K1+K2 and the PRBS
XOR, once for the FIC and once a coding group (items: codewords); summed
over a step, on the card's clock (the CUDA events the program records on
the stream at the span's edges), the median over the traced run's steps
profiled on the card alone (benchmark/spans.py)."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("fec.viterbi",))

"""span.fec.deint_ms: the program's two `fec.deint` spans a step: the FIC's
K4 launch, and msc_viterbi_inputs with one K4 launch a subchannel (items:
soft bits in); summed over a step, on the card's clock (the CUDA events
the program records on the stream at the span's edges), the median over
the traced run's steps profiled on the card alone (benchmark/spans.py)."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("fec.deint",))

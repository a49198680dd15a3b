"""span.demod.demap_ms: the program's `demod.demap` span: differential_demap;
summed over a step, on the card's clock (the CUDA events the program
records on the stream at the span's edges), the median over the traced
run's steps profiled on the card alone (benchmark/spans.py)."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("demod.demap",))

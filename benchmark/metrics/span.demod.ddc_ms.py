"""span.demod.ddc_ms: the program's `demod.ddc` span: the wideband
receivers' channeliser (ofdm/channelise.py, csrc/channelise.cu; items:
output samples); summed over a step, on the card's clock (the CUDA events
the program records on the stream at the span's edges), the median over
the traced run's steps profiled on the card alone (benchmark/spans.py).
A program without a channeliser records no such span: nothing to read."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("demod.ddc",))

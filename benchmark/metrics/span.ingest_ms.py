"""span.ingest_ms: the program's `ingest` span, HostFeed.feed's copy of
one step's raw u8 IQ from pinned host memory into a device buffer (items:
bytes), on the card's clock (the CUDA events the program records on the
feed's copy stream at the span's edges), the median over the traced run's
steps profiled on the card alone, each of which feeds the next step
(benchmark/spans.py)."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("ingest",))

"""span.enqueue_ms: the host's time inside the program's `demod` and `fec`
spans together (perf_counter_ns at their edges): how long the host takes
to put a step's work on the stream; summed over a step, on the host's
clock, the median over the traced run's steps profiled on the card alone
(benchmark/spans.py)."""

from benchmark.spans import median_ms


def read(r):
    return median_ms(r, ("demod", "fec"), "host_ms")

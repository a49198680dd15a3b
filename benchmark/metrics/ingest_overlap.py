"""ingest_overlap: 100 x the part of the pinned host-to-device copies'
device time during which a kernel ran / their device time, over the
traced run's stretch of steps profiled on the card alone (benchmark/h2d.py
reads the profiler's trace): whether each step's IQ copy runs under the
step before it, as HostFeed's copy stream means it to."""


def read(r):
    h = r.get("h2d")
    if not h or h["copy_s"] <= 0:
        return None
    return 100.0 * h["overlap_s"] / h["copy_s"]

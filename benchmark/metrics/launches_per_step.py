"""launches_per_step: the kernels the profiler saw on the device over the
traced run's stretch of steps profiled on the card alone, per step (the
program's and torch's alike; the harness's byte check of those steps runs
after the stretch; a count, read from the trace)."""


def read(r):
    s = r.get("trace")
    if not s or s["launches"] == 0:
        return None
    return s["launches"] / r["steps"]

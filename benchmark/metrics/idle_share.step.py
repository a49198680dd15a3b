"""idle_share.step: 100 x (1 - the device's busy time a step / the step's
time), the busy time the union of device activity (kernels, copies, sets)
over the traced run's stretch of steps profiled on the card alone, a
step's time the mean over the window's unprofiled steps of the time from
the call to the bytes on the host (CUDA events), both on the card's
clock. The profiler, even recording the card alone, lengthens a step by
its own work at each launch (4% in the traced runs: PERF.md), so the
traced stretch's own window would read that work as idle."""


def read(r):
    s = r.get("trace")
    if not s or s["busy_s"] <= 0 or not r.get("plain_step_ms"):
        return None
    return 100.0 * (1.0 - 1e3 * s["busy_s"] / r["steps"] / r["plain_step_ms"])

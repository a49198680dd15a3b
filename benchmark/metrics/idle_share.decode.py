"""idle_share.decode: 100 x (1 - the union of device activity (kernels,
copies, sets) / the traced window), over the traced run's profiled pass
of `decode`, from the call of the CLI to its return."""


def read(r):
    s = r.get("trace")
    if not s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])

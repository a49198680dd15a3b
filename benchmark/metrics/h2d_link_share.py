"""h2d_link_share: 100 x the u8 bytes a step copies (E x F x 2 x
frame_len, HostFeed's whole feed) / LINK_BYTES_PER_S / the pinned
host-to-device copies' device time a step, over the traced run's stretch
of steps profiled on the card alone, each of which feeds one step
(benchmark/h2d.py reads the profiler's trace): how near the copy comes to
the link's rate."""

from benchmark.synth.ofdm_params import get_ofdm_params

# PCIe Gen5 x16, one way: 32 GT/s x 16 lanes x 128/130 encoding / 8 bits
LINK_BYTES_PER_S = 63.0e9


def step_bytes(mode: int, n_ensembles: int, n_frames: int) -> int:
    return n_ensembles * n_frames * 2 * get_ofdm_params(mode).nb_frame_length


def share(n_bytes: float, seconds: float) -> float:
    """100 x n_bytes / LINK_BYTES_PER_S / seconds."""
    return 100.0 * n_bytes / LINK_BYTES_PER_S / seconds


def read(r):
    h = r.get("h2d")
    if not h or h["copy_s"] <= 0:
        return None
    tr = r["cell"].traffic
    n = step_bytes(r["cell"].config["mode"], tr["n_ensembles"], tr["n_frames"])
    return share(n, h["copy_s"] / r["steps"])

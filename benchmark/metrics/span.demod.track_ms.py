"""span.demod.track_ms: the device time of the program's `demod.track`
span, the tracker of a tracked stream (tpudab_torch/ofdm/track.py: every
frame's PRS matched filter, the last frame's CP autocorrelation and
whole-carrier check, the timing line and the state's update), inside
`demod`: the kernels, copies and sets launched inside the span, matched to
their launches by correlation id in the profiler's trace of the traced
run's host-recording stretch, summed a step, the median over its steps
(drivers/driftfed.py::track_kernel_ms). Traced steps run the chain
eagerly, so the span's own edges would time the host's enqueue of its
~200 launches; the kernels' own time is what a faster tracker moves. A
program without a tracker records no such span: nothing to read."""


def read(r):
    return r.get("track_kernel_ms")

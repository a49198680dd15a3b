"""The `hostfed` driver: the receive step fed rtl_sdr's raw u8 IQ from host
memory, E ensembles x F frames a step on one card.

Set-up makes the traffic's batch (benchmark/signal.py::monitor_signal) and
quantises it as the configuration's front end does (quantise: each
distinct ensemble scaled so that a rail's RMS is `rail_rms_lsb` LSB, then
offset by 127.5, rounded and clipped to 0..255, I and Q interleaved). The
u8 IQ lives in E host regions, one an ensemble (ensemble e holding the
distinct ensemble e % distinct), pinned on a card. tpudab_torch's
HostFeed (models/ingest.py) copies all of them to the card every step,
E x F x 2 x frame_len bytes, into one of its two device buffers on its
own copy stream; nothing stays on the card across steps. The step is
tpudab_torch's ReceiveStep, handed the feed (ReceiveStep.forward(carry,
feed, None, freq)): it waits on the card for the copy and reads the bytes
in K5 and stats_kernel. WARM_STEPS steps (each fed, run and read back)
warm every shape up.

The window is a closed loop one step of IQ ahead, as from a ring that the
dongles keep full: once step k - 1's bytes are on the host, step k + 1's
IQ is fed (HostFeed.feed: its copy enqueued, the host regions left as
they are) and step k enqueued behind it, so that the copy
runs under step k's kernels; then step k's bytes are copied to the host,
and so on. With --trace 1
the window calls the step's two halves instead (demod, then decode_soft on
its output), each bracketed by CUDA events, and profiles two stretches as
the step driver does (benchmark/drivers/step.py): TRACED_STEPS steps on
the card alone, each with its feed, then GAP_STEPS recording the host too.

Metrics: rtf_per_gpu, ensemble-seconds of signal decoded per second of
the window (host clock over the whole window, whose first feed is its
start); step_ms_p95, the 95th percentile over the window's steps of the
time from an event recorded on the copy stream just before the step's IQ
copy starts (under the step before) to its bytes on the host (the card's
clock); setup_s. The
per-layer metrics read, besides what the step driver reports, the copies
of the stretch on the card alone (benchmark/h2d.py) and, for
idle_share.step, the step's period: the mean time from one unprofiled
step's bytes on the host to the next's (a step's latency holds its copy,
which runs under the step before).

Correct: every step's bytes against the bytes transmitted, counted on the
card as in the step driver; HostFeed.bytes_copied equal to the steps fed
(warm-up and window) times a step's bytes (bytes_copied_gap 0: the IQ
repeats every step, so a feed that copied less would still decode); every
step's mean_power and constellation tap against the plain reference on
the same u8 IQ (benchmark/reference_u8.py), computed after the program's
state is freed.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import numpy as np
import torch

from benchmark import h2d, reference, reference_u8
from benchmark.harness import BENCH, judge, load_module, read_per_layer
from benchmark.signal import RAMP_CIFS, monitor_signal, signal_seconds, step_truth
from benchmark.synth.dab_params import get_dab_params
from benchmark.synth.ofdm_params import get_ofdm_params

WARM_STEPS = 2
TRACED_STEPS = 20
GAP_STEPS = 10
MARK = "bench.step"

_step = load_module(BENCH / "drivers" / "step.py")


def quantise(iq: np.ndarray, front_end: dict) -> np.ndarray:
    """(distinct, F, frame_len) complex IQ -> (distinct, F, frame_len, 2)
    uint8, each distinct ensemble at its own gain: a rail's RMS over the
    batch `rail_rms_lsb`, then + offset, rounded to the nearest integer
    and clipped to 0..255."""
    x = iq.reshape(iq.shape[0], -1)
    rail_rms = np.sqrt((np.abs(x.astype(np.complex128)) ** 2).mean(axis=1) / 2.0)
    gain = front_end["rail_rms_lsb"] / rail_rms
    out = np.empty(iq.shape + (2,), dtype=np.uint8)
    for d in range(iq.shape[0]):
        for j, part in enumerate((iq[d].real, iq[d].imag)):
            y = np.rint(part.astype(np.float64) * gain[d] + front_end["offset"])
            out[d, ..., j] = np.clip(y, 0, 255).astype(np.uint8)
    return out


def step_bytes(cell) -> int:
    """The u8 bytes of one step: E x F x 2 x frame_len."""
    tr = cell.traffic
    return tr["n_ensembles"] * tr["n_frames"] * 2 * \
        get_ofdm_params(cell.config["mode"]).nb_frame_length


def host_regions(u8: np.ndarray, e: int, pinned: bool):
    """E host regions, (F, frame_len, 2) uint8 each, region j holding the
    distinct ensemble j % distinct; pinned for the copy to overlap."""
    regions = []
    for j in range(e):
        r = torch.empty(u8.shape[1:], dtype=torch.uint8, pin_memory=pinned)
        r.copy_(torch.from_numpy(u8[j % u8.shape[0]]))
        regions.append(r)
    return regions


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    from tpudab_torch.models.ingest import HostFeed
    from tpudab_torch.models.step import ReceiveStep
    from tpudab_torch.ops import _build

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    mode = cfg["mode"]
    p, dab = get_ofdm_params(mode), get_dab_params(mode)
    e, f, d = tr["n_ensembles"], tr["n_frames"], tr["distinct"]
    c = f * dab.nb_cifs
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    sig = monitor_signal(cfg, tr, seed)
    u8 = quantise(sig.iq, cfg["front_end"])
    synth_s = time.perf_counter() - t0
    regions = host_regions(u8, e, cuda)
    ens = torch.arange(e) % d
    freq = torch.from_numpy(sig.cfo_hz)[ens].to(dev)
    shape = (e, f, p.nb_frame_length, 2) if e > 1 else (f, p.nb_frame_length, 2)
    if e == 1:
        freq = freq[0]
    feed = HostFeed(shape, dev)
    step = ReceiveStep(mode, _step.subchannel_configs(cfg), n_ensembles=e).to(dev)
    want = (torch.from_numpy(sig.fibs.reshape(d, f * dab.nb_fib_groups, -1)[ens.numpy()]).to(dev),
            {sid: torch.from_numpy(t).to(dev) for sid, t in step_truth(sig, e, c, 0).items()})
    clock = _step.Clock(dev)

    def feed_step():
        """Enqueue one step's IQ copy (the regions stay as they are); the
        mark just before the copy starts."""
        t = None if cuda else clock.mark()
        feed.feed(regions)
        return feed.started if cuda else t

    def call(carry, marks):
        if not trace:
            return step(carry, feed, None, freq)
        soft, stats = step.demod(feed, None, freq)
        marks.append(clock.mark())
        carry, fic, subch = step.decode_soft(carry, soft)
        marks.append(clock.mark())
        return carry, {"fic_bytes": fic, "subch": subch, "mean_power": stats["mean_power"],
                       "const_re": stats["const_re"], "const_im": stats["const_im"]}

    t0 = time.perf_counter()
    carry = step.init_carry(dev)
    for i in range(WARM_STEPS):
        feed_step()
        carry, out = call(carry, [])
        if i:
            _step.wrong_bytes(out, want, 0)
        _step.to_host(out)
        if i == 0:
            first_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    del out

    # the window: at least one step past the ramp, whose rows are all due
    min_steps = RAMP_CIFS // c + 2
    stretches = [("device", TRACED_STEPS), ("host", GAP_STEPS)] if trace else []
    wrongs, taps, spans, kinds, held, traces = [], [], [], [], [], {}
    prof, kind, left = None, "plain", 0
    carry = step.init_carry(dev)
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    start = feed_step()
    k = 0
    while True:
        if prof is None and stretches and time.perf_counter() - t_win >= 0.4 * seconds:
            kind, left = stretches.pop(0)
            prof = _step.start_profiler(cuda, host=kind == "host")
        last = time.perf_counter() - t_win >= seconds and k + 1 >= min_steps \
            and not stretches and (prof is None or left == 1)
        lo = max(0, RAMP_CIFS - k * c)
        with torch.profiler.record_function(MARK) if prof is not None \
                else contextlib.nullcontext():
            if not last:
                after = feed_step()        # step k + 1's IQ, copied under step k's kernels
            marks = [start, clock.mark()]
            carry, out = call(carry, marks)
            k += 1
            if prof is not None:
                left -= 1
            if prof is None:
                wrongs.append(_step.wrong_bytes(out, want, lo))
            else:
                held.append((out, lo))
            _step.to_host(out)
        marks.append(clock.mark())
        spans.append(marks)
        kinds.append(kind)
        taps.append((out["mean_power"], out["const_re"], out["const_im"]))
        del out
        if prof is not None and left == 0:
            traces[kind] = _step.stop_profiler(prof)
            prof, kind = None, "plain"
            wrongs += [_step.wrong_bytes(o, want, lo_) for o, lo_ in held]
            held = []
        if last:
            break
        start = after
    wall = time.perf_counter() - t_win
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    step_ms = [clock.ms(m[0], m[-1]) for m in spans]
    periods = [clock.ms(a[-1], b[-1]) for a, b, ka, kb in
               zip(spans, spans[1:], kinds, kinds[1:]) if ka == kb == "plain"]
    halves = ([clock.ms(m[1], m[2]) for m in spans], [clock.ms(m[2], m[3]) for m in spans]) \
        if trace else None
    per_step = torch.stack(wrongs).cpu().numpy()
    mp = torch.stack([t[0] for t in taps]).cpu().numpy()
    tap = torch.stack([torch.stack([t[1], t[2]]) for t in taps]).cpu().numpy()
    bytes_copied, due = feed.bytes_copied, (WARM_STEPS + k) * step_bytes(cell)
    del taps, wrongs, carry, step, freq, want, feed, regions
    if cuda:
        torch.cuda.empty_cache()

    # the check, after the window: the steps' counts of wrong bytes, the
    # bytes the feed copied, the demod's outputs against the plain reference
    iq = torch.from_numpy(u8)
    ref_mp = reference_u8.mean_power(iq).reshape(d, f)[ens].reshape(-1).numpy()
    last_ens = (e - 1) % d
    ref_tap = reference_u8.const_tap(iq[last_ens, f - 1], float(sig.cfo_hz[last_ens]),
                                     mode).numpy()
    limits = cell.limits
    checks = {
        "bytes_wrong": (int(per_step.sum()), limits["bytes_wrong"]),
        "bytes_copied_gap": (abs(bytes_copied - due), limits["bytes_copied_gap"]),
        "mean_power_gap": (max(reference.mean_power_gap(m, ref_mp) for m in mp),
                           limits["mean_power_gap"]),
        "const_rms_gap": (max(reference.const_rms_gap(t, ref_tap) for t in tap),
                          limits["const_rms_gap"]),
    }
    failed = int(np.count_nonzero(per_step))
    result = {"correct": judge(checks) and failed == 0 and per_step.size == k,
              "attempted": k, "failed": failed,
              "device": {"memory_peak_bytes": int(peak)},
              "setup_parts": {"synth_s": synth_s, "first_step_s": first_s,
                              "build_s": _build.BuildInfo.seconds},
              "steps_checked": int(per_step.size), "bytes_copied": bytes_copied,
              "step_ms_median": {kd: statistics.median(ms for ms, kk in zip(step_ms, kinds)
                                                       if kk == kd) for kd in sorted(set(kinds))}}
    if trace:
        from benchmark import trace as tracing

        summary = {kd: tracing.summarize(path, None if kd == "device" else MARK)
                   for kd, path in traces.items()}
        readings = {"cell": cell, "demod_ms": halves[0], "fec_ms": halves[1],
                    "trace": summary["device"], "steps": TRACED_STEPS, "cuda": cuda,
                    "h2d": h2d.summarize(traces["device"]),
                    "plain_step_ms": statistics.mean(periods) if cuda and periods else None}
        result["metrics"] = read_per_layer(cell, readings)
        if summary["device"] is not None:
            result["device"].update(busy_s=summary["device"]["busy_s"],
                                    window_s=summary["device"]["window_s"])
        result["breakdown"] = {
            "device_ops": summary["device"]["device_ops"] if summary["device"] else [],
            "idle_gaps": summary["host"]["idle_gaps"]}
        for path in traces.values():
            os.unlink(path)
    else:
        sig_s = signal_seconds(mode, f) * e
        result["metrics"] = {
            "rtf_per_gpu": {"value": k * sig_s / wall, "unit": "x_realtime"},
            "step_ms_p95": {"value": float(np.percentile(step_ms, 95)), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    return result, checks


def control(cell, seed: int) -> dict:
    """The control's readings on the cell's inputs for `seed`: the
    reference in float8 (reference_u8.py) put in the program's place, its
    mean powers and tap held to the float64 reference as the program's
    are. The bytes have no control: they are compared exactly."""
    cfg, tr = cell.config, cell.traffic
    e, f, d = tr["n_ensembles"], tr["n_frames"], tr["distinct"]
    sig = monitor_signal(cfg, tr, seed)
    iq = torch.from_numpy(quantise(sig.iq, cfg["front_end"]))
    last = (e - 1) % d
    tap = [reference_u8.const_tap(iq[last, f - 1], float(sig.cfo_hz[last]), cfg["mode"],
                                  precision).numpy() for precision in ("f64", "fp8")]
    return {"mean_power_gap": reference.mean_power_gap(
                reference_u8.mean_power(iq, "fp8").numpy().ravel(),
                reference_u8.mean_power(iq).numpy().ravel()),
            "const_rms_gap": reference.const_rms_gap(tap[1], tap[0])}

"""The `step` driver: a monitoring site's receive step, E ensembles x F
frames a step on one card.

Set-up makes the traffic's batch (benchmark/signal.py::monitor_signal),
puts it on the card as bf16 IQ tiled to E ensembles (ensemble e is the
distinct ensemble e % distinct), builds tpudab_torch's ReceiveStep for the
configuration, copies the bytes every step should decode to onto the card
and runs WARM_STEPS steps. The window starts from the step's zero carry
and calls ReceiveStep.__call__ on the batch until --seconds have passed,
each step's FIC and subchannel bytes copied to the host as
StepDriver.process does. With --trace 1 the window calls the step's two
halves instead, demod and then decode_soft on its output (the work
forward does), each bracketed by CUDA events; a middle stretch of
TRACED_STEPS steps runs under torch.profiler recording the card alone
(the device's busy time, kernel times and launches, and the breakdown's
device operations), and the next
GAP_STEPS steps under a profiler that records the host's operations too
(the breakdown's idle gaps by what the host was doing).

Metrics: rtf_per_gpu, ensemble-seconds of signal decoded per second of
the window (host clock over the whole window); step_ms_p95, the 95th
percentile over the window's steps of the time from a step's call to its
bytes on the host (CUDA events, the card's clock); setup_s.

Correct: every step's bytes are held to the bytes transmitted on the card
(every FIC byte; every subchannel byte of every row due, which is each
row but the first step's 15 ramp rows), as a count per step that is read
after the window (the profiled steps' outputs are kept and compared once
their profiler has stopped, so that no trace holds the check); every
step's mean_power and constellation tap are held to the plain reference
(benchmark/reference.py) on the same bf16 IQ, computed after the
program's state is freed.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time

import numpy as np
import torch

from benchmark import reference
from benchmark.harness import judge, read_per_layer
from benchmark.signal import RAMP_CIFS, monitor_signal, signal_seconds, step_truth
from benchmark.synth.dab_params import get_dab_params
from benchmark.synth.ofdm_params import get_ofdm_params

WARM_STEPS = 2
TRACED_STEPS = 20
GAP_STEPS = 10
MARK = "bench.step"


def subchannel_configs(config: dict):
    """The configuration's subchannels as the program's SubchannelConfig."""
    from tpudab_torch.constants.puncture import eep_profile, get_uep_profile
    from tpudab_torch.msc.subchannel import SubchannelConfig

    out = []
    for s in config["subchannels"]:
        kind, a, b = s["protection"]
        if kind == "eep":
            out.append(SubchannelConfig(s["id"], s["start_cu"], s["size_cu"],
                                        eep_profile(s["size_cu"], a, b)))
        else:
            u = get_uep_profile(a, b)
            out.append(SubchannelConfig(s["id"], s["start_cu"], u.size_cu, u.to_profile(),
                                        u.padding_bits, uep_key=(a, b)))
    return tuple(out)


class Clock:
    """Marks on the card's clock (CUDA events), or the host's on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def to_host(out: dict):
    """A step's bytes on the host, as StepDriver.process copies them."""
    return (out["fic_bytes"].cpu().numpy(),
            {k: v.cpu().numpy() for k, v in out["subch"].items()})


def wrong_bytes(out: dict, want, lo: int) -> torch.Tensor:
    """The count, on the card, of a step's bytes that differ from want =
    (FIC bytes, {subch id: bytes}), the subchannels' rows before lo not yet
    due."""
    fic, sub = want
    n = (out["fic_bytes"].reshape(fic.shape) != fic).sum()
    for sid, t in sub.items():
        n = n + (out["subch"][sid].reshape(t.shape)[:, lo:] != t[:, lo:]).sum()
    return n


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
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
    synth_s = time.perf_counter() - t0
    rows = p.nb_frame_length // 128
    host_re = torch.from_numpy(np.ascontiguousarray(sig.iq.real)).to(torch.bfloat16)
    host_im = torch.from_numpy(np.ascontiguousarray(sig.iq.imag)).to(torch.bfloat16)
    ens = torch.arange(e) % d
    re = host_re.to(dev)[ens.to(dev)].reshape(e, f, rows, 128).contiguous()
    im = host_im.to(dev)[ens.to(dev)].reshape(e, f, rows, 128).contiguous()
    freq = torch.from_numpy(sig.cfo_hz)[ens].to(dev)
    if e == 1:
        re, im, freq = re[0], im[0], freq[0]
    step = ReceiveStep(mode, subchannel_configs(cfg), n_ensembles=e).to(dev)
    # what every step decodes to, the payload being periodic in a step
    want = (torch.from_numpy(sig.fibs.reshape(d, f * dab.nb_fib_groups, -1)[ens.numpy()]).to(dev),
            {sid: torch.from_numpy(t).to(dev) for sid, t in step_truth(sig, e, c, 0).items()})

    def call(carry, clock=None, marks=None):
        if not trace:
            return step(carry, re, im, freq)
        soft, stats = step.demod(re, im, freq)
        marks.append(clock.mark())
        carry, fic, subch = step.decode_soft(carry, soft)
        marks.append(clock.mark())
        return carry, {"fic_bytes": fic, "subch": subch, "mean_power": stats["mean_power"],
                       "const_re": stats["const_re"], "const_im": stats["const_im"]}

    clock = Clock(dev)
    t0 = time.perf_counter()
    carry = step.init_carry(dev)
    carry, out = call(carry, clock, [])
    to_host(out)
    first_s = time.perf_counter() - t0
    for _ in range(WARM_STEPS - 1):
        carry, out = call(carry, clock, [])
        wrong_bytes(out, want, 0)
        to_host(out)
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
    k = 0
    while True:
        if prof is None and stretches and time.perf_counter() - t_win >= 0.4 * seconds:
            kind, left = stretches.pop(0)
            prof = start_profiler(cuda, host=kind == "host")
        marks = [clock.mark()]
        lo = max(0, RAMP_CIFS - k * c)
        if prof is None:
            carry, out = call(carry, clock, marks)
            wrongs.append(wrong_bytes(out, want, lo))
            to_host(out)
        else:
            with torch.profiler.record_function(MARK):
                carry, out = call(carry, clock, marks)
                to_host(out)
            held.append((out, lo))
        marks.append(clock.mark())
        spans.append(marks)
        kinds.append(kind)
        taps.append((out["mean_power"], out["const_re"], out["const_im"]))
        del out
        k += 1
        if prof is not None:
            left -= 1
            if left == 0:
                traces[kind] = stop_profiler(prof)
                prof, kind = None, "plain"
                wrongs += [wrong_bytes(o, want, lo) for o, lo in held]
                held = []
        if time.perf_counter() - t_win >= seconds and k >= min_steps \
                and prof is None and not stretches:
            break
    wall = time.perf_counter() - t_win
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    step_ms = [clock.ms(m[0], m[-1]) for m in spans]
    halves = ([clock.ms(m[0], m[1]) for m in spans], [clock.ms(m[1], m[2]) for m in spans]) \
        if trace else None
    per_step = torch.stack(wrongs).cpu().numpy()
    mp = torch.stack([t[0] for t in taps]).cpu().numpy()
    tap = torch.stack([torch.stack([t[1], t[2]]) for t in taps]).cpu().numpy()
    del taps, wrongs, carry, step, re, im, freq, want
    if cuda:
        torch.cuda.empty_cache()

    # the check, after the window: the steps' counts of wrong bytes, the
    # demod's outputs against the plain reference
    ref_mp = reference.mean_power(host_re, host_im).reshape(d * f)
    ref_mp = ref_mp.reshape(d, f)[ens].reshape(-1).numpy()
    last = (e - 1) % d
    ref_tap = reference.const_tap(host_re[last, f - 1], host_im[last, f - 1],
                                  float(sig.cfo_hz[last]), mode).numpy()
    checks = {
        "bytes_wrong": (int(per_step.sum()), cell.limits["bytes_wrong"]),
        "mean_power_gap": (max(reference.mean_power_gap(m, ref_mp) for m in mp),
                           cell.limits["mean_power_gap"]),
        "const_rms_gap": (max(reference.const_rms_gap(t, ref_tap) for t in tap),
                          cell.limits["const_rms_gap"]),
    }
    failed = int(np.count_nonzero(per_step))
    result = {"correct": judge(checks) and failed == 0 and per_step.size == k,
              "attempted": k, "failed": failed,
              "device": {"memory_peak_bytes": int(peak)},
              "setup_parts": {"synth_s": synth_s, "first_step_s": first_s,
                              "build_s": _build.BuildInfo.seconds},
              "steps_checked": int(per_step.size),
              "step_ms_median": {kd: statistics.median(ms for ms, kk in zip(step_ms, kinds)
                                                       if kk == kd) for kd in sorted(set(kinds))}}
    if trace:
        from benchmark import trace as tracing

        summary = {kd: tracing.summarize(path, None if kd == "device" else MARK)
                   for kd, path in traces.items()}
        plain = [ms for ms, kd in zip(step_ms, kinds) if kd == "plain"]
        readings = {"cell": cell, "demod_ms": halves[0], "fec_ms": halves[1],
                    "trace": summary["device"], "steps": TRACED_STEPS, "cuda": cuda,
                    "plain_step_ms": statistics.mean(plain) if cuda and plain else None}
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


def start_profiler(cuda: bool, host: bool):
    """A started torch.profiler recording the card's activity, and with
    host=True (or on the CPU) the host's operations as well."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if cuda else []) + \
        ([ProfilerActivity.CPU] if host or not cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(prof) -> str:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def control(cell, seed: int) -> dict:
    """The control's readings on the cell's inputs for `seed`: the
    reference in float8 (reference.py) put in the program's place, its
    mean powers and tap held to the float64 reference as the program's
    are. The bytes have no control: they are compared exactly."""
    cfg, tr = cell.config, cell.traffic
    e, f, d = tr["n_ensembles"], tr["n_frames"], tr["distinct"]
    sig = monitor_signal(cfg, tr, seed)
    re = torch.from_numpy(np.ascontiguousarray(sig.iq.real)).to(torch.bfloat16)
    im = torch.from_numpy(np.ascontiguousarray(sig.iq.imag)).to(torch.bfloat16)
    last = (e - 1) % d
    tap = [reference.const_tap(re[last, f - 1], im[last, f - 1], float(sig.cfo_hz[last]),
                               cfg["mode"], precision).numpy() for precision in ("f64", "fp8")]
    return {"mean_power_gap": reference.mean_power_gap(
                reference.mean_power(re, im, "fp8").numpy().ravel(),
                reference.mean_power(re, im).numpy().ravel()),
            "const_rms_gap": reference.const_rms_gap(tap[1], tap[0])}

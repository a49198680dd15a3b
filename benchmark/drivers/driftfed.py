"""The `driftfed` driver: the receive step tracking free-running rtl_sdr
dongles' streams, E dongles (one ensemble each) x F frames a step on one
card, fed from host memory at each dongle's read pointer.

Set-up makes the streams (drift_streams): the `distinct` ensembles of
benchmark/signal.py::monitor_signal with the echo but neither noise nor
CFO, each one step of F frames, periodic; dongle e takes distinct ensemble
e % distinct, a crystal error ppm_e = m_e / (F frame_len) (m_e whole, drawn
within the front end's clock_ppm_max by the seed) and a Band III block (a
seeded order of the configuration's blocks). Its step of air, N = F
frame_len samples at the transmitter's clock, is N + m_e samples at the
dongle's: the periodic signal's Fourier series evaluated there (the
spectrum of N bins laid into N + m_e, zeros or the outermost bins at the
Nyquist edge, where the band-limited signal holds nothing), then its CFO,
q_e whole cycles a period (-ppm_e x the block's centre, to 1/1.536 Hz),
AWGN at the traffic's SNR and quantisation to u8 as rtl6's front end
(hostfed.py's quantise: a rail's RMS rail_rms_lsb LSB). On the card with
torch.fft, in float64. Each stream lives in a pinned host ring of N + m_e
+ L pairs, its first L repeated past its end, L the step's segment length
(Tracker.segment_len), so that any read pointer reads a whole segment.

Set-up of the program: each read pointer starts lead_e pairs (seeded,
below a frame) before a period's frame 0; the tracker's acquire() over
every segment at once says how far to move each pointer, its train() on
the segments read there gives the first state and the first step's
count. WARM_STEPS steps (each fed, run and read back) warm every shape up;
the window continues their stream and their tracker state, and starts the
time deinterleaver afresh.

The window is hostfed's closed loop one step of IQ ahead: once step
k - 1's outputs are on the host, step k + 1's segments are fed (HostFeed
.feed(rings, pointers): its copy enqueued) and step k enqueued behind it.
The read pointers follow the step's reports: step k + 1's pointer is step
k's moved by step k - 1's consumed count (the first by train's). A step's
bytes, consumed counts and locks come to the host as Readback copies them:
into pinned buffers, then one wait. With --trace 1 the window calls the
step's halves (demod_stream, then decode_soft) and profiles the two
stretches as hostfed does.

No truth after set-up: the synthesis's ppm, CFO and frame positions are
held in a Sealed box that the window cannot open; the step is handed
neither a CFO nor a frame start (ReceiveStep refuses them in a tracked
stream).

Metrics: rtf_per_gpu, step_ms_p95 and setup_s as hostfed's (the air-time
a step, E x F frames, unchanged; a step's latency from its copy's start
to its bytes on the host). With --trace 1, span.demod.track_ms reads the
device time of the kernels launched inside the tracker's span in the
host-recording stretch's trace (track_kernel_ms).

Correct: every step's bytes against the bytes sent (bytes_wrong: the
stream repeats each period, so frame 0 of every step is the period's
frame 0); HostFeed.bytes_copied against the steps fed x E x L x 2
(bytes_copied_gap); the summed consumed counts of each dongle against
the steps x (N + m_e) (consumed_gap: every sample of the stream consumed
once); at the window's last step the tracker's next frame 0 against the
period's (timing_gap_samples), its rate against 1 + ppm (ppm_gap, in
ppm) and its CFO against the stream's, in the dongle's Hz (freq_gap_hz);
the ensembles that lost lock (lock_lost); and every frame's mean_power
and the tap of two steps (the window's first and its last) against
benchmark/reference_track.py run on the same segments from the
program's state before the step (mean_power_gap, const_rms_gap).

Controls (run(..., control=...), for the calibration and the tests):
"frozen", the tracker held after acquisition (no training: the rate 1,
each step moved by that prediction); "true_cfo", held as well but handed
the synthesis's CFO; "cfo_held", a CFO error of PLANT_HZ (one carrier
and 0.3 of one) planted in the state after set-up, the timing tracked
and the CFO held where it is; "skip", the host's pointers skipping one
sample once, at the window's first feed. Each has to come out as not
correct. run(..., plant_hz=PLANT_HZ) plants the same error with the
tracker whole: its CFO loop has to take it out within the warm-up steps
and the run come out correct.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import statistics
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark import h2d, reference, reference_track, reference_u8
from benchmark.harness import BENCH, judge, load_module, read_per_layer
from benchmark.signal import RAMP_CIFS, monitor_signal, seed_rng, signal_seconds, step_truth
from benchmark.synth.dab_params import get_dab_params
from benchmark.synth.ofdm_params import SAMPLING_RATE, get_ofdm_params

WARM_STEPS = 2
TRACED_STEPS = 20
GAP_STEPS = 10
MARK = "bench.step"
CONTROLS = ("frozen", "true_cfo", "cfo_held", "skip")
PLANT_HZ = 1300.0       # a CFO error planted after set-up: one carrier and 0.3 of one
LEAD_MIN = 4096         # a read pointer starts at least this far before frame 0

_step = load_module(BENCH / "drivers" / "step.py")


class Sealed:
    """The synthesis's truth, closed while the program runs: open() raises
    until run() has put it in the phase "check"."""

    def __init__(self, **truth):
        self._truth = truth
        self.phase = "setup"

    def open(self) -> dict:
        if self.phase != "check":
            raise RuntimeError(f"the truth read in phase {self.phase!r}")
        return self._truth


class DriftStreams(NamedTuple):
    rings: List[torch.Tensor]      # E (N + m_e + L, 2) uint8, pinned on a card
    lead: np.ndarray               # (E,) pairs before a period's frame 0 where reading starts
    truth: Sealed                  # ppm, m, period, cfo_hz (the dongle's Hz), block
    sig: object                    # the monitor signal: payloads and FIBs, for the bytes


def drift_streams(cfg: dict, tr: dict, seed: int, device, segment_len: int,
                  m=None) -> DriftStreams:
    """The E dongles' streams (see the module's docstring); m, if given,
    each dongle's clock excess in samples a period in place of the seed's."""
    mode = cfg["mode"]
    fe = cfg["front_end"]
    e, f, d = tr["n_ensembles"], tr["n_frames"], tr["distinct"]
    n = f * get_ofdm_params(mode).nb_frame_length
    clean = monitor_signal(cfg, {**tr, "snr_db": 300.0, "cfo_hz_max": 0.0}, seed)
    rng = seed_rng(seed, 1 << 20)
    m_max = int(np.floor(fe["clock_ppm_max"] * 1e-6 * n))
    m = rng.integers(-m_max, m_max + 1, e) if m is None else np.asarray(m, np.int64)
    block = rng.permutation(len(fe["blocks"]))[np.arange(e) % len(fe["blocks"])]
    centre_hz = np.array(fe["block_mhz"])[block] * 1e6
    q = np.rint(-(m / n) * centre_hz * n / SAMPLING_RATE).astype(np.int64)
    lead = rng.integers(LEAD_MIN, tr["lead_max"], e)
    noise_seeds = rng.integers(2 ** 31, size=e)
    dev = torch.device(device)
    spectra = torch.fft.fft(torch.from_numpy(clean.iq.reshape(d, n)).to(dev, torch.complex128))
    cuda = dev.type == "cuda"
    rings = []
    for j in range(e):
        period = n + int(m[j])
        x = spectra[j % d]
        half = n // 2
        if m[j] >= 0:
            y = torch.cat([x[:half], x.new_zeros(int(m[j])), x[half:]])
        else:
            cut = -int(m[j])
            y = torch.cat([x[:half - (cut + 1) // 2], x[half + cut // 2:]])
        z = torch.fft.ifft(y) * (period / n)
        k = torch.arange(period, device=dev, dtype=torch.int64)
        z = z * torch.exp(2j * np.pi * ((int(q[j]) * k) % period).double() / period)
        sigma = torch.sqrt((z.abs() ** 2).mean() / 10.0 ** (tr["snr_db"] / 10.0) / 2.0)
        g = torch.Generator(dev).manual_seed(int(noise_seeds[j]))
        z = z + sigma * torch.complex(torch.randn(period, generator=g, device=dev,
                                                  dtype=torch.float64),
                                      torch.randn(period, generator=g, device=dev,
                                                  dtype=torch.float64))
        gain = fe["rail_rms_lsb"] / torch.sqrt((z.abs() ** 2).mean() / 2.0)
        u8 = torch.stack([z.real, z.imag], dim=-1).mul(gain).add(fe["offset"]).round()
        u8 = u8.clamp(0, 255).to(torch.uint8)
        ring = torch.empty((period + segment_len, 2), dtype=torch.uint8, pin_memory=cuda)
        ring.copy_(u8[torch.arange(period + segment_len, device=dev) % period])
        rings.append(ring)
        del x, y, z, u8, k
    truth = Sealed(ppm=m / n * 1e6, m=m, period=n + m, block=block,
                   cfo_hz=q * SAMPLING_RATE / (n + m))
    return DriftStreams(rings, lead, truth, clean)


class Pointers:
    """The dongles' read pointers, one step ahead of the step's reports:
    take() gives the pointers of the next step to feed, having moved them
    by the oldest count not yet spent (train's first, then each step's,
    report() in order)."""

    def __init__(self, start: np.ndarray, period: np.ndarray):
        self.p = start % period
        self.period = period
        self.owed = collections.deque()
        self.first = True

    def report(self, consumed: np.ndarray) -> None:
        self.owed.append(np.asarray(consumed, np.int64))

    def take(self) -> np.ndarray:
        if not self.first:
            self.p = (self.p + self.owed.popleft()) % self.period
        self.first = False
        return self.p.copy()

    def next(self) -> np.ndarray:
        """The pointers of the step after the last taken, as take() will
        give them (the oldest count owed spent)."""
        return (self.p + self.owed[0]) % self.period


class Readback:
    """A step's bytes, consumed counts and locks on the host: each output
    copied into a pinned buffer of its own without blocking, then one wait
    on the card (widefed.py's Readback, with the tracker's outputs)."""

    def __init__(self):
        self.buffers = {}

    def __call__(self, out: dict) -> Dict[str, np.ndarray]:
        parts = [("fic", out["fic_bytes"]), ("consumed", out["consumed"]),
                 ("locked", out["locked"])] + [(f"subch{k}", v) for k, v in out["subch"].items()]
        host = {}
        for key, t in parts:
            buf = self.buffers.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self.buffers[key] = torch.empty(t.shape, dtype=t.dtype,
                                                      pin_memory=t.is_cuda)
            buf.copy_(t, non_blocking=True)
            host[key] = buf
        if out["fic_bytes"].is_cuda:
            torch.cuda.current_stream(out["fic_bytes"].device).synchronize()
        return {k: v.numpy().copy() if k in ("consumed", "locked") else v.numpy()
                for k, v in host.items()}


def step_bytes(cell, segment_len: int) -> int:
    """The u8 bytes of one step: E x L x 2."""
    return cell.traffic["n_ensembles"] * segment_len * 2


def _segments(rings, pointers, segment_len: int, dev) -> torch.Tensor:
    """(E, L, 2) uint8 on dev: each ring's segment at its pointer (set-up)."""
    return torch.stack([r[int(p):int(p) + segment_len] for r, p in zip(rings, pointers)]).to(dev)


def track_kernel_ms(path: str) -> Optional[float]:
    """The device time of the kernels, copies and sets launched inside each
    `demod.track` span of the chrome trace at path (a launch's runtime or
    driver call inside the span's host range, its device operation matched
    by correlation id), the median over the spans, in ms; None where the
    trace holds no such span (a program without a tracker)."""
    from benchmark.trace import DEVICE_CATS

    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == "demod.track")
    if not spans:
        return None
    opens = [a for a, _ in spans]
    owner = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            i = bisect.bisect_right(opens, e["ts"]) - 1
            if i >= 0 and e["ts"] <= spans[i][1]:
                owner[corr] = i
    sums = [0.0] * len(spans)
    for e in events:
        i = owner.get(e.get("args", {}).get("correlation"))
        if e.get("cat") in DEVICE_CATS and i is not None:
            sums[i] += e["dur"] / 1e3
    return statistics.median(sums)


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        control=None, plant_hz: float = 0.0):
    from tpudab_torch.models.ingest import HostFeed
    from tpudab_torch.models.step import ReceiveStep
    from tpudab_torch.ops import _build

    if control not in (None,) + CONTROLS:
        raise ValueError(f"control {control!r} not in {CONTROLS}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    mode = cfg["mode"]
    dab = get_dab_params(mode)
    e, f, d = tr["n_ensembles"], tr["n_frames"], tr["distinct"]
    c = f * dab.nb_cifs
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step = ReceiveStep(mode, _step.subchannel_configs(cfg), n_ensembles=e,
                       track_frames=f).to(dev)
    track = step.track
    seg_len = track.segment_len

    t0 = time.perf_counter()
    streams = drift_streams(cfg, tr, seed, dev, seg_len)
    synth_s = time.perf_counter() - t0
    truth = streams.truth
    rings, sig = streams.rings, streams.sig
    period = np.array([r.shape[0] - seg_len for r in rings], dtype=np.int64)
    ens = torch.arange(e) % d
    want = (torch.from_numpy(sig.fibs.reshape(d, f * dab.nb_fib_groups, -1)[ens.numpy()]).to(dev),
            {sid: torch.from_numpy(t).to(dev) for sid, t in step_truth(sig, e, c, 0).items()})

    # set-up: acquisition, the pointers moved to frame 0, the first state
    t0 = time.perf_counter()
    start = (period - streams.lead) % period
    acq = track.acquire(_segments(rings, start, seg_len, dev))
    start = (start + acq["advance"].cpu().numpy()) % period
    if control in ("frozen", "true_cfo"):
        state = track.initial(acq)
        track.update = lambda seg, st: (lambda h: (h, h["c_prev"]))(track.hold(st))
    else:
        state = track.train(_segments(rings, start, seg_len, dev), acq)
    pointers = Pointers(start, period)
    pointers.report(state["c_prev"].cpu().numpy())
    if control == "cfo_held":
        plant_hz = PLANT_HZ
        update = track.update
        track.update = lambda seg, st: (lambda new, c: (
            {**new, "coarse_hz": st["coarse_hz"], "fine_hz": st["fine_hz"]}, c))(
            *update(seg, st))
    state = {**state, "fine_hz": state["fine_hz"] + plant_hz}
    if control == "true_cfo":
        truth.phase = "check"
        cfo = torch.from_numpy(truth.open()["cfo_hz"]).to(dev, torch.float64)
        state = {**state, "coarse_hz": cfo, "fine_hz": torch.zeros_like(cfo)}
    truth.phase = "window"
    acquire_s = time.perf_counter() - t0

    feed = HostFeed((e, seg_len, 2), dev)
    clock = _step.Clock(dev)
    readback = Readback()
    consumed = np.zeros(e, dtype=np.int64)
    taken = [0]

    def feed_step():
        """Enqueue one step's segments' copy at the pointers; the mark just
        before the copy starts."""
        t = None if cuda else clock.mark()
        ptr = pointers.take()
        feed.feed(rings, ptr)
        taken[0] += 1
        return (feed.started if cuda else t), ptr

    def call(carry, marks):
        if not trace:
            return step(carry, feed, None, None)
        carry, soft, stats = step.demod_stream(carry, feed)
        marks.append(clock.mark())
        carry, fic, subch = step.decode_soft(carry, soft)
        marks.append(clock.mark())
        return carry, {"fic_bytes": fic, "subch": subch, **stats}

    def finish(out):
        host = readback(out)
        pointers.report(host["consumed"])
        consumed[:] += host["consumed"]
        return host

    t0 = time.perf_counter()
    carry = {**step.init_carry(dev), "track": state}
    locks = []
    for i in range(WARM_STEPS):
        feed_step()
        carry, out = call(carry, [])
        if i:
            _step.wrong_bytes(out, want, 0)
        locks.append(finish(out)["locked"])
        if i == 0:
            first_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    del out

    # the window: at least one step past the ramp, whose rows are all due
    min_steps = RAMP_CIFS // c + 2
    stretches = [("device", TRACED_STEPS), ("host", GAP_STEPS)] if trace else []
    wrongs, taps, spans, kinds, held, traces = [], [], [], [], [], {}
    ref_steps = []
    prof, kind, left = None, "plain", 0
    carry = {**step.init_carry(dev), "track": carry["track"]}
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    start_mark, ptr = feed_step()
    k = 0
    while True:
        if prof is None and stretches and time.perf_counter() - t_win >= 0.4 * seconds:
            kind, left = stretches.pop(0)
            prof = _step.start_profiler(cuda, host=kind == "host")
        last = time.perf_counter() - t_win >= seconds and k + 1 >= min_steps \
            and not stretches and (prof is None or left == 1)
        lo = max(0, RAMP_CIFS - k * c)
        before = carry["track"]
        with torch.profiler.record_function(MARK) if prof is not None \
                else contextlib.nullcontext():
            if not last:
                if control == "skip" and k == 0:
                    pointers.owed[0] = pointers.owed[0] + 1
                after, ptr_next = feed_step()   # step k + 1's IQ, copied under step k's kernels
            marks = [start_mark, clock.mark()]
            carry, out = call(carry, marks)
            k += 1
            if prof is not None:
                left -= 1
            if prof is None:
                wrongs.append(_step.wrong_bytes(out, want, lo))
            else:
                held.append((out, lo))
            host = finish(out)
        marks.append(clock.mark())
        spans.append(marks)
        kinds.append(kind)
        locks.append(host["locked"])
        taps.append((out["mean_power"], out["const_re"], out["const_im"]))
        if k == 1 or last:
            ref_steps.append((k, ptr, before, len(taps) - 1))
        del out
        if prof is not None and left == 0:
            traces[kind] = _step.stop_profiler(prof)
            prof, kind = None, "plain"
            wrongs += [_step.wrong_bytes(o, want, lo_) for o, lo_ in held]
            held = []
        if last:
            break
        start_mark, ptr = after, ptr_next
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
    final = {key: v.cpu().numpy() for key, v in carry["track"].items()}
    next_ptr = pointers.next()
    counters = track.counters()
    ref_in = [(kk, pp, {key: v.cpu() for key, v in st.items()},
               taps[i][0].cpu().numpy(), torch.stack([taps[i][1], taps[i][2]]).cpu().numpy())
              for kk, pp, st, i in ref_steps]
    bytes_copied, due = feed.bytes_copied, taken[0] * step_bytes(cell, seg_len)
    n_steps = WARM_STEPS + k
    del taps, wrongs, carry, step, track, want, feed
    if cuda:
        torch.cuda.empty_cache()

    # the check, after the window: the truth opened, the program's readings
    # held to it and to the plain reference
    truth.phase = "check"
    t = truth.open()
    gap = (next_ptr + final["rs"] + t["period"] / 2) % t["period"] - t["period"] / 2
    mp_gap, tap_gap = 0.0, 0.0
    for kk, pp, st, mp, tap in ref_in:
        seg = torch.stack([r[int(q):int(q) + seg_len] for r, q in zip(rings, pp)])
        ref = reference_track.track_step(seg, st, f, mode)
        mp_gap = max(mp_gap, reference.mean_power_gap(mp, ref["mean_power"].reshape(-1).numpy()))
        tap_gap = max(tap_gap, reference.const_rms_gap(tap, ref["tap"].numpy()))
    lost = int(np.count_nonzero(~np.stack(locks)))
    limits = cell.limits
    checks = {
        "bytes_wrong": (int(per_step.sum()), limits["bytes_wrong"]),
        "bytes_copied_gap": (abs(bytes_copied - due), limits["bytes_copied_gap"]),
        "consumed_gap": (int(np.abs(consumed - n_steps * t["period"]).max()),
                         limits["consumed_gap"]),
        "timing_gap_samples": (float(np.abs(gap).max()), limits["timing_gap_samples"]),
        "ppm_gap": (float(np.abs((final["rate"] - 1.0) * 1e6 - t["ppm"]).max()),
                    limits["ppm_gap"]),
        "freq_gap_hz": (float(np.abs(final["coarse_hz"] + final["fine_hz"] - t["cfo_hz"]).max()),
                        limits["freq_gap_hz"]),
        "lock_lost": (lost, limits["lock_lost"]),
        "mean_power_gap": (mp_gap, limits["mean_power_gap"]),
        "const_rms_gap": (tap_gap, limits["const_rms_gap"]),
    }
    failed = int(np.count_nonzero(per_step))
    result = {"correct": judge(checks) and failed == 0 and per_step.size == k,
              "attempted": k, "failed": failed,
              "device": {"memory_peak_bytes": int(peak)},
              "setup_parts": {"synth_s": synth_s, "acquire_s": acquire_s,
                              "first_step_s": first_s, "build_s": _build.BuildInfo.seconds},
              "steps_checked": int(per_step.size), "bytes_copied": bytes_copied,
              "readings": {f"track.{key}": v for key, v in counters.items()},
              "step_ms_median": {kd: statistics.median(ms for ms, kk in zip(step_ms, kinds)
                                                       if kk == kd) for kd in sorted(set(kinds))}}
    if trace:
        from benchmark import trace as tracing

        summary = {kd: tracing.summarize(path, None if kd == "device" else MARK)
                   for kd, path in traces.items()}
        readings = {"cell": cell, "demod_ms": halves[0], "fec_ms": halves[1],
                    "trace": summary["device"], "steps": TRACED_STEPS, "cuda": cuda,
                    "h2d": h2d.summarize(traces["device"]), "track": counters,
                    "track_kernel_ms": track_kernel_ms(traces["host"]),
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


def control(cell, seed: int, seconds: float = 2.0) -> dict:
    """The controls' readings on the cell's inputs for `seed`: the frozen
    tracker's checks (run(..., control="frozen") with a short window, on
    the card where there is one); those of the CFO held with PLANT_HZ
    planted ("cfo_held.*") and of the program taking the same plant out
    ("planted.*"); and for the demod's outputs the float8 reference
    (reference_u8.py) against the float64 one on the last dongle's frame 0
    of the period, with its own CFO."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    res, checks = run(cell, seed, seconds, False, device, time.perf_counter(), "frozen")
    out = {k: v for k, (v, _) in checks.items() if k not in ("mean_power_gap", "const_rms_gap")}
    for name, kw in (("cfo_held", {"control": "cfo_held"}), ("planted", {"plant_hz": PLANT_HZ})):
        r, ch = run(cell, seed, seconds, False, device, time.perf_counter(), **kw)
        out.update({f"{name}.correct": r["correct"],
                    **{f"{name}.{k}": v for k, (v, _) in ch.items()}})
    cfg, tr = cell.config, cell.traffic
    t = get_ofdm_params(cfg["mode"]).nb_frame_length
    streams = drift_streams(cfg, tr, seed, "cpu", tr["n_frames"] * t + reference_track.MARGIN)
    streams.truth.phase = "check"
    iq = streams.rings[-1][:t]
    freq = float(streams.truth.open()["cfo_hz"][-1])
    tap = [reference_u8.const_tap(iq, freq, cfg["mode"], pr).numpy() for pr in ("f64", "fp8")]
    out.update(correct=res["correct"],
               mean_power_gap=reference.mean_power_gap(
                   reference_u8.mean_power(iq[None], "fp8").numpy(),
                   reference_u8.mean_power(iq[None]).numpy()),
               const_rms_gap=reference.const_rms_gap(tap[1], tap[0]))
    return out

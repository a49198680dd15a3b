"""The `widefed` driver: the receive step fed wideband receivers' raw s8 IQ
from host memory and channelised on the card, R receivers x 8 blocks = E
ensembles x F frames a step on one card.

Set-up makes the traffic's composites (wide_signal): the `distinct`
ensembles of benchmark/signal.py::monitor_signal (echo and AWGN at 2.048
MS/s, no CFO), each batch periodic in the step, placed in the frequency
domain at its block's offset from its receiver's centre plus its CFO (the
receiver's ppm times the block's frequency, rounded to the step's spectral
grid), delayed by its frame offset less a frame, scaled by its level and
summed over the receiver's blocks; one inverse FFT a receiver then gives
the band-limited, mixed composite at 16.384 MS/s exactly, periodic in the
step, which is scaled so that a rail's RMS is `rail_rms_lsb` LSB, rounded
and clipped to s8 as the front end does. Ensemble e = 8 s + b is block b
of receiver s and the distinct ensemble e % distinct. The s8 IQ lives in
R host regions, one a receiver, pinned on a card. tpudab_torch's HostFeed
copies their bytes to the card every step, R x N x 2 bytes with N =
8 F frame_len, on its own copy stream; the step is tpudab_torch's
ReceiveStep built with the configuration's ChannelPlan, handed the feed:
its channeliser (ofdm/channelise.py) turns each receiver's tail and new
samples into the ensembles' bf16 frames, which the demod and the FEC take
as in the other cells. WARM_STEPS steps (each fed, run and read back) warm
every shape up, and the window continues their carry, as the stream
continues: ensemble e's frames of a step start at output (k F - 1)
frame_len + d_e, which the synthesis makes frame 0 of the batch.

The window is hostfed's closed loop one step of IQ ahead (step k + 1's IQ
fed under step k's kernels); with --trace 1 the window calls the step's
halves (demod_wide, then decode_soft) and profiles the same two stretches.
A step's bytes come to the host as Readback copies them: each output into
a pinned host buffer without blocking, then one wait on the card. Not
step.py's to_host, a blocking round trip an output (seven here): the card
idles through each for as long as the host takes to answer, ~1 ms a step
that moves with the host's speed from process to process, enough to
spread the cell's runs past half its bounds.

Metrics: as hostfed's: rtf_per_gpu (ensemble-seconds decoded per second of
the window), step_ms_p95 (from an event recorded on the copy stream just
before the step's IQ copy starts to its bytes on the host), setup_s.
Beside them, step_parts_ms splits the unprofiled steps' period (see
step_parts).

Correct: every step's bytes against the bytes transmitted (bytes_wrong);
HostFeed.bytes_copied equal to the steps fed times a step's bytes
(bytes_copied_gap); the channeliser's step.ddc.samples_in equal to the
steps fed times R x N (ddc_samples_gap: the IQ repeats every step, so a
channeliser that skipped a step would still decode); against the plain
float64 reference started from the s8 streams (benchmark/reference_wide.py,
computed on the card after the program's state is freed): every step's
mean_power and the last ensemble's last frame's tap, and the relative RMS
error of the window's last step's channelised frames over all E
ensembles (ddc_gap).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark import h2d, reference, reference_wide
from benchmark.harness import BENCH, judge, load_module, read_per_layer
from benchmark.signal import (RAMP_CIFS, MonitorSignal, monitor_signal, seed_rng,
                             signal_seconds, step_truth)
from benchmark.synth.dab_params import get_dab_params
from benchmark.synth.ofdm_params import get_ofdm_params

WARM_STEPS = 2
TRACED_STEPS = 20
GAP_STEPS = 10
MARK = "bench.step"
OUTPUT_RATE = 2.048e6

_step = load_module(BENCH / "drivers" / "step.py")


class WideSignal(NamedTuple):
    iq: torch.Tensor                # (R, N, 2) int8, on the synthesis device
    cfo_hz: np.ndarray              # (E,) float32, the CFO handed to the step
    frame_offset: np.ndarray        # (E,) int32
    level_db: np.ndarray            # (E,)
    mon: MonitorSignal              # the distinct ensembles (bytes and payloads)


def _groups(cfg: dict, tr: dict, key: str):
    """The front end's `key` list cut into one group a centre, each group
    cut to the traffic's blocks a receiver, for the traffic's receivers."""
    fe = cfg["front_end"]
    g = len(fe[key]) // len(fe["centres_mhz"])
    return [fe[key][g * s: g * s + tr["blocks_per_receiver"]] for s in range(tr["receivers"])]


def receivers(cfg: dict, tr: dict):
    """[(centre Hz, [block Hz])] a receiver, as many as the traffic has."""
    return [(c * 1e6, [f * 1e6 for f in blocks]) for c, blocks in
            zip(cfg["front_end"]["centres_mhz"], _groups(cfg, tr, "block_mhz"))]


def plan(cell):
    """The configuration's tpudab_torch ChannelPlan, cut to the traffic's
    receivers. The plan's rate, decimation and taps are the port's: a
    configuration that states others is refused."""
    from tpudab_torch.ofdm.channelise import ChannelPlan

    fe, ch, tr = cell.config["front_end"], cell.config["channeliser"], cell.traffic
    stated = (fe["sample_rate_hz"], fe["decimation"], ch["taps"])
    if stated != (ChannelPlan.rate_hz, ChannelPlan.decimation, ChannelPlan.taps):
        raise ValueError(f"the port's channeliser runs {ChannelPlan.rate_hz} Hz, decimation "
                         f"{ChannelPlan.decimation}, {ChannelPlan.taps} taps; the "
                         f"configuration states {stated}")
    blocks = tuple(tuple(b) for b in _groups(cell.config, tr, "blocks"))
    return ChannelPlan(tuple(c * 1e6 for c in fe["centres_mhz"][:tr["receivers"]]), blocks,
                       ch["beta"], float(ch["cutoff_hz"]), float(ch["passband_hz"]))


def wide_signal(cfg: dict, tr: dict, seed: int, device) -> WideSignal:
    """The traffic's composites (see the module's docstring)."""
    mode, fe = cfg["mode"], cfg["front_end"]
    frame_len = get_ofdm_params(mode).nb_frame_length
    f, d_n = tr["n_frames"], tr["distinct"]
    dec = fe["decimation"]
    mon = monitor_signal(cfg, {**tr, "cfo_hz_max": 0.0}, seed)
    period = f * frame_len                      # samples a step at 2.048 MS/s
    bins_per_hz = period / OUTPUT_RATE
    rx = receivers(cfg, tr)
    e_n = sum(len(b) for _, b in rx)
    rng = seed_rng(seed, 0x5744, 0xC0)
    ppm = rng.uniform(-tr["ppm_max"], tr["ppm_max"], len(rx))
    level_db = rng.uniform(-tr["level_db"], tr["level_db"], e_n)
    offset = rng.integers(0, tr["frame_offset_max"], e_n).astype(np.int32)
    z = torch.fft.fft(torch.from_numpy(mon.iq.reshape(d_n, period)).to(device)
                      .to(torch.complex128))
    k = torch.arange(period, dtype=torch.int64, device=device)
    k_signed = torch.where(k < period // 2, k, k - period)
    wide = dec * period
    out = torch.empty((len(rx), wide, 2), dtype=torch.int8, device=device)
    cfo = np.zeros(e_n)
    e = 0
    for s, (centre, blocks) in enumerate(rx):
        w = torch.zeros(wide, dtype=torch.complex128, device=device)
        for block in blocks:
            cfo_bins = int(np.rint(ppm[s] * 1e-6 * block * bins_per_hz))
            cfo[e] = cfo_bins / bins_per_hz
            shift = int(round((block - centre) * bins_per_hz)) + cfo_bins
            delay = (int(offset[e]) - frame_len) % period
            ph = (k * delay) % period
            amp = torch.full_like(ph, dec * 10 ** (level_db[e] / 20), dtype=torch.float64)
            rot = torch.polar(amp, -2.0 * np.pi * ph.to(torch.float64) / period)
            w.index_add_(0, (k_signed + shift) % wide, z[e % d_n] * rot)
            e += 1
        x = torch.fft.ifft(w)
        gain = fe["rail_rms_lsb"] / torch.sqrt((x.abs() ** 2).mean() / 2.0)
        iq = torch.stack([x.real, x.imag], dim=-1) * gain
        out[s] = torch.clamp(torch.round(iq), -128, 127).to(torch.int8)
    return WideSignal(out, cfo.astype(np.float32), offset, level_db, mon)


class Readback:
    """A step's FIC and subchannel bytes on the host: each output copied
    into a pinned host buffer of its own without blocking (the card's
    copies follow the step's kernels on its stream), then one wait for
    the last of them. The buffers are reused from step to step: the bytes
    of a call hold until the next call."""

    def __init__(self):
        self.buffers = {}

    def __call__(self, out: dict):
        parts = [("fic", out["fic_bytes"])] + list(out["subch"].items())
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
        return host.pop("fic").numpy(), {k: v.numpy() for k, v in host.items()}


def step_bytes(cell) -> int:
    """The s8 bytes of one step: R x 8 F frame_len x 2."""
    return cell.traffic["receivers"] * samples(cell) * 2


def samples(cell) -> int:
    """A receiver's new samples a step: decimation x F x frame_len."""
    return cell.config["front_end"]["decimation"] * cell.traffic["n_frames"] * \
        get_ofdm_params(cell.config["mode"]).nb_frame_length


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    from tpudab_torch.models.ingest import HostFeed
    from tpudab_torch.models.step import ReceiveStep
    # a program without the channeliser fails here, before any synthesis
    from tpudab_torch.ofdm.channelise import Channeliser  # noqa: F401
    from tpudab_torch.ops import _build

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    mode = cfg["mode"]
    dab = get_dab_params(mode)
    e, f, d = tr["n_ensembles"], tr["n_frames"], tr["distinct"]
    r_n, n = tr["receivers"], samples(cell)
    c = f * dab.nb_cifs
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    sig = wide_signal(cfg, tr, seed, dev)
    synth_s = time.perf_counter() - t0
    regions = []
    for s in range(r_n):
        reg = torch.empty((n, 2), dtype=torch.int8, pin_memory=cuda)
        reg.copy_(sig.iq[s])
        regions.append(reg.view(torch.uint8))      # HostFeed copies bytes
    ens = torch.arange(e) % d
    freq = torch.from_numpy(sig.cfo_hz).to(dev)
    offsets = torch.from_numpy(sig.frame_offset).to(dev)
    feed = HostFeed((r_n, n, 2), dev)
    step = ReceiveStep(mode, _step.subchannel_configs(cfg), n_ensembles=e,
                       channels=plan(cell)).to(dev)
    mon = sig.mon
    want = (torch.from_numpy(mon.fibs.reshape(d, f * dab.nb_fib_groups, -1)[ens.numpy()]).to(dev),
            {sid: torch.from_numpy(t).to(dev) for sid, t in step_truth(mon, e, c, 0).items()})
    clock = _step.Clock(dev)
    to_host = Readback()

    def feed_step():
        """Enqueue one step's IQ copy; the marks just before it starts and
        just after it ends (on the copy stream)."""
        t = None if cuda else clock.mark()
        feed.feed(regions)
        if not cuda:
            return t, t
        done = torch.cuda.Event(enable_timing=True)
        done.record(feed.stream)
        return feed.started, done

    def call(carry, marks):
        if not trace:
            return step(carry, feed, None, freq, offsets)
        carry, soft, stats = step.demod_wide(carry, feed, freq, offsets)
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
        to_host(out)
        if i == 0:
            first_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    del out

    # the window continues the warm-up's carry (the stream goes on): its
    # rows are due once the warm-up and the window have passed the ramp
    min_steps = max(1, RAMP_CIFS // c + 2 - WARM_STEPS)
    stretches = [("device", TRACED_STEPS), ("host", GAP_STEPS)] if trace else []
    wrongs, taps, spans, copies, kinds, held, traces = [], [], [], [], [], [], {}
    prof, kind, left = None, "plain", 0
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
        lo = max(0, RAMP_CIFS - (WARM_STEPS + k) * c)
        with torch.profiler.record_function(MARK) if prof is not None \
                else contextlib.nullcontext():
            if not last:
                after = feed_step()        # step k + 1's IQ, copied under step k's kernels
            marks = [start[0], clock.mark()]
            carry, out = call(carry, marks)
            k += 1
            if prof is not None:
                left -= 1
            if prof is None:
                wrongs.append(_step.wrong_bytes(out, want, lo))
            else:
                held.append((out, lo))
            to_host(out)
        marks.append(clock.mark())
        spans.append(marks)
        copies.append(start[1])
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
    parts = step_parts(clock, spans, copies, kinds)
    per_step = torch.stack(wrongs).cpu().numpy()
    mp = torch.stack([t[0] for t in taps]).cpu().numpy()
    tap = torch.stack([torch.stack([t[1], t[2]]) for t in taps]).cpu().numpy()
    bytes_copied, due = feed.bytes_copied, (WARM_STEPS + k) * step_bytes(cell)
    samples_in, samples_due = step.ddc.samples_in, (WARM_STEPS + k) * r_n * n
    ddc_calls = step.ddc.calls
    # the last step's channelised frames, the channeliser's own buffer
    frames = step.ddc.out
    del taps, wrongs, carry, step, want, feed, regions
    if cuda:
        torch.cuda.empty_cache()

    # the check, after the window: the steps' counts of wrong bytes, the
    # bytes copied and channelised, the frames and the demod's outputs
    # against the plain reference from the s8 streams
    ref = reference_check(cell, sig, frames)
    del frames
    limits = cell.limits
    checks = {
        "bytes_wrong": (int(per_step.sum()), limits["bytes_wrong"]),
        "bytes_copied_gap": (abs(bytes_copied - due), limits["bytes_copied_gap"]),
        "ddc_samples_gap": (abs(samples_in - samples_due), limits["ddc_samples_gap"]),
        "mean_power_gap": (max(reference.mean_power_gap(m, ref["mean_power"]) for m in mp),
                           limits["mean_power_gap"]),
        "const_rms_gap": (max(reference.const_rms_gap(t, ref["tap"]) for t in tap),
                          limits["const_rms_gap"]),
        "ddc_gap": (ref["ddc_gap"], limits["ddc_gap"]),
    }
    failed = int(np.count_nonzero(per_step))
    result = {"correct": judge(checks) and failed == 0 and per_step.size == k,
              "attempted": k, "failed": failed,
              "device": {"memory_peak_bytes": int(peak)},
              "setup_parts": {"synth_s": synth_s, "first_step_s": first_s,
                              "build_s": _build.BuildInfo.seconds},
              "steps_checked": int(per_step.size), "bytes_copied": bytes_copied,
              "ddc_calls": ddc_calls, "step_parts_ms": parts,
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


def step_parts(clock, spans, copies, kinds) -> dict:
    """Medians over the window's unprofiled steps, ms on the card's clock:
    `copy`, a step's IQ copy; `loop`, from the step before's bytes on the
    host to the step's first mark (the host's turn of the loop, in which
    the card has nothing to run); `run`, from the later of that mark and
    the copy's end to the step's bytes on the host; `period`, from one
    step's bytes on the host to the next's."""
    t0 = spans[0][0]
    at = [(clock.ms(t0, m[1]), clock.ms(t0, m[-1]), clock.ms(t0, m[0]), clock.ms(t0, c))
          for m, c in zip(spans, copies)]
    plain = [i for i in range(1, len(spans)) if kinds[i] == kinds[i - 1] == "plain"]
    if not plain:
        return {}
    return {"copy": statistics.median(at[i][3] - at[i][2] for i in plain),
            "loop": statistics.median(at[i][0] - at[i - 1][1] for i in plain),
            "run": statistics.median(at[i][1] - max(at[i][0], at[i][3]) for i in plain),
            "period": statistics.median(at[i][1] - at[i - 1][1] for i in plain)}


def reference_frames(cell, sig: WideSignal, precision: str = "f64"):
    """Each ensemble's frames of a step in the stream's steady state by the
    plain reference, in order: (e, (F, frame_len) complex128), a receiver's
    step stream being its last T samples (the periodic stream's) then its N
    new ones."""
    cfg, tr = cell.config, cell.traffic
    fe, ch = cfg["front_end"], cfg["channeliser"]
    frame_len = get_ofdm_params(cfg["mode"]).nb_frame_length
    f, n, taps = tr["n_frames"], samples(cell), ch["taps"]
    n_tail = fe["decimation"] * frame_len + taps - 1
    h = reference_wide.design(taps, ch["beta"], ch["cutoff_hz"], fe["sample_rate_hz"],
                              precision, sig.iq.device)
    e = 0
    for s, (centre, blocks) in enumerate(receivers(cfg, tr)):
        stream = sig.iq[s].repeat(-(-n_tail // n) + 1, 1)[-(n_tail + n):]
        y = reference_wide.ddc(stream, -(taps - 1), [b - centre for b in blocks], h,
                               fe["sample_rate_hz"], fe["decimation"], precision)
        for b in range(len(blocks)):
            d = int(sig.frame_offset[e])
            yield e, y[b, d: d + f * frame_len].reshape(f, frame_len)
            e += 1


def reference_check(cell, sig: WideSignal, frames, precision: str = "f64") -> dict:
    """The reference's readings on a steady-state step of the cell's
    streams: each ensemble's frames' mean powers ((E F,) float64), the
    last ensemble's last frame's tap, and, with `frames` ((2, E, F, ...)
    bf16 re and im, or an (E, F, frame_len) complex128 stack), the relative
    RMS error of those frames against the reference's."""
    e_n, f = cell.traffic["n_ensembles"], cell.traffic["n_frames"]
    mean_power = np.zeros((e_n, f))
    err = power = 0.0
    tap = None
    for e, ref in reference_frames(cell, sig, precision):
        mean_power[e] = reference_wide.mean_power(ref, precision).cpu().numpy()
        if frames is not None:
            got = frames[e] if frames.is_complex() else frames[:, e].reshape(2, f, -1)
            got_re, got_im = (got.real, got.imag) if got.is_complex() else (got[0], got[1])
            a, p = reference_wide.rms_gap(got_re, got_im, ref)
            err, power = err + a, power + p
        if e == e_n - 1:
            tap = reference_wide.const_tap(ref[f - 1], float(sig.cfo_hz[e]), cell.config["mode"],
                                           precision).numpy()
    return {"mean_power": mean_power.reshape(-1), "tap": tap,
            "ddc_gap": float(np.sqrt(err / power)) if power else None}


def control(cell, seed: int) -> dict:
    """The control's readings on the cell's inputs for `seed`: the
    reference in float8 (reference_wide.py: the taps, the mixed samples,
    the FFT window and the DFT matrix) put in the program's place, its
    frames, mean powers and tap held to the float64 reference as the
    program's are. The bytes have no control: they are compared exactly."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    sig = wide_signal(cell.config, cell.traffic, seed, dev)
    low = reference_check(cell, sig, None, "fp8")
    stack = torch.stack([y for _, y in reference_frames(cell, sig, "fp8")])
    want = reference_check(cell, sig, stack)
    return {"mean_power_gap": reference.mean_power_gap(low["mean_power"], want["mean_power"]),
            "const_rms_gap": reference.const_rms_gap(low["tap"], want["tap"]),
            "ddc_gap": want["ddc_gap"]}

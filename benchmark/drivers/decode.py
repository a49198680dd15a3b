"""The `decode` driver: one user decoding one capture, each pass a fresh
`decode` as a user runs it on a clip.

Set-up makes the traffic's capture (benchmark/signal.py::capture_signal),
writes it as interleaved f32 under TMPDIR and runs one whole pass, which
builds what the program builds (the CUDA library, cuFFT plans). The window
calls tpudab_torch.host.cli.main(["decode", CAPTURE, "--device-step",
"--batch-frames", B, "--format", "f32", "--out-dir", D]) pass after pass,
each into a fresh D, and ends with the pass that crosses --seconds. The
harness wraps OfflinePipeline._frames_on_device and StepDriver.process to
keep where each batch was cut and the step's mean_power; with --trace 1
it also times Receiver.process_step_outputs and process_frame_bits, and
one pass runs under torch.profiler.

Metrics: decode_rtf, the signal seconds of the window's passes over
their wall seconds (host clock); setup_s.

Correct: after the window, every pass is held to the capture as made:
each DAB+ subchannel's AU file to the AUs sent (the first complete
superframes from logical frame 0 on, in order, none missing or extra),
the FIC line to every FIB passing its CRC, the database listing to the
ensemble and every service of the configuration, the acquired frame start
to the delay and the acquired net frequency (the Sync line's) to the CFO
put on the capture, and each step batch's mean_power to the plain
reference's on the same samples (benchmark/reference.py). Of the numbers
a pass gives, those with a limit in the cell's workload file are compared
(`checks`); the others are readings only (`readings`: the constellation
tap's gap from the reference's).
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import reference
from benchmark.harness import judge, read_per_layer
from benchmark.signal import RAMP_CIFS, capture_signal, signal_seconds
from benchmark.synth.dab_params import get_dab_params
from benchmark.synth.ofdm_params import get_ofdm_params
from benchmark.synth.superframe import FRAMES_PER_SUPERFRAME

MARK = "bench.pass"
AUS_PER_SUPERFRAME = 6          # 48 kHz, no SBR


def read_aus(data: bytes) -> list:
    """A subch<N>.aac.raw file's AUs (each behind its 4-byte LE length)."""
    aus, pos = [], 0
    while pos < len(data):
        n = int.from_bytes(data[pos: pos + 4], "little")
        aus.append(data[pos + 4: pos + 4 + n])
        pos += 4 + n
    return aus


class Recorder:
    """Wraps methods of the program for the length of a run:
    OfflinePipeline._frames_on_device (where each batch was cut) and
    StepDriver.process (its mean_power); with traced=True it also times
    the host wall inside Receiver.process_step_outputs and
    process_frame_bits, and names these and the CLI's capture load,
    acquisition and file dump as spans in the profiler's trace, so that
    the device's idle gaps read by what the host was doing."""

    def __init__(self, traced: bool):
        from tpudab_torch.host import cli
        from tpudab_torch.models.pipeline import OfflinePipeline
        from tpudab_torch.models.receiver import Receiver
        from tpudab_torch.models.step_driver import StepDriver

        self.events, self.parse_s = [], 0.0
        self.saved = []
        rec = self

        def wrap(owner, name, after=None):
            orig = getattr(owner, name)
            span = f"{owner.__name__}.{name}"

            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                if traced:
                    with torch.profiler.record_function(span):
                        out = orig(*a, **kw)
                else:
                    out = orig(*a, **kw)
                if after is not None:
                    after(t0, a, out)
                return out
            self.saved.append((owner, name, orig))
            setattr(owner, name, wrapper)

        wrap(OfflinePipeline, "_frames_on_device",
             lambda t0, a, out: rec.events.append(("batch", a[2], a[3])))
        wrap(StepDriver, "process",
             lambda t0, a, out: rec.events.append(
                 ("step", out[1]["mean_power"],
                  torch.stack([out[1]["const_re"], out[1]["const_im"]]))))
        if traced:
            def add(t0, a, out):
                rec.parse_s += time.perf_counter() - t0
            wrap(Receiver, "process_step_outputs", add)
            wrap(Receiver, "process_frame_bits", add)
            wrap(OfflinePipeline, "_acquire")
            wrap(cli, "_load_iq")
            wrap(cli, "_dump_audio")

    def take(self) -> list:
        ev, self.events = self.events, []
        return ev

    def close(self) -> None:
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)


def one_pass(argv, profiled: bool):
    """One `decode` through the CLI in this process: (its printed lines,
    wall s, the profiler's trace file or None)."""
    from tpudab_torch.host.cli import main as cli_main

    out = io.StringIO()
    prof = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        prof = profile(activities=acts)
        prof.start()
    with contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        with torch.profiler.record_function(MARK) if profiled else contextlib.nullcontext():
            rc = cli_main(argv)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = None
    if prof is not None:
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        prof.export_chrome_trace(path)
    if rc != 0:
        raise RuntimeError(f"decode exited {rc}")
    return out.getvalue().splitlines(), wall, path


def expected_rows(cell, spec) -> list:
    """The listing's service rows as `decode` prints them, PTy column left
    out: (start, end) of each service's row."""
    from benchmark.synth.puncture import get_uep_index_table

    rows = []
    for s, svc in zip(cell.config["subchannels"], spec.services):
        sub = next(c for c in spec.subchannels if c.subch_id == s["id"])
        kind, a, b = s["protection"]
        prot = (f"EEP {a}-{'A' if b == 0 else 'B'}" if kind == "eep"
                else f"UEP {get_uep_index_table()[(a, b)]}")
        rows.append((f"  0x{svc.service_id:04X}  {svc.label:<18} ",
                     f"{s['id']:>5} {prot:<8} {sub.bitrate_kbps:>4}  "
                     + ("DAB+" if s["service"] == "dab+" else "DAB")))
    return rows


def check_pass(cell, cap, lines, out_dir: Path, events, n_frames: int) -> dict:
    """The numbers of one pass (see the module's docstring)."""
    tr = cell.traffic
    n = get_ofdm_params(cell.config["mode"]).nb_frame_length
    nb_fibs = get_dab_params(cell.config["mode"]).nb_fibs
    fic = [ln for ln in lines if ln.startswith("FIC:")]
    fib_errors = 1
    if len(fic) == 1:
        parts = fic[0].replace(",", "").split()
        fib_errors = int(parts[3]) + abs(int(parts[1]) - nb_fibs * n_frames)
    sync = [ln for ln in lines if ln.startswith("Sync:")]
    start = int(sync[0].split("frame_start=")[1].split()[0]) if sync else -1
    net = float(sync[0].split("net_freq=")[1].split()[0]) if sync else float("inf")
    n_logical = n_frames * get_dab_params(cell.config["mode"]).nb_cifs
    n_aus = AUS_PER_SUPERFRAME * ((n_logical - RAMP_CIFS) // FRAMES_PER_SUPERFRAME)
    aus_wrong = 0
    for sid, want in cap.aus.items():
        f = out_dir / f"subch{sid}.aac.raw"
        got = read_aus(f.read_bytes()) if f.exists() else []
        aus_wrong += abs(len(got) - n_aus) + sum(g != w for g, w in zip(got, want[:n_aus]))
    eid = cap.spec.ensemble_id
    db_wrong = int(not any(ln.startswith(f"Ensemble: {cap.spec.label!r}  EId=0x{eid:04X}")
                           for ln in lines))
    for prefix, suffix in expected_rows(cell, cap.spec):
        db_wrong += int(not any(ln.startswith(prefix) and ln.endswith(suffix)
                                for ln in lines))
    gap, tap_gap, pos = 0.0, 0.0, None
    for ev in events:
        if ev[0] == "batch":
            pos, nf = ev[1], ev[2]
            continue
        j = round((pos - tr["delay_samples"]) / n)
        at = tr["delay_samples"] + j * n
        x = cap.iq[at: at + nf * n].reshape(nf, n)
        re = torch.from_numpy(np.ascontiguousarray(x.real))
        im = torch.from_numpy(np.ascontiguousarray(x.imag))
        gap = max(gap, reference.mean_power_gap(ev[1].cpu().numpy(),
                                                reference.mean_power(re, im).numpy()))
        want = reference.const_tap(re[-1], im[-1], tr["cfo_hz"], cell.config["mode"]).numpy()
        tap_gap = max(tap_gap, reference.const_rms_gap(ev[2].cpu().numpy(), want))
    steps = sum(ev[0] == "step" for ev in events)
    return {"aus_wrong": aus_wrong, "fib_errors": fib_errors, "db_wrong": db_wrong,
            "frame_start_gap": abs(start - tr["delay_samples"]),
            "net_freq_gap_hz": abs(net - tr["cfo_hz"]),
            "mean_power_gap": gap if steps else float("inf"),
            "const_rms_gap": tap_gap if steps else float("inf")}


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    from tpudab_torch.ops import _build

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tr, mode = cell.traffic, cell.config["mode"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cap = capture_signal(cell.config, tr, seed)
    synth_s = time.perf_counter() - t0
    n = get_ofdm_params(mode).nb_frame_length
    n_frames = (cap.iq.shape[0] - tr["delay_samples"]) // n
    tmp = Path(tempfile.mkdtemp(prefix="bench_decode_"))
    rec = Recorder(trace)
    try:
        capture = tmp / "capture.f32"
        np.stack([cap.iq.real, cap.iq.imag], axis=-1).astype(np.float32).tofile(capture)

        def argv(k):
            return ["decode", str(capture), "--device-step", "--batch-frames",
                    str(tr["batch_frames"]), "--format", tr["format"],
                    "--out-dir", str(tmp / f"pass{k}"), "--device", device]

        t0 = time.perf_counter()
        one_pass(argv("warm"), False)
        first_s = time.perf_counter() - t0
        rec.take()
        rec.parse_s = 0.0
        passes, trace_path = [], None
        t_win = time.perf_counter()
        setup_s = t_win - t_start
        k = 0
        while True:
            profiled = trace and trace_path is None and (k == 1 or seconds <= 0)
            lines, wall, path = one_pass(argv(k), profiled)
            trace_path = trace_path or path
            passes.append((lines, wall, rec.take()))
            k += 1
            if time.perf_counter() - t_win >= seconds and (not trace or trace_path):
                break
        window = time.perf_counter() - t_win
        peak = torch.cuda.max_memory_allocated() if cuda else 0

        numbers = [check_pass(cell, cap, lines, tmp / f"pass{i}", events, n_frames)
                   for i, (lines, _, events) in enumerate(passes)]
    finally:
        rec.close()
        shutil.rmtree(tmp, ignore_errors=True)
    checks = {name: (max(nb[name] for nb in numbers), cell.limits[name])
              for name in cell.limits}
    failed = sum(not judge({k: (nb[k], lim) for k, lim in cell.limits.items()})
                 for nb in numbers)
    result = {"correct": judge(checks) and failed == 0, "attempted": len(passes),
              "failed": failed, "device": {"memory_peak_bytes": int(peak)},
              "setup_parts": {"synth_s": synth_s, "first_pass_s": first_s,
                              "build_s": _build.BuildInfo.seconds},
              "pass_s": [w for _, w, _ in passes],
              "readings": {k: max(nb[k] for nb in numbers)
                           for k in numbers[0] if k not in cell.limits}}
    if trace:
        from benchmark import trace as tracing

        summary = tracing.summarize(trace_path, MARK) if trace_path else None
        readings = {"cell": cell, "trace": summary, "parse_s": rec.parse_s,
                    "pass_s": [w for _, w, _ in passes], "cuda": cuda}
        result["metrics"] = read_per_layer(cell, readings)
        if summary is not None:
            result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        if trace_path:
            os.unlink(trace_path)
    else:
        sig_s = signal_seconds(mode, n_frames) * len(passes)
        result["metrics"] = {"decode_rtf": {"value": sig_s / window, "unit": "x_realtime"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    return result, checks


def control(cell, seed: int) -> dict:
    """The control's readings on the cell's capture for `seed`: the
    reference with the capture's f32 samples rounded to bf16, the step
    below the f32 the configuration's capture is in (and the tap's DFT a
    product with the bf16-rounded DFT matrix), its mean power of every
    frame and tap of every frame held to the float64 reference as the
    program's step batches are. The AUs, FIBs, listing and frame start
    have no control: they are compared exactly. Nor has the net frequency,
    the reference acquiring none (calibrate.py's faults read it)."""
    tr = cell.traffic
    cap = capture_signal(cell.config, tr, seed)
    n = get_ofdm_params(cell.config["mode"]).nb_frame_length
    x = cap.iq[tr["delay_samples"]:]
    x = x[: x.shape[0] // n * n].reshape(-1, n)
    re = torch.from_numpy(np.ascontiguousarray(x.real))
    im = torch.from_numpy(np.ascontiguousarray(x.imag))
    low = reference.mean_power(re.to(torch.bfloat16), im.to(torch.bfloat16)).numpy()
    mode = cell.config["mode"]
    tap = max(reference.const_rms_gap(
        reference.const_tap(r, i, tr["cfo_hz"], mode, "bf16").numpy(),
        reference.const_tap(r, i, tr["cfo_hz"], mode).numpy()) for r, i in zip(re, im))
    return {"mean_power_gap": reference.mean_power_gap(low, reference.mean_power(re, im).numpy()),
            "const_rms_gap": tap}

"""Full-ensemble receive throughput on one card (the port of the repo's
bench.py): the real-time factor per GPU of ReceiveStep at E = 32
ensembles x F = 16 frames of bf16 IQ behind bench.py's correctness gate,
and the Viterbi decoder's Mbit/s at the MSC's batch. Prints one JSON line
with bench.py's keys; `device` holds the card's name and power limit (the
numbers are this card's).

The method is bench.py's (bench.py:95-160):
- the workload: bench_subchannels() (six 108-CU EEP 3-A subchannels) and
  bench_capture(F) (bench.py's spec and seeds), tiled, cast to bf16 and
  broadcast to E ensembles, 0 Hz;
- the gate, on the first step from a zero carry: every FIB CRC passes,
  and subchannel 1's logical frames from 15 on equal the payload;
- one warm-up step, one timed step (t_one), then
  iters = max(3, min(20, int(5 / t_one))) queued steps on the host clock,
  the barrier being the on-device f32 checksum of every output read back
  as one float: RTF = iters x E x F x 196,608 / dt / 2.048 MS/s;
- the Viterbi: viterbi_decode_bytes_best (K1 + K2 on the card) on
  (6144, 3462, 4) f32 soft bits from default_rng(1), 3456 data bits, 10
  queued calls a rep, 3 reps: the best rep's Mbit/s and the spread
  (max - min) / max. The first TWIN_B codewords' bytes are held to the
  plain twin.

E and F come from TPUDAB_BENCH_ENSEMBLES (32) and TPUDAB_BENCH_FRAMES
(16). Unlike bench.py, no failure is swallowed: a failed run prints
bench.py's error line and exits 1.

Run: python -m tpudab_torch.tools.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Tuple

import numpy as np
import torch

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE
from tpudab_torch.constants.puncture import eep_profile
from tpudab_torch.fec.crc import check_fib_crc
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.msc.interleave import TIME_INTERLEAVE_DEPTH
from tpudab_torch.msc.subchannel import SubchannelConfig
from tpudab_torch.ops.viterbi import mother_to_t, viterbi_decode_bytes_t_ref
from tpudab_torch.ops.viterbi_cuda import signs_on, viterbi_decode_bytes_best
from tpudab_torch.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                                ServiceSpec, SubchannelSpec, modulate_frame_bits)
from tpudab_torch.tools._common import card
from tpudab_torch.tools.exp_viterbi_sweep import B, NBITS, TWIN_B, soft_input
from tpudab_torch.utils.device import resolve_device

METRIC = "realtime_factor_per_chip"     # bench.py's name, so the two lines join
UNIT = "x_realtime_full_ensemble_decode"
KEYS = ("metric", "value", "unit", "vs_baseline", "samples_per_s", "viterbi_mbit_s",
        "viterbi_mbit_s_spread", "device", "n_frames_per_step", "n_ensembles_per_step")
TARGET_S = 5.0                 # the queued steps' time, from the timed step
V_ITERS, V_REPS = 10, 3        # Viterbi calls a rep, reps


def bench_subchannels() -> Tuple[SubchannelConfig, ...]:
    """The bench's full-ensemble layout: six 108-CU EEP 3-A subchannels
    (tpudab's __graft_entry__._bench_subchannels)."""
    layout = [(1, 0, 108), (2, 108, 108), (3, 216, 108),
              (4, 324, 108), (5, 432, 108), (6, 540, 108)]
    return tuple(SubchannelConfig(subch_id=sid, start_cu=start, size_cu=size,
                                  profile=eep_profile(size, 3, 0))
                 for sid, start, size in layout)


def bench_capture(n_frames: int, streams=None):
    """The bench's signal (tpudab bench.py:26-51, same spec and seeds) for
    bench_subchannels(): (n_frames, frame_len) complex64 frames and the
    known payload of subchannel 1, (4 * n_frames, frame_bytes) uint8.
    streams, {subch_id: (4 * n_frames, frame_bytes) uint8}, replaces the
    payloads of those subchannels (subchannel 1's seeded random bytes, the
    others' synthesiser stream)."""
    subchannels = bench_subchannels()
    spec = EnsembleSpec(
        ensemble_id=0xBE9C, label="Bench Ensemble",
        services=[ServiceSpec(0xC200 + c.subch_id, f"Bench {c.subch_id}",
                              [(0, ASCTY_DAB_PLUS, c.subch_id)])
                  for c in subchannels],
        subchannels=[SubchannelSpec(c.subch_id, start_cu=c.start_cu,
                                    size_cu=c.size_cu, protection=("eep", 3, 0))
                     for c in subchannels])
    synth = EnsembleSynthesizer(spec, seed=1)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (n_frames * 4, subchannels[0].data_bits // 8)).astype(np.uint8)
    streams = {subchannels[0].subch_id: data, **(streams or {})}
    for sid, stream in streams.items():
        synth.payload_fn[sid] = lambda m, st=stream: st[m].tobytes()
    data = streams[subchannels[0].subch_id]
    frames = np.stack([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)])
    return frames, data


def bench_inputs(dev: torch.device, n_ens: int, n_frames: int):
    """(step, frames_re, frames_im, freq_hz, payload): bench.py's
    ReceiveStep of n_ens ensembles on dev, bench_capture(n_frames) tiled,
    cast to bf16 (round to nearest even, as ml_dtypes' cast) and
    broadcast to n_ens ensembles on dev, 0 Hz, and subchannel 1's payload."""
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=n_ens).to(dev)
    frames, payload = bench_capture(n_frames)
    tiled = step.tile_frames(frames)
    re, im = (torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).to(dev)
              for x in (tiled.real, tiled.imag))
    if n_ens > 1:
        re, im = (x.expand((n_ens,) + x.shape).contiguous() for x in (re, im))
    return step, re, im, torch.tensor(0.0, device=dev), payload


def gate(step: ReceiveStep, re, im, freq, payload: np.ndarray) -> dict:
    """bench.py's gate on the first step from a zero carry: every FIB CRC
    passes and subchannel 1's logical frames from 15 on (the
    deinterleaver's ramp) equal the payload. Raises on a failure; returns
    the step's outputs."""
    _, out = step(step.init_carry(re.device), re, im, freq)
    ok = check_fib_crc(out["fic_bytes"].cpu().numpy().reshape(-1, 3, 32))
    if ok.mean() != 1.0:
        raise RuntimeError(f"FIB CRC pass rate {ok.mean():.3f} != 1.0")
    sid = step.subchannels[0].subch_id
    got = out["subch"][sid].cpu().numpy()
    if step.n_ensembles > 1:
        got = got[0]
    ramp = TIME_INTERLEAVE_DEPTH - 1
    if got.shape[0] > ramp and not np.array_equal(got[ramp:], payload[:got.shape[0] - ramp]):
        raise RuntimeError(f"subchannel {sid}: logical frames from {ramp} on are not the payload")
    return out


def checksum(out: dict) -> float:
    """The barrier: every output summed in f32 on its device, read back as
    one float."""
    s = out["fic_bytes"].float().sum()
    for v in out["subch"].values():
        s = s + v.float().sum()
    return float(s)


def step_rate(step: ReceiveStep, re, im, freq) -> float:
    """bench.py's step timing: one warm-up and one timed step (t_one), then
    max(3, min(20, int(TARGET_S / t_one))) queued steps and one checksum.
    Returns the queued steps' samples a second."""
    carry = step.init_carry(re.device)
    carry, out = step(carry, re, im, freq)
    checksum(out)
    t0 = time.perf_counter()
    carry, out = step(carry, re, im, freq)
    checksum(out)
    t_one = time.perf_counter() - t0
    iters = max(3, min(20, int(TARGET_S / max(t_one, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, out = step(carry, re, im, freq)
    checksum(out)
    dt = time.perf_counter() - t0
    samples = iters * step.n_ensembles * re.shape[-3] * step.params.nb_frame_length
    return samples / dt


def viterbi_rate(dev: torch.device, b: int = B, n_bits: int = NBITS,
                 iters: int = V_ITERS) -> dict:
    """bench.py's Viterbi microbench on soft_input(b, n_bits): one call
    (its first TWIN_B codewords held to the plain twin; a difference
    raises), then V_REPS reps of iters queued calls, each ended by one read
    back of the bytes' sum. Returns {"mbit_s": the best rep's, "spread":
    (max - min) / max, "rates": each rep's Mbit/s, "bytes": the last
    call's}."""
    soft = soft_input(b, n_bits, dev)
    by = viterbi_decode_bytes_best(soft, n_bits)
    n = min(TWIN_B, b)
    if not torch.equal(by[:n], viterbi_decode_bytes_t_ref(mother_to_t(soft[:n]),
                                                          signs_on(dev), n_bits)):
        raise RuntimeError(f"Viterbi: the first {n} codewords differ from the plain twin's")
    rates = []
    for _ in range(V_REPS):
        t0 = time.perf_counter()
        for _ in range(iters):
            by = viterbi_decode_bytes_best(soft, n_bits)
        float(by.float().sum())
        rates.append(iters * b * n_bits / (time.perf_counter() - t0) / 1e6)
    return {"mbit_s": max(rates), "spread": (max(rates) - min(rates)) / max(rates),
            "rates": rates, "bytes": by}


def run(dev: torch.device, n_ens: int, n_frames: int, viterbi_b: int = B,
        viterbi_iters: int = V_ITERS):
    """main's work at n_ens x n_frames (and the Viterbi on viterbi_b
    codewords, viterbi_iters calls a rep): returns the JSON line's dict and
    the gate step's outputs. Raises on any failure."""
    step, re, im, freq, payload = bench_inputs(dev, n_ens, n_frames)
    first = gate(step, re, im, freq, payload)
    samples_per_s = step_rate(step, re, im, freq)
    vit = viterbi_rate(dev, viterbi_b, NBITS, viterbi_iters)
    rtf = samples_per_s / SAMPLING_RATE
    line = {
        "metric": METRIC,
        "value": round(rtf, 2),
        "unit": UNIT,
        "vs_baseline": round(rtf, 2),
        "samples_per_s": round(samples_per_s),
        "viterbi_mbit_s": round(vit["mbit_s"], 2),
        "viterbi_mbit_s_spread": round(vit["spread"], 4),
        "device": card(dev),
        "n_frames_per_step": n_frames,
        "n_ensembles_per_step": n_ens,
    }
    return line, first


def main(argv=None) -> dict:
    """Resolve the device (no card is an error), run at TPUDAB_BENCH_ENSEMBLES
    x TPUDAB_BENCH_FRAMES and print the JSON line; on a failure print
    bench.py's error line and exit 1."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card is an error) or cpu, the plain torch "
                         "twins with host times, for rehearsal")
    dev = resolve_device(ap.parse_args(argv).device)
    n_frames = int(os.environ.get("TPUDAB_BENCH_FRAMES", "16"))
    n_ens = int(os.environ.get("TPUDAB_BENCH_ENSEMBLES", "32"))
    try:
        line, _ = run(dev, n_ens, n_frames)
    except Exception as e:
        traceback.print_exc()
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
                          "error": f"{type(e).__name__}: {str(e)[:160]}"}), flush=True)
        raise SystemExit(1) from e
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

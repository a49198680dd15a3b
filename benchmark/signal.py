"""The benchmark's one traffic generator: seeded inputs and their ground
truth for a configuration (benchmark/configs/<name>.json) under a traffic
mix (benchmark/traffic/<name>.json), made by the frozen synthesizer in
benchmark/synth. Nothing here imports the program.

- monitor_signal: the step driver's batch. `distinct` ensembles, each with
  its own payloads, CFO and noise drawn from the seed, synthesized after
  the time interleaver's ramp (from CIF 16 on) with every subchannel's
  payload periodic in the step's CIFs, so that the batch repeated is the
  continuous signal and every step decodes to the same known bytes.
- capture_signal: the decode driver's capture, from frame 0, with DAB+
  streams of seeded random AUs, impaired as the traffic says.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from benchmark.synth.dab_params import get_dab_params
from benchmark.synth.ensemble import (ASCTY_DAB, ASCTY_DAB_PLUS, EnsembleSpec,
                                      EnsembleSynthesizer, ServiceSpec, SubchannelSpec)
from benchmark.synth.modulator import Impairments, apply_impairments, modulate_frame_bits
from benchmark.synth.ofdm_params import get_ofdm_params
from benchmark.synth.payload import dabplus_stream

RAMP_CIFS = 15          # the time interleaver's depth less one


def seed_rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one part of a run's inputs: the run's seed (any
    whole number) and the part's keys, through numpy's SeedSequence."""
    return np.random.default_rng([seed % 2 ** 64, *keys])


def ensemble_spec(config: dict, index: int) -> EnsembleSpec:
    """The configuration's multiplex as ensemble number `index`: its own
    ensemble and service ids, one audio service a subchannel."""
    subs = config["subchannels"]
    return EnsembleSpec(
        ensemble_id=0xB000 + index, label=f"{config['name']} {index}",
        services=[ServiceSpec(0xC000 + 0x100 * index + s["id"], f"{config['name']} s{s['id']}",
                              [(0, ASCTY_DAB if s["service"] == "mp2" else ASCTY_DAB_PLUS,
                                s["id"])])
                  for s in subs],
        subchannels=[SubchannelSpec(s["id"], start_cu=s["start_cu"], size_cu=s["size_cu"],
                                    protection=tuple(s["protection"])) for s in subs])


class CarouselSynthesizer(EnsembleSynthesizer):
    """The synthesizer with the service FIGs (0/2, 0/17, 1/1) spread over
    `cycle` frames, as a transmitter does where one frame's FIC cannot hold
    them all: frame i carries those of services i % cycle, i % cycle +
    cycle, ... The subchannel organisation and the ensemble FIGs are in
    every frame."""

    def __init__(self, spec: EnsembleSpec, mode: int, seed: int):
        super().__init__(spec, mode=mode, seed=seed)
        self.cycle = 1
        while True:
            try:
                for i in range(self.cycle):
                    self._build_figs(i).pack_fibs(self.dab.nb_fibs)
                break
            except AssertionError:
                self.cycle += 1

    def _build_figs(self, frame_idx: int):
        services = self.spec.services
        self.spec.services = services[frame_idx % self.cycle::self.cycle]
        try:
            return super()._build_figs(frame_idx)
        finally:
            self.spec.services = services


def frame_bytes(spec: EnsembleSpec) -> Dict[int, int]:
    """{subchannel id: bytes a logical frame}."""
    return {s.subch_id: s.data_bits_per_frame // 8 for s in spec.subchannels}


def impair(x: np.ndarray, traffic: dict, cfo_hz: float, delay: int, noise_seed: int,
           periodic: bool) -> np.ndarray:
    """The traffic's channel on clean IQ: its echo, then delay, CFO and
    AWGN. periodic: the echo wraps around, as on the batch repeated."""
    d, gain, phase = traffic["echo"]
    imp = Impairments(freq_offset_hz=cfo_hz, delay_samples=delay, snr_db=traffic["snr_db"],
                      multipath=((int(d), float(gain), float(phase)),), seed=noise_seed)
    if not periodic:
        return apply_impairments(x, imp)
    y = apply_impairments(np.concatenate([x[-int(d):], x]), imp)
    return y[int(d): int(d) + x.shape[0]]


@dataclasses.dataclass
class MonitorSignal:
    iq: np.ndarray                  # (distinct, F, frame_len) complex64
    cfo_hz: np.ndarray              # (distinct,) float32, the CFO handed to the step
    fibs: np.ndarray                # (distinct, F * nb_fibs, 32) uint8, as transmitted
    payload: Dict[int, np.ndarray]  # {subch id: (distinct, 4 F, bytes)} uint8, by logical frame
    first_cif: int                  # the synthesizer's CIF index of the batch's first CIF


def monitor_signal(config: dict, traffic: dict, seed: int) -> MonitorSignal:
    """The step driver's batch (see the module's docstring)."""
    dab = get_dab_params(config["mode"])
    nf, period = traffic["n_frames"], traffic["n_frames"] * dab.nb_cifs
    first_frame = -(-RAMP_CIFS // dab.nb_cifs) + (RAMP_CIFS % dab.nb_cifs == 0)
    iq, cfo, fibs, payload = [], [], [], {}
    for d in range(traffic["distinct"]):
        rng = seed_rng(seed, d)
        spec = ensemble_spec(config, d)
        synth = CarouselSynthesizer(spec, config["mode"], int(rng.integers(2 ** 31)))
        for sid, n in frame_bytes(spec).items():
            data = rng.integers(0, 256, (period, n), dtype=np.uint8)
            payload.setdefault(sid, []).append(data)
            synth.payload_fn[sid] = lambda m, data=data: data[m % period].tobytes()
        synth.cif_counter = first_frame * dab.nb_cifs
        frames, fib = [], []
        for i in range(first_frame, first_frame + nf):
            fib.append(synth._build_figs(i).pack_fibs(dab.nb_fibs))
            frames.append(modulate_frame_bits(synth.frame_bits(i), config["mode"]))
        cfo_hz = float(np.float32(rng.uniform(-traffic["cfo_hz_max"], traffic["cfo_hz_max"])))
        x = impair(np.concatenate(frames), traffic, cfo_hz, 0, int(rng.integers(2 ** 31)), True)
        iq.append(x.reshape(nf, -1))
        cfo.append(cfo_hz)
        fibs.append(np.concatenate(fib))
    return MonitorSignal(np.stack(iq), np.array(cfo, dtype=np.float32), np.stack(fibs),
                         {k: np.stack(v) for k, v in payload.items()},
                         first_frame * dab.nb_cifs)


def step_truth(sig: MonitorSignal, ensembles: int, rows: int, cifs_before: int
               ) -> Dict[int, np.ndarray]:
    """{subch id: (ensembles, rows, bytes)}: what a step's subchannel output
    row r should hold, ensemble e being distinct ensemble e % distinct: the
    logical frame (cifs_before + r - 15) of the fed stream, which starts at
    the synthesizer's CIF first_cif."""
    d = sig.iq.shape[0]
    idx = (sig.first_cif + cifs_before + np.arange(rows) - RAMP_CIFS) % next(
        iter(sig.payload.values())).shape[1]
    ens = np.arange(ensembles) % d
    return {sid: p[ens][:, idx] for sid, p in sig.payload.items()}


@dataclasses.dataclass
class CaptureSignal:
    iq: np.ndarray                  # (samples,) complex64
    aus: Dict[int, List[bytes]]     # {subch id: the AUs in order} (DAB+ subchannels)
    spec: EnsembleSpec


def capture_signal(config: dict, traffic: dict, seed: int) -> CaptureSignal:
    """The decode driver's capture (see the module's docstring)."""
    nf = traffic["n_frames"]
    spec = ensemble_spec(config, 0)
    rng = seed_rng(seed, 0)
    synth = CarouselSynthesizer(spec, config["mode"], int(rng.integers(2 ** 31)))
    aus = {}
    n_logical = nf * get_dab_params(config["mode"]).nb_cifs
    for s in config["subchannels"]:
        if s["service"] != "dab+":
            continue
        rate = next(c for c in spec.subchannels if c.subch_id == s["id"]).bitrate_kbps
        stream, aus[s["id"]] = dabplus_stream(rate, n_logical, int(rng.integers(2 ** 31)),
                                              with_pad=s["id"] == traffic["pad_subchannel"])
        synth.payload_fn[s["id"]] = lambda m, st=stream: st[m].tobytes()
    x = np.concatenate([modulate_frame_bits(synth.frame_bits(i), config["mode"])
                        for i in range(nf)])
    iq = impair(x, traffic, traffic["cfo_hz"], traffic["delay_samples"],
                int(rng.integers(2 ** 31)), False)
    return CaptureSignal(iq, aus, spec)


def signal_seconds(mode: int, frames: int) -> float:
    """Seconds of signal in `frames` transmission frames."""
    return frames * get_ofdm_params(mode).nb_frame_length / 2.048e6

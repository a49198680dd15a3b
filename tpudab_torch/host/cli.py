"""Command line of the port: `decode`, `decode-bits`, `synth`, `info` and
`stream`.

Counterpart of tpudab.host.cli's subcommands of the same names, with the
same flags plus --device:
- decode: a raw IQ capture (u8, s8, s16 or f32 interleaved, 2.048 MS/s)
  is acquired, demodulated and decoded by the OfflinePipeline (with
  --device-step, the fused ReceiveStep once the FIC has found the layout);
  --checkpoint saves the state at the end, --resume continues from it on
  the remainder of the capture; --config reads a RadioConfig JSON;
- decode-bits: a raw post-OFDM soft-bit file (one transmission frame =
  nb_frame_bits values) goes through the Receiver;
- synth: tpudab's demo capture (an MP2 and a DAB+ service of tones, with
  a dynamic label and a slideshow, impaired), byte-equal to tpudab's; it
  needs FFmpeg's encoders and writes nothing without them;
- info: the acquisition of a capture's first four frames;
- stream: the live loop. The native reader thread (host/native_lib.py)
  reads an IQ file, or stdin for `-`, into a ring; the StreamingRadio
  acquires, tracks and decodes it batch by batch (through the fused
  ReceiveStep by default on a CUDA device: --device-step or
  --no-device-step force a path); the audio mix goes to --wav and, with
  --play, to the sound card, under the ANSI dashboard and its keys unless
  --no-dashboard. With --tcp HOST:PORT the source is an rtl_tcp server
  (host/rtl_tcp.py): the dongle is tuned to --channel before the first
  read and the dashboard's </> keys retune it live.
decode and decode-bits print the FIC database listing and write the DAB+
access units (subch<N>.aac.raw, each AU behind its 4-byte little-endian
length), the MP2 frames (subch<N>.mp2), their PCM (subch<N>.wav, where the
codec probe of host/native_lib.py finds FFmpeg) and the slideshow images to
--out-dir.

    python -m tpudab_torch.host.cli decode CAPTURE --device-step --out-dir D
    python -m tpudab_torch.host.cli decode-bits FILE --bits-format f32 --out-dir D
    python -m tpudab_torch.host.cli info CAPTURE --device cpu   # plain twins
    python -m tpudab_torch.host.cli synth CAPTURE --seconds 2
    python -m tpudab_torch.host.cli stream CAPTURE --no-dashboard --wav mix.wav
    python -m tpudab_torch.host.cli stream --tcp HOST:PORT --channel 12C
    cat CAPTURE | python -m tpudab_torch.host.cli stream - --device cpu

--device defaults to cuda, and a missing GPU is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device "
                         f"(use --device cpu for the plain torch decoders)")
    return device


def _load_iq(path: str, fmt: str) -> np.ndarray:
    raw = np.fromfile(path, dtype={"u8": np.uint8, "s8": np.int8,
                                   "s16": np.int16, "f32": np.float32}[fmt])
    if fmt == "u8":
        x = (raw.astype(np.float32) - 127.5) / 128.0
    elif fmt == "s8":
        x = raw.astype(np.float32) / 128.0
    elif fmt == "s16":
        x = raw.astype(np.float32) / 32768.0
    else:
        x = raw
    return (x[0::2] + 1j * x[1::2]).astype(np.complex64)


def _print_db(receiver) -> None:
    from tpudab_torch.constants.provenance import caveats_for_subchannel
    from tpudab_torch.constants.puncture import uep_index_order
    from tpudab_torch.constants.tables import programme_type_str

    db = receiver.db
    e = db.ensemble
    print(f"Ensemble: {e.label!r}  EId=0x{e.ensemble_id:04X}  ECC=0x{e.ecc:02X}"
          f"  country={e.country}")
    if receiver.updater.misc.datetime_utc:
        print(f"Time: {receiver.updater.misc.datetime_utc}")
    print(f"{'SId':>8}  {'Label':<18} {'PTy':<20} {'SubCh':>5} {'Prot':<8}"
          f" {'kbps':>4}  Type")
    for sid, svc in sorted(db.services.items()):
        for comp in db.components_of(sid):
            sub = db.subchannels.get(comp.subch_id) if comp.subch_id is not None else None
            prot = sub.protection_label if sub else "?"
            br = sub.bitrate_kbps if sub else "?"
            kind = ("DAB+" if comp.is_dab_plus else
                    "DAB" if comp.is_audio else f"data({comp.transport_mode.name})")
            print(f"  0x{sid:04X}  {svc.label:<18} {programme_type_str(svc.programme_type):<20}"
                  f" {comp.subch_id if comp.subch_id is not None else '-':>5}"
                  f" {prot:<8} {br:>4}  {kind}")
    stats = receiver.updater.stats
    print(f"DB: total={stats.total} completed={stats.completed} "
          f"updates={stats.updates} conflicts={stats.conflicts}")
    caveats = set()
    for sub in db.subchannels.values():
        br = pl = None
        if sub.is_uep and 0 <= sub.uep_index < 64:
            br, pl = uep_index_order()[sub.uep_index]
        caveats.update(caveats_for_subchannel(sub.is_uep, receiver.mode,
                                              bitrate_kbps=br,
                                              protection_level=pl))
    for c in sorted(caveats):
        print(f"note: {c}")
    for sid, cal in sorted(receiver.uep_calibrations.items()):
        print(f"subch {sid}: {cal.summary()}")


def _dump_slides_and_labels(receiver, out_dir: str) -> None:
    """Save decoded slideshow images and print dynamic labels."""
    ext = {0: "gif", 1: "jpg", 2: "bmp", 3: "png"}
    for subch_id, ch in receiver.channels.items():
        mgr = getattr(ch, "slideshow", None)
        if mgr is not None:
            for slide in mgr.slides:
                name = slide.name or f"slide_{slide.transport_id}"
                name = name.replace("/", "_")
                if "." not in name:
                    name += "." + ext.get(slide.subtype, "bin")
                path = os.path.join(out_dir, f"subch{subch_id}_{name}")
                with open(path, "wb") as f:
                    f.write(slide.data)
                print(f"subch {subch_id}: slideshow -> {path}")
        dl = getattr(ch, "dynamic_label", "")
        if dl:
            print(f"subch {subch_id}: dynamic label: {dl!r}")


def _dump_audio(acc: Dict, out_dir: str) -> None:
    """tpudab's _dump_audio: the AUs and MP2 frames as files, and their PCM
    as subch<N>.wav where the codecs are available."""
    from tpudab_torch.audio.codecs import (AACDecoder, CodecUnavailable, MP2Decoder,
                                           aac_decode_available, mp2_decode_available)
    for subch_id, outs in acc.items():
        is_plus = outs[0].is_dab_plus if outs else True
        if is_plus:
            aus, header = [], None
            for o in outs:
                for sf in o.superframes:
                    header = sf.header or header
                    aus.extend(sf.access_units)
            if not aus:
                continue
            raw_path = os.path.join(out_dir, f"subch{subch_id}.aac.raw")
            with open(raw_path, "wb") as f:
                for au in aus:
                    f.write(len(au).to_bytes(4, "little") + au)
            print(f"subch {subch_id}: {len(aus)} AAC AUs -> {raw_path}")
            if header is not None and aac_decode_available():
                try:
                    dec = AACDecoder(header)
                except CodecUnavailable as e:
                    print(f"subch {subch_id}: AAC PCM decode unavailable ({e})")
                    continue
                pcm = []
                for au in aus:
                    try:
                        p = dec.decode(bytes(au))
                    except ValueError:
                        continue  # skip undecodable AUs, keep the stream
                    if p.shape[0]:
                        pcm.append(p)
                _write_pcm(subch_id, pcm, out_dir, dec.sample_rate or header.sampling_rate)
        else:
            frames = [fr for o in outs for fr in o.mp2_frames]
            if not frames:
                continue
            mp2_path = os.path.join(out_dir, f"subch{subch_id}.mp2")
            with open(mp2_path, "wb") as f:
                for fr in frames:
                    f.write(fr)
            print(f"subch {subch_id}: {len(frames)} MP2 frames -> {mp2_path}")
            if mp2_decode_available():
                dec = MP2Decoder()
                pcm = [dec.decode(fr) for fr in frames]
                _write_pcm(subch_id, [p for p in pcm if p.shape[0]], out_dir,
                           dec.sample_rate or 48000)


def _write_pcm(subch_id: int, pcm, out_dir: str, rate: int) -> None:
    if not pcm:
        return
    wav = WavFromPCM(os.path.join(out_dir, f"subch{subch_id}.wav"), rate)
    for p in pcm:
        wav.write(p)
    wav.close()
    print(f"subch {subch_id}: decoded PCM -> subch{subch_id}.wav")


class WavFromPCM:
    """A 16-bit WAV of decoded PCM, its channel count taken from the first
    block."""

    def __init__(self, path: str, rate: int):
        import wave
        self._w = wave.open(path, "wb")
        self._rate = rate
        self._opened = False

    def write(self, pcm: np.ndarray) -> None:
        if not self._opened:
            self._w.setnchannels(pcm.shape[1] if pcm.ndim > 1 else 1)
            self._w.setsampwidth(2)
            self._w.setframerate(self._rate)
            self._opened = True
        self._w.writeframes(np.ascontiguousarray(pcm, dtype=np.int16).tobytes())

    def close(self) -> None:
        self._w.close()


def _load_config(args):
    """--config JSON (ConfigManager): file values fill in anything not
    explicitly set on the command line."""
    if not getattr(args, "config", None):
        return None
    from tpudab_torch.host.config import ConfigManager
    return ConfigManager(args.config)


def cmd_decode(args) -> int:
    from tpudab_torch.models.pipeline import OfflinePipeline

    device = _device(args)
    mgr = _load_config(args)
    mode, batch = args.mode, args.batch_frames
    sync_cfg = None
    if mgr is not None:
        mode = mgr.config.mode if args.mode == 1 else args.mode
        batch = mgr.config.batch_frames if args.batch_frames == 8 else batch
        sync_cfg = mgr.config.sync_config()

    iq = _load_iq(args.path, args.format)
    print(f"Loaded {iq.shape[0]} samples ({iq.shape[0] / 2.048e6:.2f} s)")
    kw = {"sync_cfg": sync_cfg} if sync_cfg is not None else {}
    pipe = OfflinePipeline(mode=mode, batch_frames=batch,
                           use_device_step=args.device_step, device=device, **kw)
    if args.resume:
        from tpudab_torch.models.checkpoint import pipeline_restore
        pipeline_restore(pipe, args.resume)
        print(f"Resumed from {args.resume} "
              f"(net_freq={pipe.stats.net_freq_hz:+.1f} Hz)")
    acc = pipe.run(iq)
    receiver, stats = pipe.receiver, pipe.stats
    if args.checkpoint:
        from tpudab_torch.models.checkpoint import pipeline_checkpoint
        pipeline_checkpoint(pipe, args.checkpoint)
        print(f"Checkpoint -> {args.checkpoint} (next_pos={stats.next_pos})")
    print(f"Sync: frame_start={stats.frame_start} "
          f"net_freq={stats.net_freq_hz:+.1f} Hz "
          f"frames={stats.total_frames} desync={stats.total_frames_desync}")
    print(f"FIC: {receiver.stats['fibs']} FIBs, "
          f"{receiver.stats['fib_crc_errors']} CRC errors")
    _print_db(receiver)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        _dump_audio(acc, args.out_dir)
        _dump_slides_and_labels(receiver, args.out_dir)
    return 0


def cmd_info(args) -> int:
    from tpudab_torch.ofdm.sync_device import acquire_host

    device = _device(args)
    iq = _load_iq(args.path, args.format)
    res = acquire_host(iq[: min(iq.shape[0], 4 * 196608)], device=device)
    for k, v in res.items():
        print(f"{k}: {v}")
    return 0


def cmd_decode_bits(args) -> int:
    """Decode a raw soft-bit stream (post-OFDM), skipping the front end.
    Formats: s8 (viterbi_bit_t: positive = bit 1, negated into the
    package's sign convention), u8 (hard bits 0/1), f32 (soft: positive =
    bit 0)."""
    from tpudab_torch.constants.dab_params import get_dab_params
    from tpudab_torch.models.receiver import Receiver

    device = _device(args)
    dab = get_dab_params(args.mode)
    raw = np.fromfile(args.path, dtype={"s8": np.int8, "u8": np.uint8,
                                        "f32": np.float32}[args.bits_format])
    nf = raw.shape[0] // dab.nb_frame_bits
    if nf == 0:
        print(f"need at least {dab.nb_frame_bits} values per frame")
        return 1
    frames = raw[: nf * dab.nb_frame_bits].reshape(nf, dab.nb_frame_bits)
    if args.bits_format == "s8":
        soft = -frames.astype(np.float32)       # viterbi_bit_t: + = bit 1
    elif args.bits_format == "u8":
        soft = 1.0 - 2.0 * frames.astype(np.float32)
    else:
        soft = frames.astype(np.float32)

    receiver = Receiver(args.mode, device)
    acc: Dict[int, list] = {}
    batch = max(1, args.batch_frames)
    for lo in range(0, nf, batch):
        outputs = receiver.process_frame_bits(soft[lo: lo + batch])
        for sid, out in outputs.items():
            acc.setdefault(sid, []).append(out)
    for sid, out in receiver.finalize().items():
        acc.setdefault(sid, []).append(out)

    print(f"decoded {nf} frames of soft bits")
    print(f"FIC: {receiver.stats['fibs']} FIBs, "
          f"{receiver.stats['fib_crc_errors']} CRC errors")
    _print_db(receiver)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        _dump_audio(acc, args.out_dir)
        _dump_slides_and_labels(receiver, args.out_dir)
    return 0


def cmd_synth(args) -> int:
    """tpudab's demo capture: one ensemble with an MP2 service (128 kbps,
    UEP PL3) and a DAB+ service (96 kbps EEP 3-A) carrying a dynamic label
    and a slideshow, both of tones from the codec shim's encoders, through
    the impairments (CFO --cfo, AWGN --snr), written as f32 interleaved IQ
    at 2.048 MS/s. Byte-equal to tpudab's synth with the same flags. The
    encoders need FFmpeg: without it this writes nothing and fails."""
    from tpudab_torch.host.native_lib import ffmpeg_probe
    from tpudab_torch.synth import (ASCTY_DAB, ASCTY_DAB_PLUS, EnsembleSpec,
                                    EnsembleSynthesizer, Impairments, ServiceSpec,
                                    SubchannelSpec, apply_impairments, modulate_frame_bits)
    from tpudab_torch.synth.payload import demo_dabplus_stream, mp2_tone_stream

    found, what = ffmpeg_probe()
    if not found:
        print(f"error: encoder mp2 unavailable (no FFmpeg: {what}); no capture written",
              file=sys.stderr)
        return 1
    n_frames = max(2, int(args.seconds / 0.096))
    n_logical = n_frames * 4 + 20
    mp2_rate = 128
    plus_rate = 96  # EEP 3-A, 72 CU
    spec = EnsembleSpec(
        ensemble_id=0xCE15, label="TPU DAB Demo",
        services=[
            ServiceSpec(0xC221, "Tone Radio", [(0, ASCTY_DAB, 1)], programme_type=10),
            ServiceSpec(0xC222, "Chirp DAB+", [(0, ASCTY_DAB_PLUS, 2)], programme_type=12),
        ],
        subchannels=[
            SubchannelSpec(1, start_cu=0, size_cu=96, protection=("uep", mp2_rate, 3)),
            SubchannelSpec(2, start_cu=96, size_cu=72, protection=("eep", 3, 0)),
        ])
    synth = EnsembleSynthesizer(spec, seed=1)
    mp2 = mp2_tone_stream(mp2_rate, n_logical)
    plus, _ = demo_dabplus_stream(plus_rate, n_logical)
    synth.payload_fn[1] = lambda m: mp2[m].tobytes()
    synth.payload_fn[2] = lambda m: plus[m].tobytes()

    iq = np.concatenate([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)])
    iq = apply_impairments(iq, Impairments(freq_offset_hz=args.cfo, snr_db=args.snr, seed=2))
    inter = np.empty(iq.shape[0] * 2, dtype=np.float32)
    inter[0::2] = iq.real
    inter[1::2] = iq.imag
    inter.tofile(args.path)
    print(f"Wrote {n_frames} frames ({n_frames * 0.096:.2f} s) to {args.path} "
          f"(f32 interleaved, 2.048 MS/s)")
    return 0


def cmd_stream(args) -> int:
    """Live pipeline: native reader thread (a file, stdin or an rtl_tcp
    socket) -> ring -> StreamingRadio -> audio mix (+ optional WAV, +
    optional playback) with the ANSI dashboard and its keys. With --tcp the
    native rtl_tcp client tunes the remote dongle to --channel (5A by
    default) before the first read, and the </> keys retune live."""
    from tpudab_torch.audio.pipeline import AudioPipeline, WavSink
    from tpudab_torch.host.controls import KeyController
    from tpudab_torch.host.dashboard import Dashboard
    from tpudab_torch.host.native_lib import IQReader
    from tpudab_torch.host.streaming import StreamingRadio

    device = _device(args)
    mgr = _load_config(args)
    mode, batch = args.mode, args.batch_frames
    channel = args.channel   # the label a tuner is, or would be, on
    radio_kw = {}
    if mgr is not None:
        c = mgr.config
        mode = c.mode if args.mode == 1 else args.mode
        batch = c.batch_frames if args.batch_frames == 4 else batch
        channel = channel or c.channel
        radio_kw = {"sync_cfg": c.sync_config(),
                    "desync_threshold": c.desync_threshold,
                    "is_coarse_freq_correction": c.is_coarse_freq_correction,
                    "coarse_check_interval": c.coarse_check_interval}
    if args.device_step is not None:
        radio_kw["use_device_step"] = args.device_step

    reader = tuner = None
    if args.tcp:
        from tpudab_torch.constants.channels import channel_freq_hz
        from tpudab_torch.host.rtl_tcp import TcpSource
        host, _, port = args.tcp.rpartition(":")
        channel = channel or "5A"
        tuner = TcpSource(host or "127.0.0.1", int(port), freq_hz=channel_freq_hz(channel))
        ring = tuner.ring
        radio_kw["tuner"] = tuner
    elif args.path:
        reader = IQReader(args.path, fmt=args.format)
        ring = reader.ring
    else:
        print("error: an IQ path (or --tcp host:port) is required", file=sys.stderr)
        return 2
    audio = AudioPipeline(48_000 if mgr is None else mgr.config.sink_sample_rate)
    if mgr is not None:
        audio.global_gain = mgr.config.global_gain
    wav = WavSink(args.wav, audio.sink_rate) if args.wav else None
    radio = StreamingRadio(ring.read_complex64, mode=mode, batch_frames=batch,
                           audio_pipeline=audio, channel=channel, device=device, **radio_kw)
    controls = KeyController(radio.receiver, audio, radio=radio, config_manager=mgr)
    dash = None if args.no_dashboard else Dashboard(
        radio.receiver, radio.stats, audio, controls=controls, timers=radio.timers)
    sink = None
    if args.play:
        from tpudab_torch.audio.sink import PlaybackSink
        try:
            sink = PlaybackSink(audio).start()
        except RuntimeError as e:   # no aplay/pacat/play on this host
            print(f"audio playback unavailable ({e}); continuing without", file=sys.stderr)

    def on_outputs(outputs):
        if sink is None:
            # no live sink: drain the mix at signal rate into the WAV
            mixed = audio.mix(int(48_000 * 0.096 * args.batch_frames))
            if wav is not None:
                wav.write(mixed)
        if not controls.poll():
            radio.request_stop()
        if dash is not None:
            dash.update()

    try:
        radio.run(on_outputs=on_outputs)
    except KeyboardInterrupt:
        pass
    finally:
        controls.close()
        if reader is not None:
            reader.close()
        if tuner is not None:
            tuner.close()
        if sink is not None:
            sink.stop()
        if wav is not None:
            wav.close()
    if dash is not None:
        dash.update(force=True)
    print(f"\nstopped: {radio.stats.total_frames} frames, "
          f"{radio.stats.reacquisitions} reacquisitions")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpudab_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default cuda; cpu runs the plain torch decoders)"

    d = sub.add_parser("decode", help="decode an IQ capture")
    d.add_argument("path")
    d.add_argument("--format", choices=["u8", "s8", "s16", "f32"], default="f32")
    d.add_argument("--mode", type=int, default=1)
    d.add_argument("--batch-frames", type=int, default=8)
    d.add_argument("--out-dir", default=None)
    d.add_argument("--device-step", action="store_true",
                   help="decode via the fused receive step once the FIC has the layout")
    d.add_argument("--config", default=None,
                   help="JSON RadioConfig (ConfigManager, autosaved)")
    d.add_argument("--checkpoint", default=None,
                   help="save resumable pipeline state here at end of run")
    d.add_argument("--resume", default=None,
                   help="restore state saved by --checkpoint; the input file "
                        "must be the remainder of the capture "
                        "(split at the reported next_pos)")
    d.add_argument("--device", default="cuda", help=device_help)
    d.set_defaults(fn=cmd_decode)

    db = sub.add_parser("decode-bits", help="decode a raw soft-bit file (post-OFDM)")
    db.add_argument("path")
    db.add_argument("--bits-format", choices=("s8", "u8", "f32"), default="s8",
                    help="s8 = upstream viterbi_bit_t (positive = bit 1)")
    db.add_argument("--mode", type=int, default=1)
    db.add_argument("--batch-frames", type=int, default=8)
    db.add_argument("--out-dir")
    db.add_argument("--device", default="cuda", help=device_help)
    db.set_defaults(fn=cmd_decode_bits)

    sy = sub.add_parser("synth", help="synthesize a demo ensemble capture")
    sy.add_argument("path")
    sy.add_argument("--seconds", type=float, default=3.0)
    sy.add_argument("--snr", type=float, default=25.0)
    sy.add_argument("--cfo", type=float, default=1500.0)
    sy.add_argument("--audio", choices=["mp2"], default="mp2")
    sy.set_defaults(fn=cmd_synth)

    i = sub.add_parser("info", help="acquisition info for a capture")
    i.add_argument("path")
    i.add_argument("--format", choices=["u8", "s8", "s16", "f32"], default="f32")
    i.add_argument("--device", default="cuda", help=device_help)
    i.set_defaults(fn=cmd_info)
    st = sub.add_parser("stream", help="streaming decode with live dashboard")
    st.add_argument("path", nargs="?", default=None,
                    help="IQ file or '-' for stdin (omit with --tcp)")
    st.add_argument("--format", choices=["u8", "s8", "s16", "f32"], default="f32")
    st.add_argument("--tcp", default=None, metavar="HOST:PORT",
                    help="live rtl_tcp source (tunes to --channel)")
    st.add_argument("--channel", default=None, metavar="LABEL",
                    help="Band III channel label (5A..13F), e.g. 12C")
    st.add_argument("--mode", type=int, default=1)
    st.add_argument("--batch-frames", type=int, default=4)
    st.add_argument("--device-step", action="store_true", default=None, dest="device_step",
                    help="force the fused receive step decode path "
                         "(default: on for a CUDA device)")
    st.add_argument("--no-device-step", action="store_false", dest="device_step",
                    help="force the host per-stage decode path")
    st.add_argument("--wav", default=None, help="write mixed audio to WAV")
    st.add_argument("--play", action="store_true",
                    help="real-time playback via aplay/pacat (PlaybackSink)")
    st.add_argument("--no-dashboard", action="store_true")
    st.add_argument("--config", default=None,
                    help="JSON RadioConfig (ConfigManager, autosaved)")
    st.add_argument("--device", default="cuda", help=device_help)
    st.set_defaults(fn=cmd_stream)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

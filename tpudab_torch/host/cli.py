"""Command line of the port: the `decode-bits` entry point.

Counterpart of tpudab.host.cli's decode-bits: a raw post-OFDM soft-bit file
(one transmission frame = nb_frame_bits values) goes through the Receiver
and comes out as the FIC database listing, the DAB+ access units
(subch<N>.aac.raw, each AU behind its 4-byte little-endian length), the
MP2 frames (subch<N>.mp2), the slideshow images and the dynamic labels.
PCM/WAV output (tpudab's native codec shim) is not ported yet.

    python -m tpudab_torch.host.cli decode-bits FILE --bits-format f32 --out-dir D
    python -m tpudab_torch.host.cli decode-bits FILE --device cpu   # plain twins

--device defaults to cuda, and a missing GPU is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch


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
    """The raw-file half of tpudab's _dump_audio: AUs and MP2 frames."""
    for subch_id, outs in acc.items():
        is_plus = outs[0].is_dab_plus if outs else True
        if is_plus:
            aus = [au for o in outs for sf in o.superframes for au in sf.access_units]
            if not aus:
                continue
            raw_path = os.path.join(out_dir, f"subch{subch_id}.aac.raw")
            with open(raw_path, "wb") as f:
                for au in aus:
                    f.write(len(au).to_bytes(4, "little") + au)
            print(f"subch {subch_id}: {len(aus)} AAC AUs -> {raw_path}")
        else:
            frames = [fr for o in outs for fr in o.mp2_frames]
            if not frames:
                continue
            mp2_path = os.path.join(out_dir, f"subch{subch_id}.mp2")
            with open(mp2_path, "wb") as f:
                for fr in frames:
                    f.write(fr)
            print(f"subch {subch_id}: {len(frames)} MP2 frames -> {mp2_path}")


def cmd_decode_bits(args) -> int:
    """Decode a raw soft-bit stream (post-OFDM), skipping the front end.
    Formats: s8 (viterbi_bit_t: positive = bit 1, negated into the
    package's sign convention), u8 (hard bits 0/1), f32 (soft: positive =
    bit 0)."""
    from tpudab_torch.constants.dab_params import get_dab_params
    from tpudab_torch.models.receiver import Receiver

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device "
                         f"(use --device cpu for the plain torch decoders)")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpudab_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    db = sub.add_parser("decode-bits", help="decode a raw soft-bit file (post-OFDM)")
    db.add_argument("path")
    db.add_argument("--bits-format", choices=("s8", "u8", "f32"), default="s8",
                    help="s8 = upstream viterbi_bit_t (positive = bit 1)")
    db.add_argument("--mode", type=int, default=1)
    db.add_argument("--batch-frames", type=int, default=8)
    db.add_argument("--out-dir")
    db.add_argument("--device", default="cuda",
                    help="torch device of the FEC (default cuda; cpu runs the "
                         "plain torch decoders)")
    db.set_defaults(fn=cmd_decode_bits)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

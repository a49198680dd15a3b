"""Subchannel payloads for synthesised captures, without jax.

dabplus_stream builds a DAB+ subchannel's logical frames from superframes
of seeded random access units (tpudab_torch.audio.superframe's
build_superframe), optionally each AU led by a PAD DSE that carries a
dynamic label and an MOT slideshow image, as tpudab's demo synthesiser
puts them (tpudab/host/cli.py::_dabplus_stream) but with random bytes in
place of AAC. The AUs come back too, so a receiver's output can be held
against them. demo_dabplus_stream fills the superframes with real AAC, a
tone through the codec shim's encoder (audio/codecs.py, which needs
FFmpeg), with or without that PAD: with it, it is tpudab's demo
synthesiser's DAB+ service; mp2_tone_stream is that synthesiser's MP2
service. The `synth` subcommand (host/cli.py) puts the two in one
ensemble.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tpudab_torch.audio.superframe import (FRAMES_PER_SUPERFRAME, SuperFrameHeader,
                                           build_superframe, header_size_bytes)

DEMO_LABEL = "tpudab demo - Now Playing: Chirp"


def pad_events() -> List[list]:
    """One X-PAD content list per AU: the label's segments, then the MOT
    groups of a small PNG slide, 48 bytes per subfield."""
    from tpudab_torch.mot.imagemeta import TINY_PNG
    from tpudab_torch.mot.mot import ContentType, MOTObject, build_mot_object_groups
    from tpudab_torch.pad.xpad import (APP_DYNAMIC_LABEL_START, APP_MOT_CONT,
                                       APP_MOT_START, build_dynamic_label_segments)

    events = [[(APP_DYNAMIC_LABEL_START, s)] for s in build_dynamic_label_segments(DEMO_LABEL)]
    obj = MOTObject(transport_id=1, content_type=ContentType.IMAGE,
                    content_subtype=3, body=TINY_PNG, content_name="demo.png")
    for g in build_mot_object_groups(obj, segment_size=128):
        framed = bytes([(len(g) >> 8) & 0x3F, len(g) & 0xFF]) + g
        parts = [framed[i:i + 48] for i in range(0, len(framed), 48)]
        events.extend([(APP_MOT_START if j == 0 else APP_MOT_CONT, p)]
                      for j, p in enumerate(parts))
    return events


def dabplus_stream(bitrate: int, n_logical: int, seed: int,
                   with_pad: bool = False) -> Tuple[np.ndarray, List[bytes]]:
    """(n_logical, 3 * bitrate) uint8 logical frames of a DAB+ subchannel,
    and the AUs of its superframes in order. Each superframe (48 kHz, no
    SBR: 6 AUs) is filled exactly: the AUs share the room left by the
    header and the AU CRCs."""
    from tpudab_torch.pad.xpad import build_xpad_into_au

    rng = np.random.default_rng(seed)
    hdr = SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0,
                           mpeg_surround=0)
    n_aus = hdr.num_aus
    avail = 110 * bitrate // 8 - header_size_bytes(n_aus) - 2 * n_aus
    events = pad_events() if with_pad else []
    frames, all_aus = [], []
    for k in range(n_logical // FRAMES_PER_SUPERFRAME + 1):
        dses = [build_xpad_into_au(b"", events[(k * n_aus + i) % len(events)])
                if events else b"" for i in range(n_aus)]
        room = avail - sum(len(d) for d in dses)
        sizes = [room // n_aus] * (n_aus - 1) + [room - (n_aus - 1) * (room // n_aus)]
        aus = [d + rng.integers(0, 256, s).astype(np.uint8).tobytes()
               for d, s in zip(dses, sizes)]
        all_aus.extend(aus)
        frames.append(build_superframe(hdr, aus, bitrate))
    stream = np.concatenate(frames).reshape(-1, 3 * bitrate)
    return stream[:n_logical], all_aus


def mp2_tone_stream(bitrate: int, n_logical: int) -> np.ndarray:
    """(n_logical, 3 * bitrate) uint8 logical frames of an MP2 subchannel:
    MP2 of a stereo tone swept about 440 Hz (the codec shim's encoder,
    audio/codecs.py, which needs FFmpeg); tpudab's synth's MP2 service
    (tpudab/host/cli.py::_mp2_tone_stream)."""
    from tpudab_torch.audio.codecs import MP2Encoder

    enc = MP2Encoder(48000, 2, bitrate)
    need = n_logical * bitrate * 3
    pcm_t = np.arange(enc.frame_size)
    packets = b""
    phase = 0.0
    while len(packets) < need:
        f_hz = 440.0 * (1 + 0.5 * np.sin(phase / 40))
        tone = (9000 * np.sin(2 * np.pi * f_hz * pcm_t / 48000)).astype(np.int16)
        packets += enc.encode(np.stack([tone, tone], axis=1))
        phase += 1
    enc.close()
    return np.frombuffer(packets[:need], dtype=np.uint8).reshape(n_logical, bitrate * 3)


def demo_dabplus_stream(bitrate: int, n_logical: int,
                        with_pad: bool = True) -> Tuple[np.ndarray, List[bytes]]:
    """(n_logical, 3 * bitrate) uint8 logical frames of a DAB+ subchannel
    whose AUs are AAC-LC packets (64 kbps, the codec shim's encoder, which
    needs FFmpeg) of a stereo tone swept about 550 Hz, 8,000 peak, and the
    AUs of its superframes in order. The last AU of each superframe is
    padded with zeros to fill it.

    with_pad: each AU is led by a PAD DSE carrying the demo's dynamic label
    and slideshow (pad_events), dropped from a superframe they would
    overflow: tpudab's synth's DAB+ service (tpudab/host/cli.py::
    _dabplus_stream), byte for byte. Without PAD the AUs are the packets
    alone, the encoder's empty ones (its priming) left out: an empty AU
    would flush the decoder."""
    from tpudab_torch.audio.codecs import _ShimEncoder
    from tpudab_torch.pad.xpad import build_xpad_into_au

    hdr = SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0,
                           mpeg_surround=0)
    enc = _ShimEncoder("aac", 48000, 2, 64_000)
    pcm_t = np.arange(enc.frame_size)
    events = pad_events() if with_pad else []
    avail = 110 * bitrate // 8 - header_size_bytes(hdr.num_aus)
    phase, ev = 0.0, 0

    def packet() -> bytes:
        nonlocal phase
        f_hz = 550.0 * (1 + 0.4 * np.sin(phase / 25))
        tone = (8000 * np.sin(2 * np.pi * f_hz * pcm_t / 48000)).astype(np.int16)
        phase += 1
        return enc.encode(np.stack([tone, tone], axis=1))

    frames, all_aus = [], []
    for _ in range(n_logical // FRAMES_PER_SUPERFRAME + 1):
        if with_pad:
            aus = []
            for _ in range(hdr.num_aus):
                aus.append((build_xpad_into_au(b"", events[ev % len(events)]), packet()))
                ev += 1
            bare = [p for _, p in aus]
            aus = [d + p for d, p in aus]
            if sum(len(a) + 2 for a in aus) > avail:
                aus = bare          # never truncate the AAC: drop the PAD DSEs
        else:
            aus = []
            while len(aus) < hdr.num_aus:
                pkt = packet()
                if pkt:
                    aus.append(pkt)
        slack = avail - sum(len(a) + 2 for a in aus)
        if slack < 0:
            raise ValueError(f"64 kbps AAC overflows a {bitrate} kbps superframe")
        aus[-1] = aus[-1] + b"\x00" * slack
        all_aus.extend(aus)
        frames.append(build_superframe(hdr, aus, bitrate))
    enc.close()
    stream = np.concatenate(frames).reshape(-1, 3 * bitrate)
    return stream[:n_logical], all_aus

"""Subchannel payloads: DAB+ streams of superframes filled with seeded
random access units, optionally each AU led by a PAD DSE carrying a
dynamic label and an MOT slideshow image (a frozen copy of
tpudab_torch.synth.payload's dabplus_stream and pad_events). The AUs come
back too, so a receiver's output can be held against them."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from benchmark.synth.pad import (APP_DYNAMIC_LABEL_START, APP_MOT_CONT, APP_MOT_START,
                                 IMAGE, IMAGE_PNG, TINY_PNG, build_dynamic_label_segments,
                                 build_mot_object_groups, build_xpad_into_au)
from benchmark.synth.superframe import (FRAMES_PER_SUPERFRAME, SuperFrameHeader,
                                        build_superframe, header_size_bytes)

DEMO_LABEL = "tpudab demo - Now Playing: Chirp"


def pad_events() -> List[list]:
    """One X-PAD content list per AU: the label's segments, then the MOT
    groups of a small PNG slide, 48 bytes per subfield."""
    events = [[(APP_DYNAMIC_LABEL_START, s)] for s in build_dynamic_label_segments(DEMO_LABEL)]
    for g in build_mot_object_groups(1, IMAGE, IMAGE_PNG, TINY_PNG, "demo.png",
                                     segment_size=128):
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

"""Receiver: frame soft bits -> FIC database + per-subchannel audio/data.

Counterpart of tpudab.models.receiver, the host per-stage path behind
`decode-bits`. process_frame_bits runs the FIC decode and spawns channel
decoders as the database discovers subchannels; on_audio_channel fires
when a new audio subchannel goes live. A Receiver lives on one device:
each batch of soft bits moves there once, and the FIC and every
subchannel's CIF slices are cut from it there; the FEC runs there
(kernels K1 + K3 and K4 on CUDA) and the bytes come back to the host for
the database, superframe, MP2, PAD, MOT and packet parsers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpudab_torch.constants.dab_params import get_dab_params, CIF_BITS, CU_BITS
from tpudab_torch.audio.mp2 import DABChannel
from tpudab_torch.audio.superframe import DABPlusChannel, SuperFrameResult
from tpudab_torch.database.entities import AudioServiceType, TransportMode
from tpudab_torch.database.updater import DatabaseUpdater
from tpudab_torch.fec.crc import check_fib_crc
from tpudab_torch.fic.fib import decode_fic_frame
from tpudab_torch.fic.fig_parser import parse_fib
from tpudab_torch.msc.subchannel import SubchannelConfig, SubchannelDecoder
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class AudioChannelOutput:
    """Per-frame-batch output for one audio/data subchannel."""

    subch_id: int
    is_dab_plus: bool
    superframes: List[SuperFrameResult] = dataclasses.field(default_factory=list)
    mp2_frames: List[bytes] = dataclasses.field(default_factory=list)
    data_groups: List[bytes] = dataclasses.field(default_factory=list)
    raw_frames: Optional[np.ndarray] = None  # decoded logical frames (bytes)


def _attach_controls(ch) -> None:
    """Per-channel controls: play audio, decode audio, decode data."""
    ch.is_play_audio = True
    ch.is_decode_audio = True
    ch.is_decode_data = True


class DataPacketChannel:
    """Packet-mode data subchannel: packets -> MOT -> slideshow."""

    def __init__(self, packet_address: Optional[int] = None):
        from tpudab_torch.data.packet import PacketChannel
        from tpudab_torch.mot.slideshow import SlideshowManager

        self.slideshow = SlideshowManager()
        self.packets = PacketChannel(address=packet_address,
                                     on_data_group=self.slideshow.push_data_group)
        self.stats = self.packets.stats

    def process_frames(self, frames: np.ndarray) -> List[bytes]:
        return self.packets.process_bytes(
            np.asarray(frames, dtype=np.uint8).tobytes())


class Receiver:
    """Consumes transmission-frame soft bits; maintains DB + channel decoders.

    process_frame_bits() accepts a batch (F, nb_frame_bits) of soft bits
    (numpy or a tensor) and returns {subch_id: AudioChannelOutput} for
    running channels. device is where the FEC runs: "cuda" (the default)
    the kernels, "cpu" the plain torch twins; no card is an error.
    """

    def __init__(self, mode: int = 1, device=DEFAULT_DEVICE,
                 on_audio_channel: Optional[Callable] = None,
                 decode_audio: bool = True):
        self.mode = mode
        self.device = resolve_device(device)
        self.dab = get_dab_params(mode)
        self.updater = DatabaseUpdater()
        self.on_audio_channel = on_audio_channel
        self.decode_audio = decode_audio
        self.subch_decoders: Dict[int, SubchannelDecoder] = {}
        self.channels: Dict[int, object] = {}       # DABPlusChannel | DABChannel
        self.channel_is_dabplus: Dict[int, bool] = {}
        self.stats = {"frames": 0, "fib_crc_errors": 0, "fibs": 0}

    @property
    def db(self):
        return self.updater.db

    @property
    def uep_calibrations(self):
        """{subch_id: CalibrationResult} for subchannels whose budget-solved
        UEP row was self-calibrated online (fec/uep_calibrate.py)."""
        return {sid: d.calibration
                for sid, d in self.subch_decoders.items()
                if d.calibration is not None}

    # ---------------- channel management ----------------

    def _refresh_channels(self) -> None:
        """Spawn decoders for newly-complete audio subchannels in the DB."""
        db = self.db
        for comp in db.service_components.values():
            if comp.subch_id is None or comp.subch_id in self.subch_decoders:
                continue
            sub = db.subchannels.get(comp.subch_id)
            if sub is None or (sub.size_cu == 0 and not sub.is_uep):
                continue
            try:
                cfg = SubchannelConfig.from_db(sub)
            except (ValueError, KeyError, AssertionError):
                continue
            self.subch_decoders[comp.subch_id] = SubchannelDecoder(cfg, self.device)
            bitrate = sub.bitrate_kbps
            if comp.transport_mode == TransportMode.STREAM_AUDIO and bitrate:
                is_plus = comp.audio_type == AudioServiceType.DAB_PLUS
                ch = DABPlusChannel(bitrate) if is_plus else DABChannel(bitrate)
                _attach_controls(ch)
                self.channels[comp.subch_id] = ch
                self.channel_is_dabplus[comp.subch_id] = is_plus
                if self.on_audio_channel is not None:
                    self.on_audio_channel(comp.subch_id, ch)
            elif comp.transport_mode == TransportMode.PACKET_DATA:
                ch = DataPacketChannel(comp.packet_address)
                _attach_controls(ch)
                self.channels[comp.subch_id] = ch
                self.channel_is_dabplus[comp.subch_id] = False

    # ---------------- main entry ----------------

    def process_frame_bits(self, soft) -> Dict[int, AudioChannelOutput]:
        # the one host-to-device copy of the batch
        soft = torch.as_tensor(soft, dtype=torch.float32, device=self.device)
        if soft.ndim == 1:
            soft = soft[None]
        f = soft.shape[0]
        self.stats["frames"] += f

        # FIC: batched across all frames
        fibs, ok = decode_fic_frame(soft[:, : self.dab.nb_fic_bits], self.mode)
        self.stats["fibs"] += fibs.shape[0]
        self.stats["fib_crc_errors"] += int((~ok).sum())
        for fib, good in zip(fibs, ok):
            if good:
                self.updater.process_events(parse_fib(fib))
        self._refresh_channels()

        # MSC: all CIFs of the batch through each running subchannel decoder
        outputs: Dict[int, AudioChannelOutput] = {}
        if not self.subch_decoders:
            return outputs
        cifs = soft[:, self.dab.nb_fic_bits:].reshape(
            f * self.dab.nb_cifs, CIF_BITS)
        for subch_id, dec in self.subch_decoders.items():
            lo = dec.config.start_cu * CU_BITS
            sl = cifs[:, lo : lo + dec.config.slice_bits]
            frames_bytes, valid, idx = dec.process(sl)
            complete = frames_bytes[valid]
            is_plus = self.channel_is_dabplus.get(subch_id, True)
            out = AudioChannelOutput(subch_id=subch_id, is_dab_plus=is_plus,
                                     raw_frames=complete)
            ch = self.channels.get(subch_id)
            self._decode_channel(ch, is_plus, complete, out)
            outputs[subch_id] = out
        return outputs

    def _decode_channel(self, ch, is_plus, complete, out) -> None:
        """Run the channel's payload decode honoring the per-channel
        controls on top of the global decode_audio switch."""
        if ch is None or not complete.shape[0]:
            return
        if isinstance(ch, DataPacketChannel):
            if getattr(ch, "is_decode_data", True):
                out.data_groups = ch.process_frames(complete)
            return
        if not (self.decode_audio and getattr(ch, "is_decode_audio", True)):
            return
        if is_plus:
            out.superframes = ch.process_frames(complete)
        else:
            out.mp2_frames = ch.process_frames(complete)

    # ---------------- device-step integration ----------------

    def process_step_outputs(self, fic_group_bytes: np.ndarray,
                             subch_bytes: Dict[int, np.ndarray],
                             first_logical: Dict[int, int],
                             ) -> Dict[int, AudioChannelOutput]:
        """Consume outputs of a ReceiveStep (device FIC/MSC decode).

        fic_group_bytes: (n_groups_total, group_bytes) decoded FIC groups;
        subch_bytes: {subch_id: (C, frame_bytes)} logical frames whose row 0
        is logical index first_logical[subch_id] (negative rows = warm-up,
        dropped here).
        """
        fibs = np.asarray(fic_group_bytes).reshape(-1, 32)
        ok = check_fib_crc(fibs)
        self.stats["fibs"] += fibs.shape[0]
        self.stats["fib_crc_errors"] += int((~ok).sum())
        for fib, good in zip(fibs, ok):
            if good:
                self.updater.process_events(parse_fib(fib))
        self._refresh_channels()

        outputs: Dict[int, AudioChannelOutput] = {}
        for subch_id, by in subch_bytes.items():
            by = np.asarray(by)
            lo = first_logical.get(subch_id, 0)
            complete = by[max(-lo, 0):]
            is_plus = self.channel_is_dabplus.get(subch_id, True)
            out = AudioChannelOutput(subch_id=subch_id, is_dab_plus=is_plus,
                                     raw_frames=complete)
            ch = self.channels.get(subch_id)
            self._decode_channel(ch, is_plus, complete, out)
            outputs[subch_id] = out
        return outputs

    def finalize(self) -> Dict[int, AudioChannelOutput]:
        """End-of-stream flush: emit frames still held by a pending UEP
        calibration (captures shorter than the calibration window)."""
        outputs: Dict[int, AudioChannelOutput] = {}
        for subch_id, dec in self.subch_decoders.items():
            frames_bytes, valid, _ = dec.flush()
            if not frames_bytes.shape[0]:
                continue
            complete = frames_bytes[valid]
            is_plus = self.channel_is_dabplus.get(subch_id, True)
            out = AudioChannelOutput(subch_id=subch_id, is_dab_plus=is_plus,
                                     raw_frames=complete)
            self._decode_channel(self.channels.get(subch_id), is_plus,
                                 complete, out)
            outputs[subch_id] = out
        return outputs

    # ---------------- control ----------------

    def set_is_play_audio(self, subch_id: int, value: bool) -> None:
        ch = self.channels.get(subch_id)
        if ch is not None:
            ch.is_play_audio = bool(value)

    def set_is_decode_audio(self, subch_id: int, value: bool) -> None:
        ch = self.channels.get(subch_id)
        if ch is not None:
            ch.is_decode_audio = bool(value)

    def set_is_decode_data(self, subch_id: int, value: bool) -> None:
        ch = self.channels.get(subch_id)
        if ch is not None:
            ch.is_decode_data = bool(value)

    def run_all(self) -> None:
        """Enable play+decode on every channel."""
        for ch in self.channels.values():
            ch.is_play_audio = ch.is_decode_audio = ch.is_decode_data = True

    def stop_all(self) -> None:
        """Disable play+decode on every channel."""
        for ch in self.channels.values():
            ch.is_play_audio = ch.is_decode_audio = ch.is_decode_data = False

    def reset(self) -> None:
        """Full reset (on a retune)."""
        self.__init__(self.mode, self.device, self.on_audio_channel, self.decode_audio)

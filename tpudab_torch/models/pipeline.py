"""Offline decode pipeline: IQ buffer -> acquisition -> batched OFDM demod
-> Receiver (FIC/MSC/audio). Counterpart of tpudab.models.pipeline.

Acquire once over the head of the buffer, demodulate frames in batches on
the device, feed the Receiver; re-run the acquisition when every FIB of a
batch fails its CRC. With use_device_step the fused ReceiveStep takes over
once the FIC has found the layout; StepDriver.decode takes each batch's
route.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.models.receiver import Receiver
from tpudab_torch.models.step import frames_on_device
from tpudab_torch.models.step_driver import StepDriver
from tpudab_torch.ofdm.sync import SyncConfig
from tpudab_torch.ofdm.sync_device import acquire_host
from tpudab_torch.utils.device import DEFAULT_DEVICE


@dataclasses.dataclass
class PipelineStats:
    total_frames: int = 0
    total_frames_desync: int = 0   # reference: GetTotalFramesDesync
    reacquisitions: int = 0
    net_freq_hz: float = 0.0
    frame_start: int = 0
    next_pos: int = 0   # sample index where the next run would continue


class OfflinePipeline:
    """Decode a (long) IQ capture in frame batches on one device.

    The device is the receiver's: a Receiver(mode, device) made here, or
    the one passed in. use_device_step=True switches to the ReceiveStep
    once the FIC database has discovered the subchannel layout: demod, FIC
    and all MSC decoding run as one step per batch, with the host
    decoders' deinterleaver history handed into the step's carry so the
    logical-frame sequence continues seamlessly. Each batch's frames cross
    to the device in one copy.
    """

    def __init__(self, mode: int = 1, batch_frames: int = 8,
                 sync_cfg: SyncConfig = SyncConfig(),
                 receiver: Optional[Receiver] = None,
                 use_device_step: bool = False, device=DEFAULT_DEVICE):
        self.mode = mode
        self.params = get_ofdm_params(mode)
        self.batch_frames = batch_frames
        self.sync_cfg = sync_cfg
        self.receiver = receiver if receiver is not None else Receiver(mode, device)
        self.device = self.receiver.device
        self.use_device_step = use_device_step
        self.stats = PipelineStats()
        self._driver = StepDriver(mode, sync_cfg.window_offset, self.device)
        self._resumed = False  # set by models.checkpoint.pipeline_restore

    def _acquire(self, iq: np.ndarray):
        return acquire_host(iq[: 4 * self.params.nb_frame_length], self.mode,
                            self.sync_cfg.max_coarse_bins,
                            self.sync_cfg.impulse_peak_threshold_db,
                            self.sync_cfg.impulse_peak_distance_probability, self.device)

    def _frames_on_device(self, iq: np.ndarray, pos: int, nf: int):
        """nf frames from pos, tiled on the device (frames_on_device)."""
        n = self.params.nb_frame_length
        return frames_on_device(iq[pos: pos + nf * n].reshape(nf, n), self.device)

    def run(self, iq: np.ndarray, collect=None):
        """Decode the whole buffer; returns accumulated channel outputs.

        collect: optional callback(outputs: {subch_id: AudioChannelOutput})
        called per batch.
        """
        p = self.params
        n = iq.shape[0]
        if self._resumed:
            # restored state: the buffer is the remainder of a capture that
            # was checkpointed at a frame boundary; no acquisition, the
            # tracked net frequency carries over
            self._resumed = False
            start = 0
        else:
            if n < 2 * p.nb_frame_length:
                raise ValueError("need at least 2 frames of IQ for acquisition")
            res = self._acquire(iq)
            self.stats.net_freq_hz = res["net_freq_hz"]
            self.stats.frame_start = res["frame_start"]
            start = res["frame_start"]

        accumulated: Dict[int, list] = {}
        pos = start
        fib_err_prev = 0
        while pos + p.nb_frame_length <= n:
            nf = min(self.batch_frames, (n - pos) // p.nb_frame_length)
            if nf == 0:
                break
            re, im = self._frames_on_device(iq, pos, nf)
            outputs, _ = self._driver.decode(self.receiver, re, im, self.stats.net_freq_hz,
                                             self.use_device_step, self.stats.total_frames)
            self.stats.total_frames += nf
            pos += nf * p.nb_frame_length

            # resync check: all FIBs of the batch failing CRC == desync
            errs = self.receiver.stats["fib_crc_errors"] - fib_err_prev
            fib_err_prev = self.receiver.stats["fib_crc_errors"]
            batch_fibs = nf * self.receiver.dab.nb_fibs
            if errs == batch_fibs and pos + 2 * p.nb_frame_length <= n:
                self.stats.total_frames_desync += nf
                self.stats.reacquisitions += 1
                res = self._acquire(iq[pos:])
                pos += res["frame_start"]
                self.stats.net_freq_hz = res["net_freq_hz"]

            if collect is not None:
                collect(outputs)
            for sid, out in outputs.items():
                accumulated.setdefault(sid, []).append(out)
            self.stats.next_pos = pos
        # end of stream: frames still held by a pending UEP calibration
        # (capture ended inside the calibration window) are flushed now
        final = self.receiver.finalize()
        if collect is not None and final:
            collect(final)
        for sid, out in final.items():
            accumulated.setdefault(sid, []).append(out)
        return accumulated


def decode_iq(iq: np.ndarray, mode: int = 1, **kw):
    """One-call offline decode; returns (receiver, accumulated outputs, stats)."""
    pipe = OfflinePipeline(mode=mode, **kw)
    acc = pipe.run(iq)
    return pipe.receiver, acc, pipe.stats

"""StepDriver: host-side owner of the ReceiveStep for a live Receiver.

Counterpart of tpudab.models.step_driver. The driver tracks what lives
across batches: the step (rebuilt when the FIC database discovers new
subchannels), the deinterleaver ring carry, and the logical-frame index of
each subchannel's next output row. Its decode takes every batch's route
(the host leg, or the step once built) for the pipeline and the live loop.

The handoff dtype: a host SubchannelDecoder keeps an f32 history, and the
step's chain runs in its soft_dtype (bf16 by default), whose K4 mode (b)
takes a carry only in the soft bits' dtype. So the history is cast to
soft_dtype when the step is built, and a carry handed back to the host
decoders on demotion is cast back to f32. (tpudab's StepDriver hands the f32
history to its bf16 step as it is, and its concatenation then promotes
that subchannel's chain to f32; the port keeps the bf16 chain.)
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpudab_torch.host.profiling import StageTimer, span
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.msc.interleave import TIME_INTERLEAVE_DEPTH
from tpudab_torch.ofdm.demod import demod_frames_split, dft_operands
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device


def read_back(step_out: Dict) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """A step's decoded bytes on the host: (fic_bytes, {subch_id: bytes}),
    each output copied by its own .cpu(), the subchannels first; under a
    profiler inside span("readback", items=the bytes copied)."""
    fic, subch = step_out["fic_bytes"], step_out["subch"]
    n_bytes = sum(t.numel() * t.element_size() for t in (fic, *subch.values()))
    with span("readback", n_bytes, fic.device):
        subch_bytes = {k: v.cpu().numpy() for k, v in subch.items()}
        return fic.cpu().numpy(), subch_bytes


class StepDriver:
    """Builds/rebuilds a ReceiveStep on device from a Receiver's discovered
    subchannels and runs batches through it, or the host leg (with bf16 DFT
    operands, tpudab's default, built once) while there is none.

    Attributes (checkpointable, see tpudab_torch.models.checkpoint):
      step: the current ReceiveStep (None until first discovery)
      carry: {deint_<id>: (15, slice_bits)} tensors on device, in soft_dtype
      first_logical: {subch_id: logical index of the next output row 0}
    """

    def __init__(self, mode: int, window_offset: int, device=DEFAULT_DEVICE):
        self.mode = mode
        self.window_offset = window_offset
        self.device = resolve_device(device)
        self.operands = tuple(w.to(self.device) for w in dft_operands(mode, "bfloat16"))
        self.reset()

    def reset(self) -> None:
        """No step, no carry: the next batch takes the host leg."""
        self.step: Optional[ReceiveStep] = None
        self.carry: Optional[Dict[str, torch.Tensor]] = None
        self.first_logical: Dict[int, int] = {}

    def new_step(self, configs) -> ReceiveStep:
        return ReceiveStep(self.mode, tuple(configs), self.window_offset).to(self.device)

    def maybe_build(self, receiver, total_frames: int) -> None:
        """(Re)build the step from the receiver's discovered decoders.

        The first build seeds the carry from each host decoder's
        deinterleaver history (the host path ran while the FIC was still
        discovering the layout). If the FIC later discovers more
        subchannels, the step is rebuilt: existing carries are kept, new
        subchannels start with zero history (their first 15 logical frames
        are warm-up, as at stream start).
        """
        if not receiver.subch_decoders:
            return
        current = set(receiver.subch_decoders.keys())
        if self.step is not None and \
                current == {c.subch_id for c in self.step.subchannels}:
            return
        if any(getattr(d, "_cal_pending", False)
               for d in receiver.subch_decoders.values()):
            # A budget-solved UEP row is still self-calibrating
            # (fec/uep_calibrate.py); building now would bake the unverified
            # table into the step. If a step is already running, demote to
            # the host path, whose decoder runs the calibration: the device
            # carries go back to the host decoders (in f32) so the
            # logical-frame sequence stays seamless, and the step rebuilds
            # with every subchannel once the table locks.
            if self.step is not None:
                warmup = TIME_INTERLEAVE_DEPTH - 1
                for subch_id, dec in receiver.subch_decoders.items():
                    key = f"deint_{subch_id}"
                    if self.carry is not None and key in self.carry:
                        dec._history = self.carry[key].to(dec.device, torch.float32)
                        dec._n_seen = self.first_logical[subch_id] + warmup
                self.reset()
            return
        new_step = self.new_step(d.config for d in receiver.subch_decoders.values())
        old_carry = self.carry or {}
        carry = {}
        n_cifs_seen = total_frames * receiver.dab.nb_cifs
        warmup = TIME_INTERLEAVE_DEPTH - 1
        for subch_id, dec in receiver.subch_decoders.items():
            key = f"deint_{subch_id}"
            if key in old_carry:
                carry[key] = old_carry[key]
            elif self.step is None:
                carry[key] = dec._history.to(self.device, new_step.soft_dtype)
                self.first_logical[subch_id] = dec._n_seen - warmup
            else:
                carry[key] = torch.zeros((warmup, dec.config.slice_bits),
                                         dtype=new_step.soft_dtype, device=self.device)
                self.first_logical[subch_id] = n_cifs_seen - warmup
        self.step = new_step
        self.carry = carry

    def process(self, receiver, frames_re, frames_im: Optional[torch.Tensor],
                freq_hz) -> Tuple[Dict, Dict]:
        """Run one batch through the step and hand the decoded bytes to the
        receiver. frames_re/_im: lane-tiled (F, len//128, 128) on the
        step's device; or rtl_sdr's raw IQ with frames_im None: frames_re
        uint8 (F, frame_len, 2) on the step's device, or a HostFeed
        (models/ingest.py) fed such frames from host memory, whose copy
        the step waits for on the card (span `ingest`, the copy; the step's
        spans as ReceiveStep's).

        Returns (outputs, step_out): the receiver's {subch_id:
        AudioChannelOutput}, and the step's outputs (mean_power,
        const_re/const_im for dashboards) on the device.
        """
        nf = frames_re.shape[0]
        self.carry, step_out = self.step(self.carry, frames_re, frames_im, freq_hz)
        fic_bytes, subch_bytes = read_back(step_out)
        outputs = receiver.process_step_outputs(fic_bytes, subch_bytes, dict(self.first_logical))
        for k in self.first_logical:
            self.first_logical[k] += nf * receiver.dab.nb_cifs
        return outputs, step_out

    def decode(self, receiver, frames_re, frames_im, freq_hz, use_step: bool,
               total_frames: int, timers: Optional[StageTimer] = None) -> Tuple[Dict, Dict]:
        """One batch of lane-tiled frames (F, len//128, 128) on the device:
        with use_step maybe_build (total_frames decoded before it) first;
        then process if a step is built, else the host leg
        (demod_frames_split, then receiver.process_frame_bits). Returns (outputs, stats holding the
        demod's mean_power, const_re, const_im); timers, the caller's
        StageTimer, times the stage `step`, or `demod` then `decode`."""
        if use_step:
            self.maybe_build(receiver, total_frames)
        stage = timers.stage if timers is not None else lambda *a, **k: contextlib.nullcontext()
        if self.step is not None:
            with stage("step", items=frames_re.numel()):
                return self.process(receiver, frames_re, frames_im, freq_hz)
        with stage("demod", items=frames_re.numel()):
            soft, stats = demod_frames_split(frames_re, frames_im, freq_hz, self.operands,
                                             self.mode, self.window_offset)
        with stage("decode", items=frames_re.shape[0]):
            return receiver.process_frame_bits(soft), stats

"""The receive step: aligned IQ frames -> decoded FIC + MSC bytes.

Counterpart of tpudab.models.step.ReceiveStep, the device program that
tpudab's bench.py times and its live radio runs: PLL + carve (kernel K5),
dense-DFT demod, FIC depuncture/Viterbi (K1 + K2)/descramble, and per
subchannel the CIF slices, the 16-deep time deinterleave with its ring
carry and the depuncture (one K4 launch from the soft bits to the Viterbi
input), then Viterbi/descramble to packed bytes.

Subchannels with the same coding geometry (profile, slice size, padding)
batch into one Viterbi call across subchannels and ensembles. Every static
table is a registered buffer, so `step.to(device)` moves them all; nothing
else moves tensors between devices.

Under a profiler the step records spans (host/profiling.py): step, demod
(and its stages, ofdm/demod.py), fec, fec.deint (the FIC's K4 launch,
then the subchannels'), fec.viterbi (K1 + K2 and the PRBS XOR, a Viterbi
call); a HostFeed that feeds it records ingest, its copy. With no
profiler recording, the demod half on the card replays a CUDA graph of
its chain for frames it has seen before (models/demod_graph.py).

Built with a ChannelPlan (ofdm/channelise.py), the step takes wideband
receivers' s8 streams instead of frames and channelises them first (span
demod.ddc inside demod; its Channeliser is `step.ddc`, with its counters),
the carry holding each receiver's tail; the channelised frames then take
the same demod (and graph) and FEC.

Built with track_frames (a tracked stream, ofdm/track.py), the step takes
free-running rtl_sdr dongles' streams: a segment of each dongle's u8 I/Q
at its read pointer, (E, L, 2), or a HostFeed fed them. No CFO and no
frame boundary is handed in: the carry's "track" state says where each
ensemble's F frames start and what CFO to take out; K5 and stats_kernel
read the frames where they start (the starts sit in the tracker's fixed
buffer), and after the demod the tracker (span demod.track inside demod)
updates the state from the same frames; the cut, the demod and the update
are one chain, which the demod graph replays as one, the state copied in
as an aligned step's CFO is.
The outputs add each ensemble's consumed samples and its lock.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpudab_torch.constants.dab_params import CU_BITS, get_dab_params
from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.constants.puncture import FIC_PROFILE, FIC_PROFILE_MODE3
from tpudab_torch.fec.depuncture import depuncture_index
from tpudab_torch.fec.prbs import prbs_bytes
from tpudab_torch.host.profiling import span
from tpudab_torch.models.demod_graph import DemodGraphs
from tpudab_torch.models.ingest import HostFeed
from tpudab_torch.msc.interleave import (TIME_INTERLEAVE_DEPTH, SoftRows,
                                         deinterleave_depuncture_t)
from tpudab_torch.msc.subchannel import SubchannelConfig
from tpudab_torch.ofdm.channelise import ChannelPlan, Channeliser
from tpudab_torch.ofdm.demod import demod_frames_split, dft_operands
from tpudab_torch.ofdm.track import Tracker
from tpudab_torch.ops.viterbi_cuda import signs_on, viterbi_decode_bytes_t

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def frames_on_device(frames: np.ndarray, device):
    """Complex host frames (..., frame_len) -> one host-to-device copy of
    the complex64 samples, then lane-tiled (..., frame_len//128, 128) f32
    re and im there: the step's input format."""
    x = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.complex64)).to(device)
    tiled = x.shape[:-1] + (x.shape[-1] // 128, 128)
    return x.real.reshape(tiled).contiguous(), x.imag.reshape(tiled).contiguous()


class ReceiveStep(nn.Module):
    """forward(carry, frames_re, frames_im, freq_hz) -> (carry, outputs).

    frames_re/_im: (F, frame_len//128, 128) or flat (F, frame_len), with a
    leading E axis when n_ensembles > 1, bf16 or f32. Or rtl_sdr's raw IQ
    with frames_im None: frames_re uint8 (F, frame_len, 2) or flat
    (F, 2 frame_len), with the same leading E axis, interleaved
    offset-binary I/Q, decoded as the f32 frames (x - 127.5) / 128 would
    be (K5 and stats_kernel convert them in registers); or a HostFeed
    (models/ingest.py) that was fed such frames from host memory, whose
    oldest buffer the step takes, waiting on the card for its copy (span
    `ingest`, on the feed's copy stream), and releases after the demod,
    the last that reads it. freq_hz a scalar or (E,). carry:
    {"deint_<id>": ([E,] 15, slice_bits)} in soft_dtype.
    outputs: fic_bytes ([E,] F*n_groups, group_bytes) uint8 (before the
    CRC check); subch {id: ([E,] C, frame_bytes) uint8}, row r of a step
    being logical frame (CIFs seen before the step) + r - 15; mean_power
    (E*F,); const_re/const_im (480,) constellation tap of the last frame.

    soft_dtype "bfloat16" (default) halves the FEC chain's memory traffic;
    "float32" gives exact parity with tpudab's f32 chain.

    With `channels` (a ChannelPlan of plan.n_ensembles == n_ensembles),
    frames_re is instead the receivers' wideband streams, int8 (S, N, 2)
    or flat (S, 2 N), N = decimation x F x frame_len, interleaved I/Q
    scaled by 1/128, or a HostFeed fed their bytes (uint8), with frames_im None;
    forward(carry, streams, None, freq_hz, frame_offset) channelises them
    (Channeliser, `self.ddc`) and decodes the frames, frame_offset the (E,)
    ensembles' frame offsets (None: all 0). The carry then also holds
    "ddc", the receivers' tails (S, T, 2) int8.

    With `track_frames` (F frames a step of a tracked stream, the step's
    Tracker `self.track`), frames_re is instead the dongles' segments,
    uint8 (E, L, 2) with L = self.track.segment_len, or a HostFeed fed
    them, frames_im and freq_hz None: forward(carry, segments, None, None),
    the carry also holding "track", the tracker's state (self.track.train
    gives the first). outputs then also hold consumed (E,) int64, the
    samples each dongle's read pointer moves (the feed of the step after
    next moves by it), and locked (E,) bool, False where an ensemble lost
    its lock and its bytes are not to be trusted.
    """

    def __init__(self, mode: int, subchannels: Tuple[SubchannelConfig, ...],
                 window_offset: int = 12, n_ensembles: int = 1,
                 soft_dtype: str = "bfloat16", channels: Optional[ChannelPlan] = None,
                 track_frames: Optional[int] = None):
        super().__init__()
        self.mode = mode
        self.subchannels = tuple(subchannels)
        self.window_offset = window_offset
        self.n_ensembles = n_ensembles
        self.soft_dtype = _DTYPES[soft_dtype]
        self.params = get_ofdm_params(mode)
        self.dab = get_dab_params(mode)
        self.fic_profile = FIC_PROFILE_MODE3 if mode == 3 else FIC_PROFILE
        self._msc_slice_bits = sum(cfg.slice_bits for cfg in self.subchannels)
        self.graphs = DemodGraphs()
        self.ddc = None
        if channels is not None:
            if channels.n_ensembles != n_ensembles:
                raise ValueError(f"the plan's {channels.n_ensembles} ensembles are not the "
                                 f"step's {n_ensembles}")
            self.ddc = Channeliser(channels, mode)
        self.track = None
        if track_frames is not None:
            if channels is not None:
                raise ValueError("a tracked stream is one dongle an ensemble, not a ChannelPlan")
            self.track = Tracker(mode, n_ensembles, track_frames)

        for name, w in zip(("dft_re", "dft_sum", "dft_diff"),
                           dft_operands(mode, "bfloat16")):
            self.register_buffer(name, w, persistent=False)
        # one (profile, slice_bits, padding_bits) group per Viterbi call
        self.groups: Dict[tuple, list] = {}
        for cfg in self.subchannels:
            key = (cfg.profile, cfg.slice_bits, cfg.padding_bits)
            self.groups.setdefault(key, []).append(cfg)
        self._profile_ids = {}
        for profile in [self.fic_profile] + [k[0] for k in self.groups]:
            if profile not in self._profile_ids:
                i = len(self._profile_ids)
                self._profile_ids[profile] = i
                self.register_buffer(f"depunct_{i}", torch.tensor(
                    depuncture_index(profile)), persistent=False)
                n_bytes = profile.data_bits // 8
                self.register_buffer(f"prbs_{i}", torch.tensor(
                    prbs_bytes(n_bytes)), persistent=False)

    # -------- carry --------

    def init_carry(self, device) -> Dict[str, torch.Tensor]:
        lead = (self.n_ensembles,) if self.n_ensembles > 1 else ()
        carry = {f"deint_{cfg.subch_id}": torch.zeros(
                     lead + (TIME_INTERLEAVE_DEPTH - 1, cfg.slice_bits),
                     dtype=self.soft_dtype, device=device)
                 for cfg in self.subchannels}
        if self.ddc is not None:
            carry["ddc"] = self.ddc.init_tail(device)
        return carry

    # -------- the chain --------

    def _viterbi_input(self, soft: torch.Tensor, profile, n_codewords: int):
        """(index, n_punct, empty (T2p, 8, n_codewords) Viterbi input)."""
        index = getattr(self, f"depunct_{self._profile_ids[profile]}")
        return (index, profile.punctured_bits,
                soft.new_empty((index.shape[0] // 8, 8, n_codewords)))

    def _decode_descramble(self, soft_t: torch.Tensor, profile) -> torch.Tensor:
        """(T2p, 8, B) Viterbi input -> (B, data_bits // 8) descrambled bytes."""
        with span("fec.viterbi", soft_t.shape[-1], soft_t.device):
            by = viterbi_decode_bytes_t(soft_t, signs_on(soft_t.device), profile.data_bits)
            return by ^ getattr(self, f"prbs_{self._profile_ids[profile]}")

    def msc_viterbi_inputs(self, carry, soft: torch.Tensor):
        """The MSC half of decode_soft up to the Viterbi: flat soft
        (E*F, nb_frame_bits) and the carry -> (new carry, [(profile, cfgs,
        (T2p, 8, len(cfgs) * E * C) Viterbi input)] a coding group), one
        deinterleave_depuncture_t (kernel K4 on CUDA) a subchannel."""
        dab, e = self.dab, self.n_ensembles
        c = soft.shape[0] // e * dab.nb_cifs
        new_carry = dict(carry)
        inputs = []
        for (profile, slice_bits, _), cfgs in self.groups.items():
            index, n_punct, soft_t = self._viterbi_input(soft, profile, len(cfgs) * e * c)
            for i, cfg in enumerate(cfgs):
                key = f"deint_{cfg.subch_id}"
                rows = SoftRows.cif_slices(dab.nb_fic_bits, dab.nb_cifs,
                                           cfg.start_cu * CU_BITS, slice_bits)
                new_carry[key] = deinterleave_depuncture_t(
                    soft, rows, carry[key], index, n_punct, soft_t, i * e * c)
            inputs.append((profile, cfgs, soft_t))
        return new_carry, inputs

    def decode_soft(self, carry, soft: torch.Tensor):
        """The FEC half of the step: flat soft (E*F, nb_frame_bits) in
        soft_dtype -> (new carry, fic_bytes, subch). Each FIC batch and
        each subchannel goes from the soft bits (and its carry) to its
        columns of its group's Viterbi input in one deinterleave_depuncture_t
        (kernel K4 on CUDA)."""
        dab, e = self.dab, self.n_ensembles
        f = soft.shape[0] // e
        g = dab.nb_fib_groups
        with span("fec", 0, soft.device):
            with span("fec.deint", soft.shape[0] * dab.nb_fic_bits, soft.device):
                index, n_punct, fic_t = self._viterbi_input(soft, self.fic_profile,
                                                            soft.shape[0] * g)
                deinterleave_depuncture_t(
                    soft, SoftRows.fib_groups(g, dab.nb_fic_bits_per_group), None, index,
                    n_punct, fic_t)
            fic_bytes = self._decode_descramble(fic_t, self.fic_profile)
            if e > 1:
                fic_bytes = fic_bytes.reshape(e, f * g, -1)

            with span("fec.deint", soft.shape[0] * dab.nb_cifs * self._msc_slice_bits,
                      soft.device):
                new_carry, inputs = self.msc_viterbi_inputs(carry, soft)
            lead = (e,) if e > 1 else ()
            subch = {}
            for profile, cfgs, soft_t in inputs:
                by = self._decode_descramble(soft_t, profile)
                by = by.reshape((len(cfgs),) + lead + (f * dab.nb_cifs, -1))
                for i, cfg in enumerate(cfgs):
                    subch[cfg.subch_id] = by[i]
            return new_carry, fic_bytes, subch

    def demod(self, frames_re, frames_im, freq_hz):
        """The demod half of forward: frames and freq_hz as forward takes
        them -> (flat soft (E*F, nb_frame_bits) in soft_dtype, stats).

        On the card with no profiler recording, frames seen before replay
        a CUDA graph of the chain (self.graphs, models/demod_graph.py):
        soft is then the graph's buffer, valid until the step's next demod
        on the same frames buffer (with two graphs, whose pool is shared,
        until its next demod); mean_power and the tap are the caller's."""
        if isinstance(frames_re, HostFeed):
            feed = frames_re
            try:
                return self.demod(feed.take(), frames_im, freq_hz)
            finally:
                feed.release()
        e = self.n_ensembles
        if e > 1 and frames_re.shape[0] != e:
            raise ValueError(f"frames {tuple(frames_re.shape)} do not lead "
                             f"with the step's {e} ensembles")
        f = frames_re.shape[1] if e > 1 else frames_re.shape[0]
        with span("demod", e * f, frames_re.device):
            return self._demod_graph(frames_re, frames_im, freq_hz)

    def _demod_graph(self, frames_re, frames_im, freq_hz):
        e = self.n_ensembles
        f = frames_re.shape[1] if e > 1 else frames_re.shape[0]
        return self.graphs.run(self._demod_chain, (self.dft_re, self.dft_sum, self.dft_diff),
                               frames_re, frames_im, freq_hz, (e,) if e > 1 else (f,))

    def wide_frames(self, streams) -> int:
        """Frames a step of these wideband streams ((S, N, 2) or (S, 2 N),
        a tensor or a HostFeed) holds for each ensemble."""
        n = streams.shape[1] if len(streams.shape) == 3 else streams.shape[1] // 2
        return n // (self.ddc.plan.decimation * self.params.nb_frame_length)

    def demod_wide(self, carry, streams, freq_hz, frame_offset=None):
        """The demod half on wideband streams (a step built with a plan):
        the channeliser, then demod's work on its frames -> (new carry,
        soft, stats), the carry's "ddc" tails advanced. A HostFeed's
        buffer is taken, viewed as int8, and released as demod does."""
        if isinstance(streams, HostFeed):
            feed = streams
            try:
                return self.demod_wide(carry, feed.take().view(torch.int8), freq_hz,
                                       frame_offset)
            finally:
                feed.release()
        n = self.n_ensembles * self.wide_frames(streams)
        with span("demod", n, streams.device):
            tail, frames_re, frames_im = self.ddc(carry["ddc"], streams, frame_offset)
            soft, stats = self._demod_graph(frames_re, frames_im, freq_hz)
        return {**carry, "ddc": tail}, soft, stats

    def demod_stream(self, carry, segments):
        """The demod half on a tracked stream (a step built with
        track_frames): segments (E, L, 2) uint8 or a HostFeed fed them, the
        carry's "track" state -> (new carry, soft, stats), stats also
        holding consumed and locked. The tracker cuts the frames, the demod
        (and its graph) reads them there, then the tracker updates the
        state from them (span demod.track): one chain, so that one demod
        graph a segment buffer replays all three. A HostFeed's buffer is
        taken and released as demod does."""
        if isinstance(segments, HostFeed):
            feed = segments
            try:
                return self.demod_stream(carry, feed.take())
            finally:
                feed.release()
        e, f = self.n_ensembles, self.track.n_frames
        if segments.dtype != torch.uint8 or tuple(segments.shape) != (
                e, self.track.segment_len, 2):
            raise ValueError(f"a tracked step takes (E, L, 2) = {(e, self.track.segment_len, 2)} "
                             f"uint8 segments; got {tuple(segments.shape)} {segments.dtype}")
        with span("demod", e * f, segments.device):
            soft, stats = self.graphs.run(self._stream_chain,
                                          (self.dft_re, self.dft_sum, self.dft_diff),
                                          segments, None, carry["track"], None)
        state = stats.pop("track")
        return {**carry, "track": state}, soft, {**stats, "locked": state["locked"]}

    def _stream_chain(self, segments, frames_im, state):
        """demod's work on a tracked stream, eager: the tracker's cut, the
        demod of the frames where its `starts` buffer says they start, and
        the tracker's update from them (span demod.track); stats also hold
        the next state ("track") and consumed."""
        e, f = self.n_ensembles, self.track.n_frames
        freq = self.track.cut(state).repeat_interleave(f)
        soft, stats = demod_frames_split(
            segments, None, freq, (self.dft_re, self.dft_sum, self.dft_diff), self.mode,
            self.window_offset, out_dtype=self.soft_dtype, starts=self.track.starts)
        with span("demod.track", e * f, segments.device):
            state, consumed = self.track.update(segments, state)
        return soft, {**stats, "track": state, "consumed": consumed}

    def _demod_chain(self, frames_re, frames_im, freq_hz):
        """demod's work on the frames, eager: K5 and its tables, the DFT
        products and the demod tail (ofdm/demod.py::demod_frames_split)."""
        e = self.n_ensembles
        frame_len = self.params.nb_frame_length
        f = frames_re.shape[1] if e > 1 else frames_re.shape[0]
        if frames_re.dtype == torch.uint8:      # I and Q interleaved, frames_im None
            flat_re, flat_im = frames_re.reshape((e * f, 2 * frame_len)), frames_im
        else:
            flat_re = frames_re.reshape((e * f, frame_len // 128, 128))
            flat_im = frames_im.reshape((e * f, frame_len // 128, 128))
        freq = torch.as_tensor(freq_hz, dtype=torch.float32, device=frames_re.device)
        if e > 1:
            freq = freq.broadcast_to((e,)).repeat_interleave(f)
        return demod_frames_split(
            flat_re, flat_im, freq, (self.dft_re, self.dft_sum, self.dft_diff),
            self.mode, self.window_offset, out_dtype=self.soft_dtype)

    def forward(self, carry, frames_re, frames_im, freq_hz, frame_offset=None):
        if self.track is not None:
            if frames_im is not None or freq_hz is not None:
                raise ValueError("a tracked stream's CFO and frames are the tracker's: pass "
                                 "frames_im and freq_hz None")
            n_frames = self.n_ensembles * self.track.n_frames
        elif self.ddc is not None:
            if frames_im is not None:
                raise ValueError("wideband streams hold I and Q interleaved: pass frames_im None")
            n_frames = self.n_ensembles * self.wide_frames(frames_re)
        else:
            n_frames = frames_re.shape[0] * (frames_re.shape[1] if self.n_ensembles > 1 else 1)
        with span("step", n_frames, frames_re.device):
            if self.track is not None:
                carry, soft, stats = self.demod_stream(carry, frames_re)
            elif self.ddc is not None:
                carry, soft, stats = self.demod_wide(carry, frames_re, freq_hz, frame_offset)
            else:
                soft, stats = self.demod(frames_re, frames_im, freq_hz)
            new_carry, fic_bytes, subch = self.decode_soft(carry, soft)
        outputs = {"fic_bytes": fic_bytes, "subch": subch,
                   "mean_power": stats["mean_power"],
                   "const_re": stats["const_re"], "const_im": stats["const_im"]}
        if self.track is not None:
            outputs.update(consumed=stats["consumed"], locked=stats["locked"])
        return new_carry, outputs

    def tile_frames(self, frames_flat: np.ndarray) -> np.ndarray:
        """Host-side reshape (..., frame_len) -> (..., frame_len//128, 128)."""
        frames_flat = np.asarray(frames_flat)
        return frames_flat.reshape(frames_flat.shape[:-1]
                                   + (self.params.nb_frame_length // 128, 128))

    def call_complex(self, carry, frames, freq_hz):
        """forward on complex host frames (..., frame_len), moved to the
        step's device by frames_on_device."""
        return self(carry, *frames_on_device(frames, self.dft_re.device), freq_hz)

    def example_args(self, n_frames: int = 4, seed: int = 0, device="cuda"):
        """(carry, frames_re, frames_im, freq_hz) of seeded Gaussian noise
        on device: the same arrays as tpudab's ReceiveStep.example_args."""
        rng = np.random.default_rng(seed)
        shape = (n_frames, self.params.nb_frame_length // 128, 128)
        if self.n_ensembles > 1:
            shape = (self.n_ensembles,) + shape
        re = rng.standard_normal(shape).astype(np.float32)
        im = rng.standard_normal(shape).astype(np.float32)
        device = torch.device(device)
        return (self.init_carry(device), torch.from_numpy(re).to(device),
                torch.from_numpy(im).to(device),
                torch.tensor(0.0, dtype=torch.float32, device=device))

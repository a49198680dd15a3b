"""Tracking free-running rtl_sdr dongles on the card, every ensemble at once.

An rtl_sdr dongle clocks its tuner and its RTL2832U from one crystal, so a
crystal error of ppm moves the carrier by ppm x f_c and the sample clock
by ppm x 2.048 MS/s. Its stream is not cut into frames: a step reads a
segment of each dongle's stream at the dongle's read pointer, and the
Tracker says where in the segment each of the step's F frames starts,
what CFO to take out of it, and how far the read pointer has to move.
It is host/streaming.py::StreamingRadio._track's loop, batched over the E
ensembles and kept on the card: no scalar is read back.

State (a step's carry["track"], every entry (E,) on the card):
  rs        float64  where this step's frame 0 starts in its segment
  rate      float64  the dongle's samples per nominal sample, 1 + ppm
  coarse_hz float64  whole carriers of CFO
  fine_hz   float64  the rest, within half a carrier
  c_prev    int64    the samples the previous step consumed
  quality   float32  the PRS matched filter's quality, mean over frames
  locked    bool     quality >= LOCK_QUALITY

A step (ReceiveStep with a Tracker):
- cut(state) writes frame j's start, round(rs + j T rate) (T = frame_len),
  into the fixed buffer `starts` as an offset into the flattened segment
  buffer, and returns the (E,) CFO to take out, coarse_hz + fine_hz. K5
  and stats_kernel read the frames there (ops/carve.py), so the demod's
  CUDA graph replays as for aligned frames.
- update(seg, state) reads the same segment (span demod.track):
  * timing: the PRS matched filter (sync_device._prs_search_split)
    around every frame's cut start, +/- fine_time_search samples, gives
    each frame's start, to a fraction of a sample (the parabola through
    the peak's magnitude and its neighbours'); a least-squares line
    through the F starts gives the step's rate, taken in with gain
    RATE_GAIN (the ppm servo), and frame 0 of the next step is put at the
    line's centroid plus (F - (F-1)/2) T rate. _track sees one frame a
    batch and trains its servo on whole-sample jumps; a step of F = 16
    frames spans 2.9 M samples, so its own line measures the rate every
    step, and the fractions keep the next frame 0 well inside half a
    sample, so that its start rounds to the same sample step after step.
  * fine CFO: the CP autocorrelation of the step's last frame
    (_cp_autocorr_split's sums over its 76 symbols), read from the CP
    pairs alone: rotating by the CFO already taken out turns the sum by
    exp(2 pi j f 2048 / fs), applied to the sum instead of the samples. An
    EMA per frame, beta fine_freq_beta, compounded over F frames.
  * whole carriers: the integer-bin check on the last frame's PRS body
    (sync_device.coarse_freq_device), then whole carriers folded from the
    fine estimate into the coarse one, as _track does.
  * consumed: round(next frame 0) - this step's frame 0 start, the
    samples the step moved over. The host feeds one step ahead, so the
    segment of step k + 1 was read before step k ran: its read pointer
    moved by step k - 1's count (c_prev), and the next state's rs is
    relative to that pointer. Summed over steps, consumed is the distance
    from the first step's frame 0 to the last's.
- An ensemble whose quality falls below LOCK_QUALITY is held: its state
  moves on by its own prediction, counted in `lock_lost`, and the step
  marks its bytes (outputs["locked"] False). The other ensembles go on;
  reacquiring inside the step is left to the caller.

Set-up: acquire(seg) runs sync_device.acquire_device over every dongle's
first frames at once and says how far each read pointer has to move to
put frame 0 at sample HEAD; train(seg, acq) on the segment read there
measures the rate over its F frames (gain 1) and gives the first state.

Segments are (E, L, 2) uint8, L = F T + MARGIN. MARGIN covers where frame 0
lands (HEAD ahead of it, for a pointer that moved too far) and the
sample clock's excess over F T at the front end's largest ppm (25 ppm: 79
samples a step); the PRS search lies inside the frames. A frame's start
is clamped so that the frame and the PAD pairs a shifted 16-byte load may
read past its end stay inside the segment.

On the card the tracker's cut and update are part of the demod chain
that ReceiveStep.demod_stream hands models/demod_graph.py: one CUDA graph
a segment buffer replays K5, the DFT, the demod tail and the tracker's
~200 launches together, the state copied into the graph's inputs before
each replay and its outputs copied out, as freq_hz is for aligned frames.

Counters (card tensors, read by counters(), so that a graph's replays
count too): calls, moves (frames whose PRS start was not where they were
cut), lock_lost (ensembles held, summed over calls), consumed (samples,
summed over ensembles and calls); frames is calls x E x F.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.ofdm.sync import SyncConfig
from tpudab_torch.ofdm.sync_device import (_prs_search_split, _rotate, acquire_device,
                                           coarse_freq_device)

MARGIN = 1024          # pairs a segment holds past F frames
HEAD = 512             # where set-up puts frame 0 of a segment
PAD = 8                # pairs a shifted 16-byte load may read past a frame
LOCK_QUALITY = 8.0     # PRS quality a locked ensemble keeps (noise reads ~3)
COARSE_QUALITY = 3.0   # the integer-bin check's quality to act on (_track's)
RATE_GAIN = 0.5        # the ppm servo's gain a step (_track's)
ACQUIRE_FRAMES = 3     # frames of a segment acquisition reads
COUNTERS = ("calls", "moves", "lock_lost", "consumed")

def u8_complex(pairs: torch.Tensor, dtype=torch.float32):
    """(..., 2) uint8 I/Q -> (re, im) in dtype, (x - 127.5) / 128."""
    x = (pairs.to(dtype) - 127.5) / 128.0
    return x[..., 0], x[..., 1]


class Tracker(nn.Module):
    """The timing and frequency of E free-running dongles' streams, F frames
    a step; see the module's docstring."""

    def __init__(self, mode: int, n_ensembles: int, n_frames: int,
                 sync_cfg: SyncConfig = SyncConfig()):
        super().__init__()
        p = get_ofdm_params(mode)
        self.mode, self.n_ensembles, self.n_frames = mode, n_ensembles, n_frames
        self.cfg = sync_cfg
        self.frame_len = p.nb_frame_length
        self.segment_len = n_frames * p.nb_frame_length + MARGIN
        self.search = sync_cfg.fine_time_search
        self.spacing = SAMPLING_RATE / p.nb_fft
        self.prs_at = p.nb_null_period + p.nb_cyclic_prefix     # PRS body in a frame
        e, f = n_ensembles, n_frames
        self.register_buffer("starts", torch.zeros(e * f, dtype=torch.int64), persistent=False)
        self.register_buffer("_rows", torch.arange(e, dtype=torch.int64)[:, None]
                             * self.segment_len, persistent=False)
        self.register_buffer("_j", torch.arange(f, dtype=torch.float64), persistent=False)
        self.register_buffer("_prs", torch.arange(2 * self.search + p.nb_fft), persistent=False)
        cp = (p.nb_null_period + p.nb_symbol_period * torch.arange(p.nb_symbols)[:, None]
              + torch.arange(p.nb_cyclic_prefix)[None, :])
        self.register_buffer("_cp", cp.reshape(-1), persistent=False)
        self.register_buffer("_body", torch.arange(p.nb_fft), persistent=False)
        self.nb_fft = p.nb_fft
        for name in COUNTERS:
            self.register_buffer(f"n_{name}", torch.zeros((), dtype=torch.int64),
                                 persistent=False)

    # -------- set-up --------

    def acquire(self, seg: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Acquisition over every dongle's segment at once: seg (E, n, 2)
        uint8 with n >= ACQUIRE_FRAMES frames -> acquire_device's (E,)
        results and "advance" (int64), how far each read pointer has to
        move to put frame 0 at sample HEAD of the segment read there."""
        re, im = u8_complex(seg[:, :ACQUIRE_FRAMES * self.frame_len])
        acq = acquire_device(re.contiguous(), im.contiguous(), self.mode,
                             self.cfg.max_coarse_bins, self.cfg.impulse_peak_threshold_db,
                             self.cfg.impulse_peak_distance_probability)
        acq["advance"] = acq["frame_start"].to(torch.int64) - HEAD
        return acq

    def initial(self, acq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The state acquisition alone gives: frame 0 at HEAD, the rate 1,
        acquisition's CFO, c_prev a step's nominal count."""
        e, dev = self.n_ensembles, acq["coarse_hz"].device

        def full(v, dtype=torch.float64):
            return torch.full((e,), v, dtype=dtype, device=dev)
        return {"rs": full(float(HEAD)), "rate": full(1.0),
                "coarse_hz": acq["coarse_hz"].double(), "fine_hz": acq["fine_hz"].double(),
                "c_prev": full(self.n_frames * self.frame_len, torch.int64),
                "quality": acq["time_quality"].float(), "locked": full(True, torch.bool)}

    def train(self, seg: torch.Tensor, acq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The first state: frame 0 at HEAD of `seg` (read where acquire
        said), the rate measured over its F frames with gain 1, the CFO
        acquisition's. The state's c_prev is the first step's predicted
        count, by which the host moves the pointer for the step after it."""
        state = self.initial(acq)
        self.cut(state)
        meas, quality = self._timing(seg, state)
        rate, mbar = self._line(meas, state["rate"], 1.0)
        rs = mbar - self._j.mean() * self.frame_len * rate
        c = torch.round(rs + self.n_frames * self.frame_len * rate).long() - torch.round(rs).long()
        return {**state, "rs": rs, "rate": rate, "c_prev": c, "quality": quality,
                "locked": quality >= LOCK_QUALITY}

    # -------- a step --------

    def cut(self, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Frame j's start, round(rs + j T rate), into `starts` (offsets in
        the flattened (E, L, 2) segment buffer); returns the (E,) CFO to
        take out, float32."""
        pos = state["rs"][:, None] + self._j[None, :] * (self.frame_len * state["rate"][:, None])
        st = torch.round(pos).long().clamp_(0, self.segment_len - self.frame_len - PAD)
        self.starts.copy_((st + self._rows).reshape(-1))
        return (state["coarse_hz"] + state["fine_hz"]).float()

    def _pairs(self, seg: torch.Tensor, at: torch.Tensor, offsets: torch.Tensor):
        """seg's I/Q at segment sample at[..., None] + offsets, a row an
        ensemble (at (E, ...)), as f32 (re, im)."""
        idx = (at + self._rows.view((-1,) + (1,) * (at.dim() - 1)))[..., None] + offsets
        return u8_complex(seg.reshape(-1, 2)[idx])

    def _timing(self, seg, state) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every frame's start by the PRS matched filter around its cut, to
        a fraction of a sample: (meas (E, F) float64 in the segment, mean
        quality (E,))."""
        e, f, s = self.n_ensembles, self.n_frames, self.search
        st = self.starts.view(e, f) - self._rows
        re, im = self._pairs(seg, st + (self.prs_at - s), self._prs)
        freq = (state["coarse_hz"] + state["fine_hz"]).float().repeat_interleave(f)
        # sync_device.fine_time_sync_device, with the peak's fraction
        re, im = _rotate(re.reshape(e * f, -1), im.reshape(e * f, -1), freq)
        peak, q, frac = _prs_search_split(re, im, self.mode, 2 * s + 1,
                                          self.cfg.impulse_peak_threshold_db,
                                          self.cfg.impulse_peak_distance_probability)
        lag = peak.view(e, f).long() - s
        self.n_moves += (lag != 0).sum()
        return (st + lag).double() + frac.view(e, f).double(), q.view(e, f).mean(dim=1)

    def _line(self, meas: torch.Tensor, rate: torch.Tensor, gain: float):
        """The least-squares line through the frames' starts: (the rate
        taken in with `gain`, the starts' centroid), float64."""
        mbar = meas.mean(dim=1)
        if self.n_frames < 2:
            return rate, mbar
        jc = self._j - self._j.mean()
        slope = (jc * (meas - mbar[:, None])).sum(dim=1) / (self.frame_len * (jc * jc).sum())
        return rate + gain * (slope - rate), mbar

    def _fine(self, seg, start: torch.Tensor, net: torch.Tensor) -> torch.Tensor:
        """The CFO left after `net` (Hz, float64) in the frames at `start`
        (E,): the CP autocorrelation over their symbols."""
        hr, hi = self._pairs(seg, start, self._cp)
        tr, ti = self._pairs(seg, start, self._cp + self.nb_fft)
        hr, hi, tr, ti = hr.double(), hi.double(), tr.double(), ti.double()
        acc = torch.complex((hr * tr + hi * ti).sum(dim=-1), (hi * tr - hr * ti).sum(dim=-1))
        turned = acc * torch.polar(torch.ones_like(net), 2.0 * math.pi * net / self.spacing)
        return -torch.angle(turned) / (2.0 * math.pi) * self.spacing

    def update(self, seg: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """This step's frames in `seg` (cut where cut(state) put them) ->
        (the next state, consumed (E,) int64)."""
        f, t = self.n_frames, self.frame_len
        meas, quality = self._timing(seg, state)
        locked = quality >= LOCK_QUALITY
        coarse, fine = state["coarse_hz"], state["fine_hz"]
        last = torch.round(meas[:, -1]).long()
        alpha = 1.0 - self.cfg.fine_freq_beta ** f
        fine = fine + alpha * self._fine(seg, last, coarse + fine)
        re, im = self._pairs(seg, last + self.prs_at, self._body)
        bins, cq = coarse_freq_device(re, im, (coarse + fine).float(), self.mode,
                                      self.cfg.max_coarse_bins)
        coarse = coarse + torch.where((bins != 0) & (cq > COARSE_QUALITY),
                                      bins.double() * self.spacing, 0.0)
        whole = torch.round(fine / self.spacing) * self.spacing
        fine, coarse = fine - whole, coarse + whole
        rate, mbar = self._line(meas, state["rate"], RATE_GAIN)
        nxt = mbar + (f - self._j.mean()) * t * rate
        new = self.hold(state)
        st0 = self.starts.view(self.n_ensembles, f)[:, 0] - self._rows[:, 0]
        c = torch.where(locked, torch.round(nxt).long() - st0, new["c_prev"])
        tracked = {"rs": nxt - state["c_prev"], "rate": rate, "coarse_hz": coarse,
                   "fine_hz": fine}
        new.update({k: torch.where(locked, v, new[k]) for k, v in tracked.items()})
        new.update(c_prev=c, quality=quality, locked=locked)
        self.n_calls += 1
        self.n_lock_lost += (~locked).sum()
        self.n_consumed += c.sum()
        return new, c

    def hold(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The next state by the prediction alone (an ensemble out of
        lock): frame 0 of the next step at rs + F T rate, the rate and the
        CFO as they are."""
        nxt = state["rs"] + self.n_frames * self.frame_len * state["rate"]
        st0 = self.starts.view(self.n_ensembles, self.n_frames)[:, 0] - self._rows[:, 0]
        return {**state, "rs": nxt - state["c_prev"],
                "c_prev": torch.round(nxt).long() - st0}

    def counters(self) -> Dict[str, int]:
        """calls, frames, moves, lock_lost, consumed as host ints (one read
        of the card's counters)."""
        n = dict(zip(COUNTERS, torch.stack([getattr(self, f"n_{k}") for k in COUNTERS]).tolist()))
        return {**n, "frames": n["calls"] * self.n_ensembles * self.n_frames}

"""Live streaming radio: IQ source -> acquisition -> tracked frame batches
-> Receiver or ReceiveStep -> audio pipeline. Counterpart of
tpudab.host.streaming.

One host loop, as tpudab's: blocking source reads (the native ring of
host/native_lib.py, or any callable), frame batches decoded on the device,
per-batch fine-frequency tracking (an EMA, the reference's
fine_freq_update_beta analog), a periodic PRS timing recheck, a drift servo
on a fractional resampler, and reacquisition on a FIB CRC blackout (graded:
an EMA of the batch's FIB error rate, after a coarse-frequency triage).
The state machine and the tracking arithmetic are tpudab's, line for line.

On the device: each batch crosses to the receiver's device in one copy
(models/step.py's frames_on_device), StepDriver.decode takes it on its
route (the host leg or the step), and the three tracking taps of
ofdm/sync_device.py slice their segments from that copy and each reads its
scalars back once. The residual, the timing shift and the drift resampler
stay host numpy, as tpudab's.

StageTimer keeps tpudab's stage names (read, step, demod, decode, track,
audio) and reads the host clock. On a CUDA device the demod stage ends
without a host read, so it times the enqueue of the demod's kernels, and
the decode stage, whose first read waits for them, absorbs their device
time. The step stage ends with the step's host read and so holds its
device time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpudab_torch.audio.pipeline import AudioPipeline
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.host.dashboard import constellation_snr_db
from tpudab_torch.host.profiling import StageTimer
from tpudab_torch.models.receiver import Receiver
from tpudab_torch.models.step import frames_on_device
from tpudab_torch.models.step_driver import StepDriver
from tpudab_torch.ofdm.sync import SyncConfig
from tpudab_torch.ofdm.sync_device import (acquire_host, coarse_freq_device,
                                           fine_freq_device, fine_time_sync_device)
from tpudab_torch.utils.device import DEFAULT_DEVICE
from tpudab_torch.utils.resample import PolyphaseResampler


@dataclasses.dataclass
class StreamingStats:
    state: str = "ACQUIRING"      # reference OFDM state-machine analog
    total_frames: int = 0
    total_frames_desync: int = 0
    reacquisitions: int = 0
    net_freq_hz: float = 0.0
    fine_freq_hz: float = 0.0
    coarse_freq_hz: float = 0.0
    timing_adjustments: int = 0
    coarse_adjustments: int = 0   # continuous coarse-CFO bin corrections
    signal_power: float = 0.0
    snr_db: float = 0.0
    const_re: Optional[np.ndarray] = None   # decimated DQPSK constellation
    const_im: Optional[np.ndarray] = None   # (GetFrameDataVec analog)


# Upper bound on old-channel samples hiding in the TCP socket buffers
# (server send + client recv) during a retune: auto-tuned Linux buffers
# reach several MB of u8 IQ (2 bytes/sample). 2M samples ~ 1 s at 2.048
# MS/s; see StreamingRadio._do_retune.
_TCP_INFLIGHT_SAMPLES = 2_000_000


class StreamingRadio:
    """Pull IQ from a sample source callable and decode continuously.

    source(n) -> complex64 array of n samples (or fewer at end of stream),
    e.g. host.native_lib.RingBuffer.read_complex64. device: where the
    receiver decodes ("cuda" by default; without a card that is an error;
    "cpu" runs the plain torch twins); a receiver passed in brings its own.
    use_device_step: decode through the fused ReceiveStep (StepDriver) once
    the FIC has found the layout; None means on for a CUDA device, the host
    per-stage path on the CPU.
    """

    def __init__(self, source: Callable[[int], np.ndarray], mode: int = 1,
                 batch_frames: int = 4, sync_cfg: SyncConfig = SyncConfig(),
                 receiver: Optional[Receiver] = None,
                 audio_pipeline: Optional[AudioPipeline] = None,
                 timing_check_interval: int = 1,
                 fib_error_ema_beta: float = 0.5,
                 desync_threshold: float = 0.35,
                 is_coarse_freq_correction: bool = True,
                 coarse_check_interval: int = 4,
                 drift_resample: bool = True,
                 use_device_step: Optional[bool] = None,
                 tuner=None, channel: Optional[str] = None,
                 retune_drain_s: float = 0.45, device=DEFAULT_DEVICE):
        self.source = source
        self.mode = mode
        self.params = get_ofdm_params(mode)
        self.batch_frames = batch_frames
        self.sync_cfg = sync_cfg
        self.receiver = receiver if receiver is not None else Receiver(mode, device)
        self.device = self.receiver.device
        self.audio = audio_pipeline
        self.timing_check_interval = timing_check_interval
        self.fib_error_ema_beta = fib_error_ema_beta
        # live-tunable mirrors of the SyncConfig betas (KeyController and
        # ConfigManager adjust these while running)
        self.desync_threshold = desync_threshold
        self.fine_freq_beta = sync_cfg.fine_freq_beta
        self.is_coarse_freq_correction = is_coarse_freq_correction
        self.coarse_check_interval = coarse_check_interval
        self.timers = StageTimer()
        # fractional sample-clock drift compensation: the tracked ppm rate
        # retunes a polyphase resampler on the source read, so timing stays
        # continuous instead of +/-32-sample jumps (which remain as the
        # coarse fallback and the servo's training signal)
        self.drift_resample = drift_resample
        self._drift_ppm = 0.0
        self._resampler = None
        if use_device_step is None:
            use_device_step = self.device.type == "cuda"
        self.use_device_step = use_device_step
        self._driver = StepDriver(mode, sync_cfg.window_offset, self.device)
        self.stats = StreamingStats()
        self._residual = np.zeros(0, dtype=np.complex64)
        self._decoders: Dict[int, object] = {}
        self._batches = 0
        self._fib_err_ema = 0.0
        self._stop_requested = False
        # live tuning (reference: a VFO retune rebuilds the radio)
        self.tuner = tuner              # object with set_freq(hz)
        self.channel = channel          # Band III label
        self.retune_drain_s = retune_drain_s
        self._pending_retune: Optional[str] = None

    # ---------------- tuning ----------------

    def retune(self, channel: str) -> None:
        """Request a retune to a Band III channel label ('12C'); handled at
        the top of the next loop iteration (safe from any thread)."""
        self._pending_retune = channel

    def _do_retune(self, channel: str) -> None:
        """Reference reset_radio flow: command the tuner, drain in-flight
        samples of the old channel, reset receiver/DB/decoders/device-step
        state and audio sources, then reacquire."""
        from tpudab_torch.constants.channels import channel_freq_hz
        if self.tuner is not None:
            self.tuner.set_freq(channel_freq_hz(channel))
        self.channel = channel
        # drain: every sample already in flight belongs to the old channel
        # (ring fill + socket buffers + the tuner's command latency);
        # retune_drain_s covers a 300 ms latency with margin, and
        # _TCP_INFLIGHT_SAMPLES bounds the socket term
        drain = int(self.retune_drain_s * SAMPLING_RATE)
        ring = getattr(self.tuner, "ring", None)
        if ring is not None:
            drain += ring.fill // 8          # bytes -> complex64 samples
            drain += _TCP_INFLIGHT_SAMPLES
        # a live source's ring can be transiently empty mid-drain; only a
        # sustained dry spell (~0.5 s with nothing arriving) means EOF
        dry = 0
        while drain > 0 and dry < 100:
            c = self.source(min(drain, 1 << 16))
            if c is None or len(c) == 0:
                dry += 1
                time.sleep(0.005)
                continue
            dry = 0
            drain -= len(c)
        self._residual = np.zeros(0, dtype=np.complex64)
        self.receiver.reset()
        self._driver.reset()
        self._decoders.clear()
        if self.audio is not None:
            self.audio.clear_sources()
        self._fib_err_ema = 0.0
        # reset in place: the dashboard and the controls hold this object
        self.stats.__init__()

    # ---------------- internals ----------------

    def _read(self, n: int):
        """One source read, through the drift resampler when active."""
        if self._resampler is None:
            return self.source(n)
        c = self.source(max(int(n * self._resampler.ratio) + 32, 64))
        if c is None or len(c) == 0:
            return c
        return self._resampler.process(np.asarray(c, np.complex64))

    def _fill(self, n: int) -> np.ndarray:
        """Read until n samples available (or stream end)."""
        chunks = [self._residual]
        have = self._residual.shape[0]
        while have < n:
            c = self._read(n - have)
            if c is None or len(c) == 0:
                break
            c = np.asarray(c, dtype=np.complex64)
            chunks.append(c)
            have += c.shape[0]
        buf = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        self._residual = np.zeros(0, dtype=np.complex64)
        return buf

    def _acquire(self) -> bool:
        p = self.params
        self.stats.state = "ACQUIRING"
        buf = self._fill(3 * p.nb_frame_length)
        if buf.shape[0] < 2 * p.nb_frame_length:
            return False
        res = acquire_host(buf, self.mode, self.sync_cfg.max_coarse_bins,
                           self.sync_cfg.impulse_peak_threshold_db,
                           self.sync_cfg.impulse_peak_distance_probability, self.device)
        self.stats.net_freq_hz = res["net_freq_hz"]
        self.stats.coarse_freq_hz = res["coarse_hz"]
        self.stats.fine_freq_hz = res["fine_hz"]
        self._residual = buf[res["frame_start"]:]
        self.stats.state = "READING_SYMBOLS"
        return True

    def request_stop(self) -> None:
        """Ask the run loop to exit after the current batch (UI quit key)."""
        self._stop_requested = True

    @staticmethod
    def _scalars(*xs) -> list:
        """(1,)-tensors of a tap -> python floats, in one read back."""
        return torch.cat([x.reshape(-1).double() for x in xs]).tolist()

    def _timing_recheck(self, last_re: torch.Tensor, last_im: torch.Tensor) -> int:
        """PRS matched filter around the nominal position of the last frame
        (flat (frame_len,) re and im on the device); returns a small sample
        adjustment (clamped)."""
        p = self.params
        search = 64
        seg_start = p.nb_null_period + p.nb_cyclic_prefix - search
        seg = slice(seg_start, seg_start + 2 * search + p.nb_fft)
        peak, q = self._scalars(*fine_time_sync_device(
            last_re[None, seg], last_im[None, seg], self.stats.net_freq_hz, self.mode,
            search, self.sync_cfg.impulse_peak_threshold_db,
            self.sync_cfg.impulse_peak_distance_probability))
        off = int(peak) - search
        # clamp to half the search window: tracks sample-clock drift up to
        # ~|32| samples/batch (~200 ppm at the default 4-frame batch) while
        # rejecting outlier peaks; reacquisition covers anything larger
        return int(np.clip(off, -32, 32)) if q > 3.0 else 0

    def _coarse_tap(self, last_re: torch.Tensor, last_im: torch.Tensor, freq_hz: float):
        """Residual integer-bin CFO of the last frame's PRS body after
        removing freq_hz: (bins, quality)."""
        p = self.params
        prs_lo = p.nb_null_period + p.nb_cyclic_prefix
        body = slice(prs_lo, prs_lo + p.nb_fft)
        bins, q = self._scalars(*coarse_freq_device(
            last_re[None, body], last_im[None, body], freq_hz, self.mode,
            self.sync_cfg.max_coarse_bins))
        return int(bins), q

    # ---------------- tracking ----------------

    def _track(self, frames: np.ndarray, last_re: torch.Tensor, last_im: torch.Tensor,
               nf: int, spacing: float) -> None:
        """Per-batch frequency/timing tracking while locked. frames: the
        batch on the host; last_re/last_im: its last frame on the device."""
        p = self.params

        # fine-frequency tracking: estimate the small residual after full
        # net correction, EMA'd per frame: a batch covers nf frames, so the
        # per-frame beta compounds to beta**nf
        (resid,) = self._scalars(fine_freq_device(
            last_re[None], last_im[None], self.stats.net_freq_hz, self.mode))
        alpha = 1.0 - self.fine_freq_beta ** nf
        self.stats.fine_freq_hz += alpha * resid

        # continuous coarse correction: every N batches check the PRS body
        # for an integer-carrier residual; fold accumulated fine drift into
        # the coarse offset so a slow oscillator walk past +/- half a
        # carrier is tracked instead of forcing a reacquisition
        if (self.is_coarse_freq_correction
                and self._batches % self.coarse_check_interval == 0):
            bins, q = self._coarse_tap(last_re, last_im,
                                       self.stats.coarse_freq_hz + self.stats.fine_freq_hz)
            if bins and q > 3.0:
                self.stats.coarse_freq_hz += bins * spacing
                self.stats.coarse_adjustments += 1
            # bookkeeping: keep |fine| < half a carrier by moving whole
            # carriers into coarse (net unchanged)
            whole = round(self.stats.fine_freq_hz / spacing)
            if whole:
                self.stats.fine_freq_hz -= whole * spacing
                self.stats.coarse_freq_hz += whole * spacing
        self.stats.net_freq_hz = (self.stats.coarse_freq_hz
                                  + self.stats.fine_freq_hz)

        # timing drift check; each jump also trains the fractional
        # resampler's ppm estimate so jumps taper off once the rate matches
        if self._batches % self.timing_check_interval == 0:
            adj = self._timing_recheck(last_re, last_im)
            if adj:
                self.stats.timing_adjustments += 1
                if adj > 0:
                    self._residual = self._residual[adj:]
                else:
                    pad = frames[-1][adj:]
                    self._residual = np.concatenate([pad, self._residual])
            if self.drift_resample:
                batches = max(self.timing_check_interval, 1)
                span = batches * nf * p.nb_frame_length
                # adj is the residual drift after the current correction:
                # integrate with gain 0.5 (a damped servo on the ppm rate)
                self._drift_ppm += 0.5 * (adj / span * 1e6)
                if abs(self._drift_ppm) > 2.0:
                    ratio = 1.0 + self._drift_ppm * 1e-6
                    if self._resampler is None:
                        self._resampler = PolyphaseResampler(ratio)
                    else:
                        self._resampler.set_ratio(ratio)

    def _coarse_triage(self, last_re: torch.Tensor, last_im: torch.Tensor,
                       spacing: float) -> bool:
        """Desync triage: before giving up and reacquiring, check whether the
        'blackout' is just an integer-carrier frequency slip (invisible to
        the CP autocorrelation, which only sees CFO mod one carrier).
        Applies the bin fix and returns True when confident; a genuine
        timing break leaves the PRS correlation flat (low quality) and
        returns False so the normal reacquisition path runs."""
        bins, q = self._coarse_tap(last_re, last_im, self.stats.net_freq_hz)
        if bins == 0 or q <= 3.0:
            return False
        self.stats.coarse_freq_hz += bins * spacing
        self.stats.coarse_adjustments += 1
        self.stats.net_freq_hz = (self.stats.coarse_freq_hz
                                  + self.stats.fine_freq_hz)
        return True

    def _dashboard_taps(self, stats) -> None:
        """Signal power, constellation and its SNR from a batch's demod
        stats (on the device), in one read back."""
        k = stats["const_re"].shape[0]
        tap = torch.cat([stats["mean_power"].reshape(-1)[-1:].float(),
                         stats["const_re"].float(), stats["const_im"].float()]).cpu().numpy()
        self.stats.signal_power = float(tap[0])
        self.stats.const_re, self.stats.const_im = tap[1: 1 + k], tap[1 + k:]
        self.stats.snr_db = constellation_snr_db(self.stats.const_re, self.stats.const_im)

    # ---------------- main loop ----------------

    def run(self, max_batches: Optional[int] = None,
            on_outputs: Optional[Callable] = None) -> None:
        p = self.params
        if not self._acquire():
            return
        fib_err_prev = 0
        spacing = SAMPLING_RATE / p.nb_fft
        while not self._stop_requested and (
                max_batches is None or self._batches < max_batches):
            if self._pending_retune is not None:
                ch = self._pending_retune
                self._pending_retune = None
                self._do_retune(ch)
                if not self._acquire():
                    break
                fib_err_prev = self.receiver.stats["fib_crc_errors"]
            need = self.batch_frames * p.nb_frame_length
            with self.timers.stage("read"):
                buf = self._fill(need)
            if buf.shape[0] < p.nb_frame_length:
                break
            nf = buf.shape[0] // p.nb_frame_length
            frames = buf[: nf * p.nb_frame_length].reshape(nf, p.nb_frame_length)
            self._residual = buf[nf * p.nb_frame_length:]

            re, im = frames_on_device(frames, self.device)
            outputs, sstat = self._driver.decode(self.receiver, re, im, self.stats.net_freq_hz,
                                                 self.use_device_step, self.stats.total_frames,
                                                 self.timers)
            self._dashboard_taps(sstat)
            self.stats.total_frames += nf
            self._batches += 1

            last_re, last_im = re[-1].reshape(-1), im[-1].reshape(-1)
            with self.timers.stage("track"):
                self._track(frames, last_re, last_im, nf, spacing)

            # desync detection -> reacquire. Graded: an EMA of the per-batch
            # FIB CRC error rate crossing desync_threshold triggers resync
            # (a half-broken lock resyncs within a couple of batches); a
            # full blackout still reacts immediately
            errs = self.receiver.stats["fib_crc_errors"] - fib_err_prev
            fib_err_prev = self.receiver.stats["fib_crc_errors"]
            batch_rate = errs / max(nf * self.receiver.dab.nb_fibs, 1)
            b = self.fib_error_ema_beta
            self._fib_err_ema = b * self._fib_err_ema + (1 - b) * batch_rate
            if batch_rate >= 1.0 or self._fib_err_ema > self.desync_threshold:
                if (self.is_coarse_freq_correction
                        and self._coarse_triage(last_re, last_im, spacing)):
                    # integer-carrier slip repaired in place; a clean slate
                    # instead of a full (audio-gap) reacquisition
                    self._fib_err_ema = 0.0
                else:
                    self.stats.total_frames_desync += nf
                    self.stats.reacquisitions += 1
                    self._fib_err_ema = 0.0
                    if not self._acquire():
                        break
                    fib_err_prev = self.receiver.stats["fib_crc_errors"]

            # audio fan-out
            if self.audio is not None:
                with self.timers.stage("audio"):
                    self._render_audio(outputs)
            if on_outputs is not None:
                on_outputs(outputs)
        # end-of-stream: emit frames still held by a pending UEP calibration
        final = self.receiver.finalize()
        if final:
            if self.audio is not None:
                self._render_audio(final)
            if on_outputs is not None:
                on_outputs(final)
        self.stats.state = "STOPPED"

    def _render_audio(self, outputs) -> None:
        from tpudab_torch.audio.codecs import (AACDecoder, MP2Decoder,
                                               aac_decode_available,
                                               mp2_decode_available)
        for subch_id, out in outputs.items():
            ch = self.receiver.channels.get(subch_id)
            if ch is not None and not getattr(ch, "is_play_audio", True):
                continue  # per-channel play toggle (Basic_Audio_Channel)
            src = self.audio.add_source(subch_id)
            dec = self._decoders.get(subch_id)
            if out.is_dab_plus:
                for sf in out.superframes:
                    if sf.header is None:
                        continue
                    if dec is None and aac_decode_available():
                        dec = self._decoders[subch_id] = AACDecoder(sf.header)
                    if dec is None:
                        continue
                    for au, ok in zip(sf.access_units, sf.au_crc_ok):
                        if not ok:
                            continue
                        try:
                            pcm = dec.decode(bytes(au))
                        except ValueError:
                            continue
                        if pcm.shape[0]:
                            src.write(pcm, dec.sample_rate
                                      or sf.header.sampling_rate)
            else:
                if dec is None and mp2_decode_available():
                    dec = self._decoders[subch_id] = MP2Decoder()
                if dec is None:
                    continue
                for fr in out.mp2_frames:
                    try:
                        pcm = dec.decode(fr)
                    except ValueError:
                        continue
                    if pcm.shape[0]:
                        src.write(pcm, dec.sample_rate or 48000)

"""The wideband front end: receivers' s8 I/Q streams split into ensembles.

The reference is an SDR++ plugin: SDR++ opens one SDR source at the
device's own rate and its VFOs cut the stream into channels, the plugin
taking 2.048 MS/s from one of them. A ChannelPlan is that for several
receivers at once: each receiver (a HackRF One, say: 8-bit signed I/Q)
tuned to a centre and sampling at `rate_hz` = decimation x 2.048 MS/s,
and the Band III blocks (constants/channels.py) it covers, each at a whole
number of kHz from the centre. Ensemble e = s x blocks_per_receiver + b is
block b of receiver s.

For block b at offset f_b from its receiver's centre the channeliser
computes

    y_b[m] = sum_k h[k] x[D m - k] exp(-j 2 pi f_b (D m - k) / rate_hz)

(x the stream scaled by 1/128, D the decimation, n = D m - k the absolute
sample index, h the low-pass of design_taps), and writes y_b as the step's
bf16 split, lane-tiled frames ((E, F, frame_len // 128, 128) re and im,
what K5 takes). Ensemble e has a frame offset d_e in [0, frame_len): in a
step of F frames its frames start at output (k F - 1) frame_len + d_e, one
frame behind the stream, so a step reads the receiver's tail (its last
D frame_len + taps - 1 samples, carried from the step before, zero before
the first) and then its new D F frame_len samples. With every offset a
whole number of kHz and frames a multiple of 2048 outputs long, the mixing
phase of a step's stream depends only on the sample's place in it.

Two ways to the same numbers:
- channelise_ref, the plain version (the CPU's): per block, the stream mixed
  down in f32 and filtered and decimated by conv1d.
- on CUDA, csrc/channelise.cu (ops/channelise_cuda.py): the mixing folded
  into complex taps g_b[k] = h[k] exp(+j 2 pi f_b k / rate_hz), one real
  product of each output's 240-value window with the 240 x 16 matrix of
  the receiver's 8 blocks (gemm_taps, f16 chosen by f16_taps) on the
  tensor cores, then the rotation exp(-j 2 pi f_b D m / rate_hz) (a phase
  of 2048 steps) and a block's gain (tap_gains: the f16 taps' passband
  power made the design's).
  channelise_tables_ref is that arithmetic in plain torch.
The two agree within the f16 taps' and bf16 outputs' rounding.

Under a profiler the channeliser records the span demod.ddc (items: output
samples). Channeliser counts its calls, the wideband samples it took
(samples_in) and its kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import ClassVar, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpudab_torch.constants.channels import BAND_III, channel_labels
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.host.profiling import span
from tpudab_torch.ops.channelise_cuda import DECIMATION, TAPS, channelise_cuda

PHASES = 2048          # outputs a rotation period: f_b D / rate_hz = f_b in kHz / 2048
KHZ = 1000


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Receivers, each at a centre frequency with the Band III blocks it
    covers; the Kaiser beta and cutoff of the low-pass, and the passband it
    keeps (the active carriers). The taps, the decimation and so the
    stream's rate are the kernel's (ops/channelise_cuda.py: 120 taps,
    decimation 8, 16.384 MS/s); the kernel takes 8 blocks a receiver, the
    CPU path any number."""

    centres_hz: Tuple[float, ...]
    blocks: Tuple[Tuple[str, ...], ...]
    beta: float = 5.653
    cutoff_hz: float = 1_024_000.0
    passband_hz: float = 768_000.0
    taps: ClassVar[int] = TAPS
    decimation: ClassVar[int] = DECIMATION
    rate_hz: ClassVar[float] = float(DECIMATION * SAMPLING_RATE)

    def __post_init__(self):
        if len(self.centres_hz) != len(self.blocks) or not self.blocks \
                or len({len(b) for b in self.blocks}) != 1:
            raise ValueError("a plan has one centre and the same number of blocks a receiver")
        off = self.offsets_hz()
        if np.any(np.abs(off - np.rint(off / KHZ) * KHZ) > 1e-3):
            raise ValueError(f"block offsets {off.tolist()} are not whole kHz")
        if np.any(np.abs(off) + self.cutoff_hz > self.rate_hz / 2):
            raise ValueError("a block lies outside its receiver's band")

    @classmethod
    def band_iii(cls, centres_hz: Sequence[float], first: str = "5A",
                 blocks_per_receiver: int = 8, **kw) -> "ChannelPlan":
        """Receivers at `centres_hz` covering consecutive Band III blocks from
        `first`, blocks_per_receiver each."""
        labels = channel_labels()
        i = labels.index(first.strip().upper())
        n = blocks_per_receiver
        blocks = tuple(tuple(labels[i + n * s: i + n * (s + 1)]) for s in range(len(centres_hz)))
        if any(len(b) != n for b in blocks):
            raise ValueError(f"Band III has no {n * len(centres_hz)} blocks from {first}")
        return cls(tuple(float(c) for c in centres_hz), blocks, **kw)

    @property
    def receivers(self) -> int:
        return len(self.blocks)

    @property
    def blocks_per_receiver(self) -> int:
        return len(self.blocks[0])

    @property
    def n_ensembles(self) -> int:
        return self.receivers * self.blocks_per_receiver

    def offsets_hz(self) -> np.ndarray:
        """(receivers, blocks) float64: each block's frequency less its
        receiver's centre."""
        return np.array([[BAND_III[b] - c for b in bl]
                         for c, bl in zip(self.centres_hz, self.blocks)])

    def offsets_khz(self) -> np.ndarray:
        return np.rint(self.offsets_hz() / KHZ).astype(np.int64)

    def tail(self, mode: int = 1) -> int:
        """Samples a receiver carries from one step to the next."""
        return self.decimation * get_ofdm_params(mode).nb_frame_length + self.taps - 1


def design_taps(taps: int, beta: float, cutoff_hz: float, rate_hz: float) -> np.ndarray:
    """The linear-phase low-pass, float64: a Kaiser-windowed sinc of cutoff
    `cutoff_hz`, scaled to unity gain at DC."""
    k = np.arange(taps) - (taps - 1) / 2.0
    h = np.kaiser(taps, beta) * np.sinc(2.0 * cutoff_hz / rate_hz * k)
    return h / h.sum()


def plan_taps(plan: ChannelPlan) -> np.ndarray:
    return design_taps(plan.taps, plan.beta, plan.cutoff_hz, plan.rate_hz)


def _f16_pair(x: np.ndarray):
    """The f16 value nearest each x and the f16 on x's other side."""
    near = x.astype(np.float16)
    toward = np.where(near.astype(np.float64) >= x, np.float16(-np.inf), np.float16(np.inf))
    return near.astype(np.float64), np.nextafter(near, toward.astype(np.float16)).astype(np.float64)


@functools.lru_cache(maxsize=64)
def f16_taps(taps: int, beta: float, cutoff_hz: float, rate_hz: float, reach_hz: float,
             offset_hz: float, points: int = 2049, sweeps: int = 8) -> np.ndarray:
    """The complex taps g[k] = h[k] exp(+j 2 pi offset k / rate) with each
    real and imaginary part one of its two nearest f16 values, chosen by
    coordinate descent to minimise the mean squared error of the filter's
    response over the +-reach_hz that reach the decimated output (the
    passband and the transition band, where a strong neighbour's edge
    carriers pass). Rounding each part to the nearest f16 errs there by
    5-7e-5 RMS; this choice by 1-2.4e-5, so a frame's mean power holds to
    the float64 design's within ~1e-5 (complex128 of f16 values)."""
    h = design_taps(taps, beta, cutoff_hz, rate_hz)
    k = np.arange(taps)
    g = h * np.exp(2j * np.pi * offset_hz * k / rate_hz)
    f = np.linspace(-reach_hz, reach_hz, points)
    e = np.exp(-2j * np.pi * np.outer(f + offset_hz, k) / rate_hz)
    basis = np.concatenate([e, 1j * e], axis=1)             # d response / d part
    exact = np.concatenate([g.real, g.imag])
    cur, alt = _f16_pair(exact)
    err = basis @ (cur - exact)
    cost = np.mean(np.abs(err) ** 2)
    for _ in range(sweeps):
        changed = False
        for j in range(exact.size):
            trial = err + (alt[j] - cur[j]) * basis[:, j]
            c = np.mean(np.abs(trial) ** 2)
            if c < cost:
                err, cost, changed = trial, c, True
                cur[j], alt[j] = alt[j], cur[j]
        if not changed:
            break
    return cur[:taps] + 1j * cur[taps:]


def gemm_taps(plan: ChannelPlan) -> torch.Tensor:
    """(receivers, 2 taps, 2 blocks) f16: row 2i + {0, 1} is the I, Q of
    window sample i (sample D m - taps + 1 + i of output m), column 2b + {0,
    1} the real, imaginary part of block b before the rotation; from
    g_b[k] = h[k] exp(+j 2 pi f_b k / rate_hz), k = taps - 1 - i, in f16
    (f16_taps)."""
    off = plan.offsets_hz()
    s_n, b_n = off.shape
    reach = 2.0 * plan.cutoff_hz - plan.passband_hz
    g = np.array([[f16_taps(plan.taps, plan.beta, plan.cutoff_hz, plan.rate_hz, reach, float(f))
                   for f in row] for row in off])
    g = g[:, :, ::-1]                               # window sample i = taps - 1 - k
    out = np.zeros((s_n, plan.taps, 2, b_n, 2))
    out[:, :, 0, :, 0] = g.real.transpose(0, 2, 1)
    out[:, :, 1, :, 0] = -g.imag.transpose(0, 2, 1)
    out[:, :, 0, :, 1] = g.imag.transpose(0, 2, 1)
    out[:, :, 1, :, 1] = g.real.transpose(0, 2, 1)
    return torch.from_numpy(out.reshape(s_n, 2 * plan.taps, 2 * b_n)).to(torch.float16)


def tap_gains(plan: ChannelPlan, b_taps: torch.Tensor, points: int = 1537) -> torch.Tensor:
    """(receivers, blocks) f32: for each block, the factor that gives the
    f16 taps of b_taps (gemm_taps) the float64 design's mean power gain
    over the passband. Rounding 120 complex taps to f16 moves a block's
    passband power by a few 1e-5, which a frame's mean power would show."""
    k = np.arange(plan.taps)
    d = np.linspace(-plan.passband_hz, plan.passband_hz, points)
    design = np.exp(-2j * np.pi * np.outer(d, k) / plan.rate_hz) @ plan_taps(plan)
    want = np.mean(np.abs(design) ** 2)
    b = b_taps.double().numpy()
    out = np.empty(plan.offsets_hz().shape)
    for s, offs in enumerate(plan.offsets_hz()):
        for j, f in enumerate(offs):
            g = (b[s, 0::2, 2 * j] + 1j * b[s, 0::2, 2 * j + 1])[::-1]     # g_b[k], k = 0..
            e = np.exp(-2j * np.pi * np.outer(d + f, k) / plan.rate_hz)
            out[s, j] = np.sqrt(want / np.mean(np.abs(e @ g) ** 2))
    return torch.from_numpy(out).float()


def mma_fragments(b: torch.Tensor) -> torch.Tensor:
    """gemm_taps' (S, 16 K, 16) f16 as the kernel's mma B fragments,
    (S, K, 2, 32, 4) f16: for k-step kk, n-tile nt and lane 4 g + t, rows
    16 kk + (2t, 2t + 1, 2t + 8, 2t + 9) of column 8 nt + g."""
    s_n, k2, n = b.shape
    if k2 % 16 or n != 16:
        raise ValueError(f"B {tuple(b.shape)} is not (S, 16 K, 16)")
    t = torch.arange(4)
    rows = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=-1)   # (t, 4)
    v = b.view(s_n, k2 // 16, 16, 2, 8)                                       # (S, kk, row, nt, g)
    f = v[:, :, rows]                                       # (S, kk, t, 4, nt, g)
    return f.permute(0, 1, 4, 5, 2, 3).reshape(s_n, k2 // 16, 2, 32, 4).contiguous()


def frame_offsets(frame_offset, n_ensembles: int, frame_len: int, device) -> torch.Tensor:
    """(E,) int32 frame offsets on `device` from a tensor, a sequence or
    None (all 0), each in [0, frame_len): checked here unless frame_offset
    is a tensor on the card (Channeliser checks those)."""
    if frame_offset is None:
        return torch.zeros(n_ensembles, dtype=torch.int32, device=device)
    d = torch.as_tensor(frame_offset).reshape(-1)
    if d.numel() != n_ensembles:
        raise ValueError(f"{d.numel()} frame offsets for {n_ensembles} ensembles")
    if d.device.type == "cpu":
        _check_offsets(d, frame_len)
    return d.to(device=device, dtype=torch.int32)


def _check_offsets(d: torch.Tensor, frame_len: int) -> None:
    if bool(((d < 0) | (d >= frame_len)).any()):
        raise ValueError(f"frame offsets lie in [0, {frame_len}): got {d.tolist()}")


def _stream(tail: torch.Tensor, streams: torch.Tensor) -> torch.Tensor:
    """The step's stream, tail then new samples, (S, L, 2) f32 scaled by 1/128."""
    return torch.cat([tail, streams], dim=1).float() / 128.0


def _write_frames(y: torch.Tensor, e: int, d: int, out_re, out_im):
    """Outputs d .. d + F frame_len of one block into ensemble e's frames."""
    n = out_re[e].numel()
    out_re[e].view(-1).copy_(y.real[d:d + n])
    out_im[e].view(-1).copy_(y.imag[d:d + n])


def channelise_ref(tail, streams, offsets, plan: ChannelPlan, out_re, out_im):
    """The plain channeliser into out_re / out_im ((E, F, frame_len // 128,
    128) bf16): per block the stream mixed down in f32 (phase exact, from
    whole kHz and the sample's integer index) and filtered and decimated by
    conv1d. tail (S, T, 2), streams (S, N, 2) int8; offsets (E,) ints."""
    d_all = [int(v) for v in offsets.tolist()]
    x = _stream(tail, streams)
    s_n, length, _ = x.shape
    h = torch.from_numpy(plan_taps(plan)[::-1].copy()).float().view(1, 1, -1)
    idx = torch.arange(length, dtype=torch.int64, device=x.device) - (plan.taps - 1)
    h = h.to(x.device)
    for s in range(s_n):
        xs = torch.complex(x[s, :, 0], x[s, :, 1])
        for b, f_khz in enumerate(plan.offsets_khz()[s].tolist()):
            ph = (f_khz * idx) % (PHASES * plan.decimation)
            rot = torch.polar(torch.ones(length, dtype=torch.float64, device=x.device),
                              -2.0 * math.pi * ph.double() / (PHASES * plan.decimation))
            z = xs * rot.to(torch.complex64)
            parts = torch.stack([z.real, z.imag])[:, None]
            y = torch.nn.functional.conv1d(parts, h, stride=plan.decimation)[:, 0]
            e = s * plan.blocks_per_receiver + b
            _write_frames(torch.complex(y[0], y[1]), e, d_all[e], out_re, out_im)


def channelise_tables_ref(tail, streams, offsets, plan: ChannelPlan, b_taps, scale, out_re,
                          out_im):
    """The kernel's arithmetic in plain torch: each output's 240-value
    window of the int8 stream (exact) times the f16 taps matrix b_taps
    (gemm_taps), summed in f32, then rotated by exp(-j 2 pi i / 2048), i =
    (f_b kHz x m) mod 2048, times the block's scale (1/128 and its
    tap_gains gain). Same contract as channelise_ref."""
    d_all = [int(v) for v in offsets.tolist()]
    x = torch.cat([tail, streams], dim=1).float().reshape(tail.shape[0], -1)
    s_n, vals = x.shape
    width, step = 2 * plan.taps, 2 * plan.decimation
    rows = (vals - width) // step + 1
    m = torch.arange(rows, dtype=torch.int64, device=x.device)
    for s in range(s_n):
        win = x[s].as_strided((rows, width), (step, 1))
        y = (win @ b_taps[s].float()).view(rows, -1, 2)
        for b, f_khz in enumerate(plan.offsets_khz()[s].tolist()):
            ph = (2.0 * math.pi / PHASES) * ((f_khz % PHASES * (m % PHASES)) % PHASES).double()
            cs = torch.stack([torch.cos(ph), torch.sin(ph)], dim=-1).float() * scale[s, b]
            yr, yi = y[:, b, 0], y[:, b, 1]
            out = torch.complex(yr * cs[:, 0] + yi * cs[:, 1], yi * cs[:, 0] - yr * cs[:, 1])
            e = s * plan.blocks_per_receiver + b
            _write_frames(out, e, d_all[e], out_re, out_im)


class Channeliser(nn.Module):
    """A ReceiveStep's channeliser for one plan: its taps, the kernel's
    operands (registered buffers, moved by .to), the frames buffer it
    writes and its counters; see the module's docstring.

    forward(tail, streams, frame_offset) -> (next tail, frames_re,
    frames_im): tail (S, T, 2) int8 (init_tail), streams (S, N, 2) or
    flat (S, 2 N) int8 with N = D F frame_len, frame_offset (E,) or None.
    The frames are this channeliser's buffer, valid until its next call
    (a stable address, so the demod's graph replays on it)."""

    def __init__(self, plan: ChannelPlan, mode: int = 1):
        super().__init__()
        self.plan = plan
        self.mode = mode
        self.frame_len = get_ofdm_params(mode).nb_frame_length
        self.n_tail = plan.tail(mode)
        b = gemm_taps(plan)
        self.register_buffer("b_taps", b, persistent=False)
        self.register_buffer("frag", mma_fragments(b) if b.shape[2] == 16 else b.new_empty(0),
                             persistent=False)           # the kernel's 8 blocks a receiver
        self.register_buffer("scale", tap_gains(plan, b) / 128.0, persistent=False)
        self.register_buffer("phase_step", torch.from_numpy(
            plan.offsets_khz() % PHASES).to(torch.int32), persistent=False)
        self.out: Optional[torch.Tensor] = None
        self.calls = self.samples_in = self.launches = 0
        self._checked = (None, -1)   # the card's offsets tensor last checked, its version

    def init_tail(self, device, zero: bool = True) -> torch.Tensor:
        """Tails, (S, T, 2) int8, zero (the stream before its first sample)
        unless zero=False; each row 16-byte aligned, its storage holding T
        rounded up to 8 samples."""
        padded = -(-self.n_tail // 8) * 8
        make = torch.zeros if zero else torch.empty
        return make((self.plan.receivers, padded, 2), dtype=torch.int8,
                    device=device)[:, :self.n_tail]

    def _frames(self, f: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (2, self.plan.n_ensembles, f, self.frame_len // 128, 128)
        if self.out is None or self.out.shape != shape or self.out.device != device:
            self.out = None                      # freed before the new one is made
            self.out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        return self.out[0], self.out[1]

    def forward(self, tail: torch.Tensor, streams: torch.Tensor, frame_offset=None):
        plan = self.plan
        s_n = plan.receivers
        if streams.dtype != torch.int8 or streams.shape[0] != s_n:
            raise ValueError(f"wideband streams are ({s_n}, samples, 2) int8, got "
                             f"{tuple(streams.shape)} {streams.dtype}")
        streams = streams.reshape(s_n, -1, 2)
        n = streams.shape[1]
        per_frame = plan.decimation * self.frame_len
        if n % per_frame:
            raise ValueError(f"{n} samples a receiver are not whole frames of {per_frame}")
        if tuple(tail.shape) != (s_n, self.n_tail, 2) or tail.dtype != torch.int8:
            raise ValueError(f"tail {tuple(tail.shape)} {tail.dtype} is not "
                             f"({s_n}, {self.n_tail}, 2) int8")
        f = n // per_frame
        dev = streams.device
        out_re, out_im = self._frames(f, dev)
        offsets = frame_offsets(frame_offset, plan.n_ensembles, self.frame_len, dev)
        if isinstance(frame_offset, torch.Tensor) and frame_offset.device.type != "cpu":
            ref, version = self._checked
            if ref is None or ref() is not frame_offset or version != frame_offset._version:
                _check_offsets(frame_offset, self.frame_len)    # a read to the host, once
                self._checked = (weakref.ref(frame_offset), frame_offset._version)
        with span("demod.ddc", out_re.numel(), dev):
            if dev.type == "cpu":
                channelise_ref(tail, streams, offsets, plan, out_re, out_im)
                new_tail = torch.cat([tail, streams], dim=1)[:, -self.n_tail:]
            else:
                new_tail = self.init_tail(dev, zero=False)
                channelise_cuda(tail, streams, self.frag, self.phase_step, self.scale, offsets,
                                out_re, out_im, new_tail, plan)
                self.launches += 1
        self.calls += 1
        self.samples_in += s_n * n
        return new_tail, out_re, out_im

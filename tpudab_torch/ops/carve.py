"""Carve + rotate: IQ frames -> PLL-rotated FFT windows, kernel K5.

Counterpart of tpudab.ops.carve.carve_rotate. For each frame and symbol s
it takes the n_fft window starting at null + s*(n_fft+n_cp) + n_cp -
window_offset and rotates it by exp(-2 pi j f t_abs / fs); re and im stay
split. A CPU tensor takes carve_rotate_ref, which follows tpudab's XLA
slice path (tpudab/ofdm/demod.py:175-194); a CUDA tensor takes the kernel
in csrc/carve.cu, which builds the rotator by angle addition of two f32
tables as the Pallas kernel does (tpudab/ops/carve.py:123-136). The two
agree within one bf16 ulp; carve_rotate_tables_ref is the kernel's own
arithmetic in torch, which it matches bit for bit. with_sum adds a third
output, the bf16 sum xr + xi that the demod's first Karatsuba product
takes (tpudab/ofdm/demod.py:214).

rtl_sdr's raw IQ: frames_re may instead be (F, frame_len, 2) or flat
(F, 2 frame_len) uint8, interleaved offset-binary I/Q, with frames_im None.
The plain twins convert it with u8_parts, (x - 127.5) / 128, exact in f32;
the kernel's u8 instantiation does the same conversion in registers, so it
gives the f32 kernel's outputs on the converted frames bit for bit.

A tracked stream's frames (ofdm/track.py): u8 frames may also be handed as
one buffer of I/Q pairs (one dongle's segment a row) with `starts`, each
frame's first pair as an offset into the flattened buffer. The plain twins
gather the frames first (u8_frames_at); the kernel reads them in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudab_torch.constants.ofdm_params import get_ofdm_params, SAMPLING_RATE
from tpudab_torch.ops import _build

# the kernels' frame type code (csrc/carve.cu, csrc/demod_tail.cu)
IN_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _geometry(mode: int, window_offset: int):
    p = get_ofdm_params(mode)
    first = p.nb_null_period + p.nb_cyclic_prefix - window_offset
    return p, first, p.nb_fft + p.nb_cyclic_prefix


def _flat(x: torch.Tensor, frame_len: int) -> torch.Tensor:
    if x.shape[-1] != frame_len and x.shape[1:] != (frame_len // 128, 128):
        raise ValueError(f"frames {tuple(x.shape)} are not (F, {frame_len}) "
                         f"or (F, {frame_len // 128}, 128)")
    return x.reshape(x.shape[0], frame_len)


def u8_flat(frames: torch.Tensor, frame_len: int, frames_im=None) -> torch.Tensor:
    """rtl_sdr's raw frames, (F, frame_len, 2) or (F, 2 frame_len) uint8
    interleaved I/Q, handed with frames_im None -> (F, 2 frame_len)."""
    if frames_im is not None:
        raise ValueError("u8 frames hold I and Q interleaved: pass frames_im None")
    if frames.dtype != torch.uint8 or (frames.shape[1:] != (frame_len, 2)
                                       and frames.shape[1:] != (2 * frame_len,)):
        raise ValueError(f"u8 frames {tuple(frames.shape)} {frames.dtype} are not "
                         f"(F, {frame_len}, 2) or (F, {2 * frame_len}) uint8")
    return frames.reshape(frames.shape[0], 2 * frame_len)


def u8_frames_at(buffer: torch.Tensor, starts: torch.Tensor, frame_len: int) -> torch.Tensor:
    """A tracked stream's u8 frames: buffer (..., 2) uint8 I/Q pairs, any
    leading shape (flattened), and starts (F,) int64, each frame's first
    pair there -> (F, frame_len, 2) uint8, gathered."""
    if buffer.dtype != torch.uint8 or buffer.shape[-1] != 2 or starts.dtype != torch.int64:
        raise ValueError(f"frames at starts take a uint8 (..., 2) buffer and int64 starts; got "
                         f"{tuple(buffer.shape)} {buffer.dtype}, {starts.dtype}")
    pairs = buffer.reshape(-1, 2)
    return pairs[starts.reshape(-1, 1) + torch.arange(frame_len, device=pairs.device)]


def u8_parts(frames: torch.Tensor, frame_len: int, frames_im=None):
    """rtl_sdr's raw frames as u8_flat takes them -> (re, im), each
    (F, frame_len) f32: (x - 127.5) / 128, exact in f32."""
    x = u8_flat(frames, frame_len, frames_im).view(frames.shape[0], frame_len, 2).float()
    x = (x - 127.5) / 128.0
    return x[..., 0].contiguous(), x[..., 1].contiguous()


def _parts(frames_re, frames_im, frame_len: int):
    """The frames as (F, frame_len) re and im parts: split parts as they
    are, or u8 frames (frames_im None) converted by u8_parts."""
    if frames_re.dtype == torch.uint8:
        return u8_parts(frames_re, frame_len, frames_im)
    return _flat(frames_re, frame_len), _flat(frames_im, frame_len)


def _windows(x: torch.Tensor, mode: int, window_offset: int) -> torch.Tensor:
    """(F, frame_len) -> (F, n_sym, n_fft) strided view of the FFT windows."""
    p, first, stride = _geometry(mode, window_offset)
    start = first - p.nb_null_period
    sym = x[:, p.nb_null_period:].reshape(x.shape[0], p.nb_symbols, stride)
    return sym[:, :, start:start + p.nb_fft]


def _freq(freq_hz, f: int, device) -> torch.Tensor:
    return torch.as_tensor(freq_hz, dtype=torch.float32,
                           device=device).broadcast_to((f,))


def carve_windows(frames_re, frames_im, freq_hz, mode: int = 1,
                  window_offset: int = 12, out_dtype=torch.bfloat16):
    """Plain torch carve + rotate with the phase taken per sample from the
    absolute sample time: returns (F, n_sym, n_fft) re/im in out_dtype."""
    p, first, stride = _geometry(mode, window_offset)
    n_sym, n_fft = p.nb_symbols, p.nb_fft
    f = frames_re.shape[0]
    fr, fi = _parts(frames_re, frames_im, p.nb_frame_length)
    wr, wi = _windows(fr, mode, window_offset), _windows(fi, mode, window_offset)
    t_sym = (first + stride * np.arange(n_sym)) / SAMPLING_RATE
    t_k = np.arange(n_fft) / SAMPLING_RATE
    t_abs = torch.as_tensor((t_sym[:, None] + t_k[None, :]).astype(np.float32),
                            device=fr.device)
    freq = _freq(freq_hz, f, fr.device)
    ph = (-2.0 * math.pi) * freq[:, None, None] * t_abs[None]
    c, s = torch.cos(ph), torch.sin(ph)
    return (wr * c - wi * s).to(out_dtype), (wr * s + wi * c).to(out_dtype)


def carve_rotate_ref(frames_re, frames_im, freq_hz, mode: int = 1,
                     window_offset: int = 12, with_sum: bool = False):
    """Plain torch twin of the kernel: (F, frame_len//128, 128) frames (or
    flat (F, frame_len)), bf16 or f32, or u8 frames with frames_im None,
    and (F,) or scalar freq ->
    (F, n_sym * n_fft//128, 128) bf16 re/im, tpudab's layout, and with_sum
    their bf16 sum xr + xi as a third."""
    xr, xi = carve_windows(frames_re, frames_im, freq_hz, mode, window_offset)
    return _outputs(xr, xi, with_sum)


def _outputs(xr, xi, with_sum: bool):
    f = xr.shape[0]
    out = (xr.reshape(f, -1, 128), xi.reshape(f, -1, 128))
    return out + (out[0] + out[1],) if with_sum else out


def rotator_tables(freq: torch.Tensor, mode: int, window_offset: int):
    """f32 tables of carve.py:123-136 for (F,) freq: the window-start
    rotator (ca, sa) of shape (F, n_sym) and the in-window ramp (ci, si) of
    shape (F, n_fft). Built on freq's device with no copy from the host (a
    copy from pageable memory would wait for the stream): the window
    starts are integers below 2^24, exact in f32."""
    p, first, stride = _geometry(mode, window_offset)
    scale = (-2.0 * np.pi / SAMPLING_RATE) * freq
    idx = torch.arange(p.nb_fft, dtype=torch.float32, device=freq.device)
    ph_idx = scale[:, None] * idx[None, :]
    a_sym = (first + stride * torch.arange(p.nb_symbols, device=freq.device)).to(torch.float32)
    ph_a = scale[:, None] * a_sym[None, :]
    return (torch.cos(ph_a), torch.sin(ph_a),
            torch.cos(ph_idx), torch.sin(ph_idx))


def carve_rotate_tables_ref(frames_re, frames_im, freq_hz, mode: int = 1,
                            window_offset: int = 12, with_sum: bool = False, starts=None):
    """The kernel's own arithmetic in plain torch f32, one op per rounding:
    the rotator by angle addition of rotator_tables, then the rotation,
    each product and sum rounded to f32, then bf16. On the same device as
    the kernel it gives the kernel's outputs bit for bit; it is within one
    bf16 ulp of carve_rotate_ref. Same contract as carve_rotate_ref, and
    carve_rotate's `starts`."""
    p = get_ofdm_params(mode)
    if starts is not None:
        frames_re = u8_frames_at(frames_re, starts, p.nb_frame_length)
    fr, fi = (x.float() for x in _parts(frames_re, frames_im, p.nb_frame_length))
    ca, sa, ci, si = rotator_tables(_freq(freq_hz, fr.shape[0], fr.device), mode,
                                    window_offset)
    wr, wi = _windows(fr, mode, window_offset), _windows(fi, mode, window_offset)
    ca, sa, ci, si = ca[:, :, None], sa[:, :, None], ci[:, None, :], si[:, None, :]
    c = ca * ci - sa * si
    s = sa * ci + ca * si
    xr = (wr * c - wi * s).to(torch.bfloat16)
    xi = (wr * s + wi * c).to(torch.bfloat16)
    return _outputs(xr, xi, with_sum)


def carve_rotate_cuda(frames_re, frames_im, freq_hz, mode: int = 1,
                      window_offset: int = 12, with_sum: bool = False, starts=None):
    """Kernel K5 on CUDA tensors; same contract as carve_rotate_ref, and
    carve_rotate's `starts`. The frames must be 16-byte aligned."""
    p, first, stride = _geometry(mode, window_offset)
    if starts is not None:
        if frames_im is not None or frames_re.dtype != torch.uint8 or frames_re.shape[-1] != 2 \
                or starts.dtype != torch.int64 or not starts.is_cuda \
                or not starts.is_contiguous():
            raise ValueError("frames at starts are a u8 (..., 2) buffer alone and contiguous "
                             "int64 starts on the card")
        fr = fi = frames_re.reshape(-1, 2)
    elif frames_re.dtype == torch.uint8:
        fr = fi = u8_flat(frames_re, p.nb_frame_length, frames_im)
    else:
        fr = _flat(frames_re, p.nb_frame_length)
        fi = _flat(frames_im, p.nb_frame_length)
    if not (fr.is_cuda and fi.is_cuda) or fr.dtype != fi.dtype \
            or fr.dtype not in (torch.bfloat16, torch.float32, torch.uint8) \
            or not (fr.is_contiguous() and fi.is_contiguous()) \
            or fr.data_ptr() % 16 or fi.data_ptr() % 16:
        raise ValueError(f"carve_rotate_cuda takes contiguous, 16-byte aligned "
                         f"CUDA bf16 or f32 frames, or u8 frames alone, got {fr.device} "
                         f"{fr.dtype}, {fi.device} {fi.dtype}")
    f = fr.shape[0] if starts is None else starts.numel()
    freq = _freq(freq_hz, f, fr.device).contiguous()
    ca, sa, ci, si = rotator_tables(freq, mode, window_offset)
    rows = p.nb_symbols * (p.nb_fft // 128)
    xr = torch.empty((f, rows, 128), dtype=torch.bfloat16, device=fr.device)
    xi = torch.empty_like(xr)
    xs = torch.empty_like(xr) if with_sum else None
    _build.launch(_build.load_library().tpudab_carve_rotate, fr.get_device(), "carve_rotate",
                  fr.data_ptr(), fi.data_ptr(), IN_DTYPE[fr.dtype],
                  ca.data_ptr(), sa.data_ptr(), ci.data_ptr(), si.data_ptr(), xr.data_ptr(),
                  xi.data_ptr(), xs.data_ptr() if with_sum else None,
                  None if starts is None else starts.data_ptr(),
                  f, p.nb_frame_length, p.nb_symbols, p.nb_fft, stride, first)
    carve_rotate_cuda.launches += 1
    return (xr, xi, xs) if with_sum else (xr, xi)


carve_rotate_cuda.launches = 0


def carve_rotate(frames_re, frames_im, freq_hz, mode: int = 1,
                 window_offset: int = 12, with_sum: bool = False, starts=None):
    """Dispatch on the frames' device: CPU -> plain torch, CUDA -> K5.
    starts: (F,) int64 with frames_re a u8 (..., 2) buffer of I/Q pairs and
    frames_im None, frame f's first pair at starts[f] of the flattened
    buffer (a tracked stream's frames), every frame inside it."""
    if frames_re.device.type == "cpu":
        if starts is not None:
            frames_re = u8_frames_at(frames_re, starts, get_ofdm_params(mode).nb_frame_length)
        return carve_rotate_ref(frames_re, frames_im, freq_hz, mode,
                                window_offset, with_sum)
    return carve_rotate_cuda(frames_re, frames_im, freq_hz, mode,
                             window_offset, with_sum, starts)

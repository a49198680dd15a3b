"""MSC time deinterleave (EN 300 401 sec 12): the ring gather, kernel K4.

Counterpart of tpudab.msc.interleave.deinterleave_batch, with the port's
own copy of that module's numpy parts (the delay table and the
synthesizer-side interleave_np).

    out[..., i, col] = buf[..., i + d(col mod 16), col]

with d the bit-reversed 0..15 delay table and buf holding 15 rows of
history before the c new CIF slices. Pure selection, so exact in any dtype.
A CPU tensor takes deinterleave_ref; a CUDA tensor the kernel in
csrc/deinterleave.cu.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpudab_torch.ops import _build

__all__ = ["TIME_INTERLEAVE_DEPTH", "interleave_delays", "interleave_np",
           "deinterleave_batch", "deinterleave_ref", "deinterleave_cuda"]

TIME_INTERLEAVE_DEPTH = 16

# d(i mod 16): bit-reversed 0..15 sequence
_DELAYS = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15],
                   dtype=np.int32)


@functools.lru_cache(maxsize=None)
def interleave_delays(n_bits: int) -> np.ndarray:
    """Per-bit delay vector d(i mod 16) of length n_bits."""
    reps = -(-n_bits // 16)
    return np.tile(_DELAYS, reps)[:n_bits].copy()


def interleave_np(logical_frames: np.ndarray) -> np.ndarray:
    """Synthesizer-side interleave.

    logical_frames: (n_frames, n_bits) punctured codewords u_m (0/1 or soft).
    Returns transmitted CIF slices C_n of identical shape; frames with
    m < 0 contribute zeros.
    """
    n_frames, n_bits = logical_frames.shape
    d = interleave_delays(n_bits)
    rows = np.arange(n_frames)[:, None] - d[None, :]
    cols = np.broadcast_to(np.arange(n_bits)[None, :], rows.shape)
    valid = rows >= 0
    return np.where(valid, logical_frames[np.maximum(rows, 0), cols], 0)


def _check(buf: torch.Tensor, c: int):
    s = buf.shape[-1]
    if buf.shape[-2] != c + TIME_INTERLEAVE_DEPTH - 1 or s % TIME_INTERLEAVE_DEPTH:
        raise ValueError(f"deinterleave buffer {tuple(buf.shape)} does not "
                         f"hold {TIME_INTERLEAVE_DEPTH - 1} + {c} rows of a "
                         f"width that is a multiple of {TIME_INTERLEAVE_DEPTH}")


def deinterleave_ref(buf: torch.Tensor, c: int) -> torch.Tensor:
    """Plain torch gather: buf (..., c+15, S) -> (..., c, S)."""
    _check(buf, c)
    s = buf.shape[-1]
    d = torch.as_tensor(interleave_delays(s), dtype=torch.long, device=buf.device)
    rows = torch.arange(c, device=buf.device)[:, None] + d[None, :]   # (c, S)
    rows = rows.expand(buf.shape[:-2] + (c, s))
    return torch.gather(buf, -2, rows)


def deinterleave_cuda(buf: torch.Tensor, c: int) -> torch.Tensor:
    """Kernel K4 on a CUDA tensor: buf (E, c+15, S) or (c+15, S),
    contiguous, 2- or 4-byte elements."""
    _check(buf, c)
    if not buf.is_cuda or buf.dim() not in (2, 3) or not buf.is_contiguous() \
            or buf.element_size() not in (2, 4):
        raise ValueError(f"deinterleave_cuda takes a contiguous CUDA tensor "
                         f"of 2 or 3 dims with 2- or 4-byte elements, got "
                         f"{buf.device} {buf.dtype} {tuple(buf.shape)}")
    e = buf.shape[0] if buf.dim() == 3 else 1
    s = buf.shape[-1]
    out = torch.empty(buf.shape[:-2] + (c, s), dtype=buf.dtype, device=buf.device)
    lib = _build.load_library()
    with torch.cuda.device(buf.device):
        err = lib.tpudab_deinterleave(
            ctypes.c_void_p(buf.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            e, c, s, buf.element_size(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "deinterleave")
    deinterleave_cuda.launches += 1
    return out


deinterleave_cuda.launches = 0


def deinterleave_batch(buf: torch.Tensor, c: int) -> torch.Tensor:
    """buf (..., c+15, S) CIF slices with 15 rows of history prepended ->
    (..., c, S) logical frames. Dispatches on buf's device."""
    if buf.device.type == "cpu":
        return deinterleave_ref(buf, c)
    return deinterleave_cuda(buf, c)

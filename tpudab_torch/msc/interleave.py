"""MSC time deinterleave (EN 300 401 sec 12): the ring gather, kernel K4.

Counterpart of tpudab.msc.interleave.deinterleave_batch, with the port's
own copy of that module's numpy parts (the delay table, the
synthesizer-side interleave_np and the receiver-side oracle
deinterleave_np).

    out[..., i, col] = buf[..., i + d(col mod 16), col]

with d the bit-reversed 0..15 delay table and buf holding 15 rows of
history before the c new CIF slices. Pure selection, so exact in any dtype.

Two entries, each dispatching on the tensor's device (CPU: the plain
twin; CUDA: the kernel in csrc/deinterleave.cu, or an error):
- deinterleave_batch: logical rows from a (..., c+15, S) buffer (the host
  path's SubchannelDecoder);
- deinterleave_depuncture_t: the receive step's whole index chain for one
  subchannel, from the flat soft bits and the carry straight to its
  columns of the Viterbi input (T2p, 8, B), plus the new carry; at depth 1
  the same for the FIC's FIB groups.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from tpudab_torch.constants.dab_params import CIF_BITS
from tpudab_torch.fec.depuncture import depuncture_t
from tpudab_torch.ops import _build

__all__ = ["TIME_INTERLEAVE_DEPTH", "interleave_delays", "interleave_np", "deinterleave_np",
           "deinterleave_batch", "deinterleave_ref", "deinterleave_cuda",
           "SoftRows", "deinterleave_depuncture_t", "deinterleave_depuncture_t_ref",
           "deinterleave_depuncture_t_cuda"]

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


def deinterleave_np(cif_slices: np.ndarray) -> np.ndarray:
    """Receiver-side numpy oracle: C_n -> u_m (valid for m <= n_frames-1-15).

    Returns (n_frames, n_bits); rows m > n_frames-16 are partially zero
    (future CIFs unavailable).
    """
    n_frames, n_bits = cif_slices.shape
    d = interleave_delays(n_bits)
    rows = np.arange(n_frames)[:, None] + d[None, :]
    cols = np.broadcast_to(np.arange(n_bits)[None, :], rows.shape)
    valid = rows < n_frames
    return np.where(valid, cif_slices[np.minimum(rows, n_frames - 1), cols], 0)


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
    _build.launch(_build.load_library().tpudab_deinterleave, buf.get_device(), "deinterleave",
                  buf.data_ptr(), out.data_ptr(), e, c, s, buf.element_size())
    deinterleave_cuda.launches += 1
    return out


deinterleave_cuda.launches = 0


def deinterleave_batch(buf: torch.Tensor, c: int) -> torch.Tensor:
    """buf (..., c+15, S) CIF slices with 15 rows of history prepended ->
    (..., c, S) logical frames. Dispatches on buf's device."""
    if buf.device.type == "cpu":
        return deinterleave_ref(buf, c)
    return deinterleave_cuda(buf, c)


@dataclasses.dataclass(frozen=True)
class SoftRows:
    """Where a chain's input rows lie in the flat soft bits (E*F,
    frame_bits): row n of ensemble e (F frames each) is the `width` bits at
    soft[e*F + n // per_frame, base + (n % per_frame) * pitch]."""

    base: int
    per_frame: int
    pitch: int
    width: int

    @classmethod
    def cif_slices(cls, nb_fic_bits: int, nb_cifs: int, start_bit: int,
                   slice_bits: int) -> "SoftRows":
        """A subchannel's CIF slices, as msc.subchannel.subch_cif_slices."""
        return cls(nb_fic_bits + start_bit, nb_cifs, CIF_BITS, slice_bits)

    @classmethod
    def fib_groups(cls, n_groups: int, group_bits: int) -> "SoftRows":
        """The FIC's FIB groups at the head of each frame."""
        return cls(0, n_groups, group_bits, group_bits)

    def view(self, soft: torch.Tensor) -> torch.Tensor:
        """Contiguous (E*F, frame_bits) -> (E*F, per_frame, width) view."""
        return soft.as_strided((soft.shape[0], self.per_frame, self.width),
                               (soft.shape[1], self.pitch, 1),
                               soft.storage_offset() + self.base)


def _chain_shape(soft, rows: SoftRows, carry, index, n_punct: int, out, col0: int):
    """Check a deinterleave_depuncture_t call; return (E, c): ensembles and
    codewords per ensemble."""
    hist = TIME_INTERLEAVE_DEPTH - 1
    if soft.dim() != 2 or not soft.is_contiguous() \
            or rows.base + (rows.per_frame - 1) * rows.pitch + rows.width > soft.shape[1]:
        raise ValueError(f"soft {tuple(soft.shape)} is not a contiguous (rows, "
                         f"frame_bits) tensor holding {rows}")
    e = 1
    if carry is not None:
        e = carry.shape[0] if carry.dim() == 3 else 1
        if carry.shape[-2:] != (hist, rows.width) or carry.dim() not in (2, 3) \
                or rows.width % TIME_INTERLEAVE_DEPTH or soft.shape[0] % e \
                or carry.dtype != soft.dtype:
            raise ValueError(f"carry {carry.dtype} {tuple(carry.shape)} is not "
                             f"([E,] {hist}, {rows.width}) in {soft.dtype} with "
                             f"E dividing {soft.shape[0]} frames")
    c = soft.shape[0] // e * rows.per_frame
    if index.dim() != 1 or index.shape[0] % 8 or not 0 < n_punct <= rows.width \
            or out.shape[:2] != (index.shape[0] // 8, 8) or out.dim() != 3 \
            or not 0 <= col0 <= out.shape[2] - e * c or out.dtype != soft.dtype:
        raise ValueError(f"out {out.dtype} {tuple(out.shape)} at column {col0} does "
                         f"not take the ({index.shape[0] // 8}, 8, {e * c}) "
                         f"Viterbi input of n_punct {n_punct}")
    return e, c


def deinterleave_depuncture_t_ref(soft: torch.Tensor, rows: SoftRows,
                                  carry: Optional[torch.Tensor], index: torch.Tensor,
                                  n_punct: int, out: torch.Tensor, col0: int = 0):
    """Plain torch twin of the receive step's chain for one subchannel:
    the CIF slices of `rows` in the flat soft (E*F, frame_bits), the carry
    ([E,] 15, width) before them, deinterleave_ref, the body cut to n_punct
    bits and depuncture_t with index = depuncture_index(profile). Writes
    the (T2p, 8, E*c) Viterbi input into out[:, :, col0:], codeword
    e*c + j being ensemble e's logical frame j, and returns the new carry,
    the buffer's last 15 rows. carry None: depth 1 (the FIC), no
    deinterleave, returns None."""
    e, c = _chain_shape(soft, rows, carry, index, n_punct, out, col0)
    sl = rows.view(soft)
    if carry is None:
        logical, new_carry = sl.reshape(-1, rows.width), None
    else:
        buf = torch.cat([carry, sl.reshape(carry.shape[:-2] + (c, rows.width))], dim=-2)
        logical = deinterleave_ref(buf, c).reshape(-1, rows.width)
        new_carry = buf[..., -(TIME_INTERLEAVE_DEPTH - 1):, :].clone()
    out[:, :, col0:col0 + e * c] = depuncture_t(logical[:, :n_punct], index)
    return new_carry


def deinterleave_depuncture_t_cuda(soft: torch.Tensor, rows: SoftRows,
                                   carry: Optional[torch.Tensor], index: torch.Tensor,
                                   n_punct: int, out: torch.Tensor, col0: int = 0):
    """Kernel K4, mode (b), on CUDA tensors: one launch, same contract as
    deinterleave_depuncture_t_ref. 2- or 4-byte elements; index int64;
    the soft bits, the carry and every row start 16-byte aligned."""
    e, c = _chain_shape(soft, rows, carry, index, n_punct, out, col0)
    size = soft.element_size()
    tensors = [soft, index, out] + ([carry] if carry is not None else [])
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors if t is not index) and all(
        v * size % 16 == 0 for v in (rows.base, rows.pitch, rows.width, soft.shape[1]))
    if not all(t.is_cuda and t.is_contiguous() for t in tensors) or size not in (2, 4) \
            or index.dtype != torch.int64 or not aligned \
            or e * -(-c // (128 // size)) > 65535:
        raise ValueError(f"deinterleave_depuncture_t_cuda takes contiguous, 16-byte "
                         f"aligned CUDA tensors with 2- or 4-byte elements and an "
                         f"int64 index, got soft {soft.device} {soft.dtype} "
                         f"{tuple(soft.shape)}, {rows}, index {index.dtype}")
    new_carry = torch.empty_like(carry) if carry is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.launch(_build.load_library().tpudab_deinterleave_depuncture_t, soft.get_device(),
                  "deinterleave_depuncture_t", soft.data_ptr(), ptr(carry), ptr(new_carry),
                  index.data_ptr(), out.data_ptr(), e, soft.shape[0] // e, rows.per_frame,
                  soft.shape[1], rows.base, rows.pitch, rows.width, c, index.shape[0], n_punct,
                  out.shape[2], col0, size)
    deinterleave_depuncture_t_cuda.launches += 1
    return new_carry


deinterleave_depuncture_t_cuda.launches = 0


def deinterleave_depuncture_t(soft: torch.Tensor, rows: SoftRows,
                              carry: Optional[torch.Tensor], index: torch.Tensor,
                              n_punct: int, out: torch.Tensor, col0: int = 0):
    """Dispatch on soft's device: CPU -> the plain twin, CUDA -> K4 mode (b)."""
    if soft.device.type == "cpu":
        return deinterleave_depuncture_t_ref(soft, rows, carry, index, n_punct, out, col0)
    return deinterleave_depuncture_t_cuda(soft, rows, carry, index, n_punct, out, col0)

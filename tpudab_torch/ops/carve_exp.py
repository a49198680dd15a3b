"""Carve + rotate ablations: K5 with frames per block, the window roll and
the PLL rotation each switchable.

Counterpart of tools/exp_carve.py::make_variant (X7), run by
tpudab_torch/tools/exp_carve.py. carve_variant(frames_re, frames_im,
freq_hz, fb, roll, rotate) takes (F, frame_len//128, 128) frames (or flat
(F, frame_len)), bf16 or f32, and returns (F, n_sym * n_fft//128, 128) bf16
re/im, as K5 (tpudab_torch/ops/carve.py) does:

- roll=False reads each window from the 128-aligned row start below it
  (tpudab's r0), which is wrong numerics by design;
- rotate=False casts the window to bf16 without the PLL rotation;
- fb, frames per block, changes the work per block and not the result.

The kernel runs K5's body (csrc/carve.cu::carve_frame, roll and rotate
as template flags) over the tiles of carve_tiling. The plain twin builds
the rotator by angle addition of K5's f32 tables
(ops/carve.py::rotator_tables), each product and sum rounded alone, as the
TPU kernel and K5 do, so the kernel equals it bit for bit. A CPU tensor
takes the twin, a CUDA tensor the kernel.
"""

from __future__ import annotations

import torch

from tpudab_torch.ops import _build
from tpudab_torch.ops.carve import _flat, _freq, _geometry, rotator_tables

K5_CHUNKS = 4   # K5's blocks per frame (csrc/carve.cu kChunks)


def carve_tiling(f: int, fb: int, n_sym: int):
    """(per, (grid_x, grid_y)): the kernel's tiling of f frames of n_sym
    symbols at fb frames per block. Block (x, y) carves frames fb*x ..
    fb*x + fb - 1 and symbols per*y .. per*y + per - 1, each range cut at
    its end. K5's block holds one frame and a quarter of its symbols, so a
    block of fb frames takes 1/fb of that share (rounded up): a block then
    carves about as many windows as K5's, and at 256 mode-I frames the grid
    holds 608-1024 blocks for fb 1-16 (4.6-7.8 an SM on 132 SMs)."""
    if fb < 1:
        raise ValueError(f"frames per block fb={fb} < 1")
    share = -(-n_sym // K5_CHUNKS)     # K5's symbols a block
    per = -(-share // fb)
    return per, (-(-f // fb), -(-n_sym // per))


def _window_starts(mode: int, window_offset: int, roll: bool) -> torch.Tensor:
    p, first, stride = _geometry(mode, window_offset)
    a = first + stride * torch.arange(p.nb_symbols)
    return a if roll else (a // 128) * 128


def carve_variant_ref(frames_re, frames_im, freq_hz, fb: int = 8, roll: bool = True,
                      rotate: bool = True, mode: int = 1, window_offset: int = 12):
    """Plain torch twin of the ablation kernel (fb does not change it)."""
    if fb < 1:
        raise ValueError(f"frames per block fb={fb} < 1")
    p, first, stride = _geometry(mode, window_offset)
    fr = _flat(frames_re, p.nb_frame_length).to(torch.float32)
    fi = _flat(frames_im, p.nb_frame_length).to(torch.float32)
    f, n_fft = fr.shape[0], p.nb_fft
    idx = (_window_starts(mode, window_offset, roll)[:, None]
           + torch.arange(n_fft)[None, :]).to(fr.device)            # (n_sym, n_fft)
    wr, wi = fr[:, idx], fi[:, idx]                                  # (F, n_sym, n_fft)
    if rotate:
        ca, sa, ci, si = rotator_tables(_freq(freq_hz, f, fr.device), mode, window_offset)
        ca, sa, ci, si = ca[:, :, None], sa[:, :, None], ci[:, None, :], si[:, None, :]
        c = ca * ci - sa * si
        sn = sa * ci + ca * si
        wr, wi = wr * c - wi * sn, wr * sn + wi * c
    return (wr.to(torch.bfloat16).reshape(f, -1, 128),
            wi.to(torch.bfloat16).reshape(f, -1, 128))


def carve_variant_cuda(frames_re, frames_im, freq_hz, fb: int = 8, roll: bool = True,
                       rotate: bool = True, mode: int = 1, window_offset: int = 12):
    """The ablation kernel on CUDA tensors; same contract as the twin. The
    frames must be 16-byte aligned. The rotator tables are built only
    when it rotates."""
    p, first, stride = _geometry(mode, window_offset)
    fr = _flat(frames_re, p.nb_frame_length)
    fi = _flat(frames_im, p.nb_frame_length)
    if not (fr.is_cuda and fi.is_cuda) or fr.dtype != fi.dtype \
            or fr.dtype not in (torch.bfloat16, torch.float32) \
            or not (fr.is_contiguous() and fi.is_contiguous()) \
            or fr.data_ptr() % 16 or fi.data_ptr() % 16 or fb < 1:
        raise ValueError(f"carve_variant_cuda takes contiguous, 16-byte aligned CUDA bf16 or "
                         f"f32 frames and fb >= 1, got {fr.device} {fr.dtype}, {fi.device} "
                         f"{fi.dtype}, fb={fb}")
    f = fr.shape[0]
    per, grid = carve_tiling(f, fb, p.nb_symbols)
    tables = rotator_tables(_freq(freq_hz, f, fr.device), mode, window_offset) \
        if rotate else ()
    ptrs = [x.data_ptr() for x in tables] if rotate else [None] * 4
    rows = p.nb_symbols * (p.nb_fft // 128)
    xr = torch.empty((f, rows, 128), dtype=torch.bfloat16, device=fr.device)
    xi = torch.empty_like(xr)
    _build.launch(_build.load_library().tpudab_carve_variant, fr.get_device(), "carve variant",
                  fr.data_ptr(), fi.data_ptr(), int(fr.dtype == torch.bfloat16), *ptrs,
                  xr.data_ptr(), xi.data_ptr(), f, fb, per, *grid, p.nb_frame_length,
                  p.nb_symbols, p.nb_fft, stride, first, int(roll), int(rotate))
    carve_variant_cuda.launches += 1
    return xr, xi


carve_variant_cuda.launches = 0


def carve_variant(frames_re, frames_im, freq_hz, fb: int = 8, roll: bool = True,
                  rotate: bool = True, mode: int = 1, window_offset: int = 12):
    """Dispatch on the frames' device: CPU -> twin, CUDA -> kernel."""
    if frames_re.device.type == "cpu":
        return carve_variant_ref(frames_re, frames_im, freq_hz, fb, roll, rotate, mode,
                                 window_offset)
    return carve_variant_cuda(frames_re, frames_im, freq_hz, fb, roll, rotate, mode,
                              window_offset)

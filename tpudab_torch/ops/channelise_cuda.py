"""The channeliser's kernel (csrc/channelise.cu) on CUDA tensors.

ofdm/channelise.py::Channeliser calls it on the card; channelise_ref there
is its plain version and channelise_tables_ref its arithmetic in torch.
"""

from __future__ import annotations

import torch

from tpudab_torch.ops import _build

TAPS, DECIMATION, BLOCKS = 120, 8, 8     # the kernel's compile-time shape


def _aligned(x: torch.Tensor) -> bool:
    return x.is_cuda and x.data_ptr() % 16 == 0 and (x.stride(0) * x.element_size()) % 16 == 0


def channelise_cuda(tail, streams, frag, phase_step, scale, offsets, out_re, out_im, new_tail,
                    plan) -> None:
    """One launch: tail (S, T, 2) and streams (S, N, 2) int8 -> out_re,
    out_im (E, F, frame_len // 128, 128) bf16 and new_tail (S, T, 2) int8
    (the stream's last T samples). frag, phase_step, scale: the
    Channeliser's buffers; offsets (E,) int32 frame offsets. Each row of
    tail, streams and new_tail contiguous and 16-byte aligned, N a
    multiple of 8 and T = 7 mod 8 (8 frame_len + 119)."""
    s_n, n_tail, _ = tail.shape
    n_new = streams.shape[1]
    if plan.blocks_per_receiver != BLOCKS:
        raise ValueError(f"the channeliser kernel takes {BLOCKS} blocks a receiver")
    for name, t in (("tail", tail), ("streams", streams), ("new_tail", new_tail)):
        if t.dtype != torch.int8 or t.shape[0] != s_n or t.stride(1) != 2 or t.stride(2) != 1 \
                or not _aligned(t):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} is not 16-byte aligned CUDA "
                             f"int8 rows of interleaved I/Q")
    if n_new % 8 or n_tail % 8 != 7 or tuple(new_tail.shape) != tuple(tail.shape):
        raise ValueError(f"{n_new} new samples, tail {tuple(tail.shape)}, "
                         f"new tail {tuple(new_tail.shape)}")
    e_n = out_re.shape[0]
    fs = out_re[0].numel()
    if out_re.dtype != torch.bfloat16 or out_im.dtype != torch.bfloat16 \
            or not (out_re.is_contiguous() and out_im.is_contiguous()) \
            or e_n != s_n * BLOCKS or out_im.shape != out_re.shape \
            or offsets.dtype != torch.int32 or offsets.numel() != e_n:
        raise ValueError("out_re / out_im are contiguous (E, F, ...) bf16 with E = 8 S, "
                         "offsets (E,) int32")
    rows = n_new // DECIMATION + fs // out_re.shape[1]      # (F + 1) frame_len outputs
    _build.launch(_build.load_library().tpudab_channelise, streams.get_device(), "channelise",
                  tail.data_ptr(), tail.stride(0), n_tail, streams.data_ptr(), streams.stride(0),
                  n_new, frag.data_ptr(), phase_step.data_ptr(), scale.data_ptr(),
                  offsets.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), fs,
                  new_tail.data_ptr(), new_tail.stride(0), s_n, rows)
    channelise_cuda.launches += 1


channelise_cuda.launches = 0

"""Viterbi decode of transposed soft bits to packed bytes, kernels K1 + K2.

Counterpart of tpudab.ops.viterbi_pallas.viterbi_decode_bytes_best_t and
viterbi_decode_pallas_bytes_t. A CPU tensor takes the plain torch decoder
viterbi_decode_bytes_t_ref (tpudab_torch/ops/viterbi.py); a CUDA tensor
takes the fused forward + traceback kernel in csrc/viterbi.cu, which
matches the plain decoder bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from tpudab_torch.ops import _build
from tpudab_torch.ops.viterbi import (N_STATES, RADIX, REBASE_STEPS,
                                      viterbi_decode_bytes_t_ref)

__all__ = ["viterbi_decode_bytes_t", "viterbi_decode_bytes_t_cuda",
           "viterbi_decode_bytes_t_ref"]


def viterbi_decode_bytes_t_cuda(soft_t: torch.Tensor, signs: torch.Tensor,
                                n_data_bits: int) -> torch.Tensor:
    """Kernels K1 + K2 on a CUDA tensor: soft_t (T2p, 8, B) bf16 or f32,
    contiguous, T2p % 16 == 0; signs (8, 256) f32 -> (B, n_data_bits // 8)
    uint8."""
    t2p, eight, b = soft_t.shape
    if not soft_t.is_cuda or soft_t.dtype not in (torch.bfloat16, torch.float32) \
            or not soft_t.is_contiguous() or eight != 4 * RADIX \
            or t2p % REBASE_STEPS or n_data_bits % 8 \
            or n_data_bits > RADIX * t2p:
        raise ValueError(f"viterbi_decode_bytes_t_cuda takes contiguous CUDA "
                         f"bf16/f32 (T2p % {REBASE_STEPS} == 0, 8, B), got "
                         f"{soft_t.device} {soft_t.dtype} "
                         f"{tuple(soft_t.shape)}, n_data_bits={n_data_bits}")
    if signs.device != soft_t.device or signs.dtype != torch.float32 \
            or signs.shape != (4 * RADIX, N_STATES << RADIX) \
            or not signs.is_contiguous():
        raise ValueError("signs must be the contiguous (8, 256) f32 radix-2 "
                         "sign table on the soft bits' device")
    dec = torch.empty((b, t2p // 4, N_STATES), dtype=torch.uint8,
                      device=soft_t.device)
    out = torch.empty((b, n_data_bits // 8), dtype=torch.uint8,
                      device=soft_t.device)
    lib = _build.load_library()
    with torch.cuda.device(soft_t.device):
        err = lib.tpudab_viterbi_decode_bytes_t(
            ctypes.c_void_p(soft_t.data_ptr()),
            int(soft_t.dtype == torch.bfloat16),
            ctypes.c_void_p(signs.data_ptr()), ctypes.c_void_p(dec.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), t2p, b, n_data_bits // 8,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "viterbi")
    viterbi_decode_bytes_t_cuda.launches += 1
    return out


viterbi_decode_bytes_t_cuda.launches = 0


def viterbi_decode_bytes_t(soft_t: torch.Tensor, signs: torch.Tensor,
                           n_data_bits: int) -> torch.Tensor:
    """(T2p, 8, B) soft -> (B, n_data_bits // 8) packed bytes; dispatches on
    the soft bits' device."""
    if soft_t.device.type == "cpu":
        return viterbi_decode_bytes_t_ref(soft_t, signs, n_data_bits)
    return viterbi_decode_bytes_t_cuda(soft_t, signs, n_data_bits)

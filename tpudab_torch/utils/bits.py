"""Bit packing helpers, numpy on the host and torch on tensors.

Counterpart of tpudab.utils.bits. Convention: MSB-first within bytes;
soft bits are positive for bit 0 and negative for bit 1 (a = 1 - 2b).
"""

from __future__ import annotations

import numpy as np
import torch


def unpack_bits(data: np.ndarray) -> np.ndarray:
    """uint8 bytes -> 0/1 bits (MSB first); the last axis grows x8."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """0/1 bits (MSB first, last axis a multiple of 8) -> uint8 bytes."""
    return np.packbits(np.asarray(bits).astype(np.uint8), axis=-1)


_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def torch_pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first pack of 0/1 integer bits into uint8 (last axis % 8 == 0)."""
    b = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8)).to(torch.int32)
    w = torch.tensor(_SHIFTS, dtype=torch.int32, device=bits.device)
    return (b << w).sum(dim=-1).to(torch.uint8)


def torch_unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """MSB-first unpack of uint8 into 0/1 uint8 bits."""
    w = torch.tensor(_SHIFTS, dtype=torch.int32, device=data.device)
    bits = (data.to(torch.int32)[..., None] >> w) & 1
    return bits.reshape(data.shape[:-1] + (data.shape[-1] * 8,)).to(torch.uint8)


def hard_decision(soft) -> np.ndarray:
    """Soft float bits -> 0/1 hard bits (sign < 0 => 1)."""
    return (np.asarray(soft) < 0).astype(np.uint8)


def bits_to_soft(bits, amplitude: float = 1.0) -> np.ndarray:
    """0/1 bits -> ideal soft values (+A for 0, -A for 1)."""
    return (amplitude * (1.0 - 2.0 * np.asarray(bits, dtype=np.float32))).astype(np.float32)

"""Energy-dispersal scrambler PRBS: x^9 + x^5 + 1, EN 300 401 sec 10.

Counterpart of tpudab.fec.prbs (numpy), with the PRBS bytes as a tensor
for descrambling on the device. The register starts all ones for
every FIB group and every MSC logical frame; scrambling == descrambling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def prbs_bits(n: int) -> np.ndarray:
    """First n PRBS output bits (register init all-ones)."""
    reg = np.ones(9, dtype=np.uint8)  # reg[0] input end, reg[8] output end
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        bit = reg[8] ^ reg[4]
        out[i] = bit
        reg[1:] = reg[:-1]
        reg[0] = bit
    return out


@functools.lru_cache(maxsize=None)
def prbs_bytes(n: int) -> np.ndarray:
    """First n PRBS bytes (MSB-first packing of prbs_bits)."""
    return np.packbits(prbs_bits(8 * n))


def descramble_bits(bits: np.ndarray) -> np.ndarray:
    """XOR a 0/1 bit array (last axis = stream) with the PRBS."""
    bits = np.asarray(bits, dtype=np.uint8)
    return bits ^ prbs_bits(bits.shape[-1])


def descramble_bytes(data: np.ndarray) -> np.ndarray:
    """XOR uint8 bytes (last axis = stream) with the PRBS bytes."""
    data = np.asarray(data, dtype=np.uint8)
    return data ^ prbs_bytes(data.shape[-1])


@functools.lru_cache(maxsize=None)
def prbs_bytes_on(n: int, device: torch.device) -> torch.Tensor:
    """prbs_bytes(n) as a uint8 tensor on device, made once per device."""
    return torch.from_numpy(prbs_bytes(n).copy()).to(device)

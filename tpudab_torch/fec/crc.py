"""CRC-16/CCITT for FIBs (EN 300 401 sec 5.2.1), numpy on the host.

Counterpart of tpudab.fec.crc's check_fib_crc and crc16_append.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _crc16_table(poly: int) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & 0x8000) else (crc << 1)
            crc &= 0xFFFF
        table[byte] = crc
    return table


def crc16_ccitt(data: np.ndarray) -> np.ndarray:
    """CRC-16 poly 0x1021, init 0xFFFF, complemented, over the last axis of
    a uint8 array; one uint16 per message."""
    data = np.asarray(data, dtype=np.uint8)
    squeeze = data.ndim == 1
    data = data.reshape(-1, data.shape[-1])
    table = _crc16_table(0x1021)
    crc = np.full(data.shape[0], 0xFFFF, dtype=np.uint16)
    for i in range(data.shape[-1]):
        crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ data[:, i]) & 0xFF]
    crc = ~crc & 0xFFFF
    return crc[0] if squeeze else crc


def check_fib_crc(fibs: np.ndarray) -> np.ndarray:
    """fibs (..., 32) uint8 -> bool (...), True where the CRC matches.
    A FIB is 30 data bytes and a 2-byte big-endian CRC."""
    fibs = np.asarray(fibs, dtype=np.uint8)
    flat = fibs.reshape(-1, fibs.shape[-1])
    calc = crc16_ccitt(flat[:, :-2])
    sent = (flat[:, -2].astype(np.uint16) << 8) | flat[:, -1]
    return (calc == sent).reshape(fibs.shape[:-1])


def crc16_append(data: np.ndarray) -> np.ndarray:
    """Append the 2-byte complemented CRC (synthesizer side)."""
    data = np.asarray(data, dtype=np.uint8)
    crc = int(crc16_ccitt(data))
    return np.concatenate([data, np.array([crc >> 8, crc & 0xFF], dtype=np.uint8)])

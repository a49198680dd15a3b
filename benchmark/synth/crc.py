"""CRC engines, numpy on the host: CRC-16/CCITT (FIBs, MOT, packets,
dynamic labels, DAB+ AUs; EN 300 401 sec 5.2.1) and the DAB+ Fire code
(TS 102 563 sec 5.2).

Counterpart of tpudab.fec.crc.
"""

from __future__ import annotations

import binascii
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


def _crc16(data: np.ndarray, poly: int, init: int) -> np.ndarray:
    """CRC-16 (not complemented) over the last axis of a uint8 array; one
    uint16 per message, a scalar for a 1-D message."""
    data = np.asarray(data, dtype=np.uint8)
    squeeze = data.ndim == 1
    if squeeze:
        data = data[None]
    table = _crc16_table(poly)
    crc = np.full(data.shape[0], init, dtype=np.uint16)
    for i in range(data.shape[-1]):
        crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ data[:, i]) & 0xFF]
    return crc[0] if squeeze else crc


def crc16_ccitt(data: np.ndarray) -> np.ndarray:
    """CRC-16 poly 0x1021, init 0xFFFF, complemented (the transmitted CRC of
    FIBs, MOT, packets and dynamic labels). A 1-D message goes through
    binascii.crc_hqx (the same CRC, MSB first, no final XOR) in C."""
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        return np.uint16(~binascii.crc_hqx(data.tobytes(), 0xFFFF) & 0xFFFF)
    return (~_crc16(data, 0x1021, 0xFFFF)) & 0xFFFF


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


# DAB+ Fire code: CRC-16 with poly x^16+x^14+x^13+x^12+x^11+x^5+x^3+x^2+x+1
# (0x782F), init 0, over bytes 2..10 of the audio superframe; sent, not
# complemented, in bytes 0..1.
FIRECODE_POLY = 0x782F


def firecode_compute(data: np.ndarray) -> np.ndarray:
    return _crc16(data, FIRECODE_POLY, 0x0000)


def firecode_check(superframe_head: np.ndarray) -> np.ndarray:
    """superframe_head (..., >= 11) uint8 -> bool (...), True where the Fire
    code matches."""
    head = np.asarray(superframe_head, dtype=np.uint8)
    flat = head.reshape(-1, head.shape[-1])
    calc = firecode_compute(flat[:, 2:11])
    sent = (flat[:, 0].astype(np.uint16) << 8) | flat[:, 1]
    return (calc == sent).reshape(head.shape[:-1])

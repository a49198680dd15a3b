"""The transmitter's coding, numpy: the K=7 rate-1/4 mother code, the
puncturing, the energy-dispersal PRBS, the time interleave and the bit
unpacking (a frozen copy of tpudab_torch.fec.conv's encoder,
fec.depuncture's puncture, fec.prbs, msc.interleave's delays and
utils.bits' unpack_bits; EN 300 401 sec 10, 11 and 12)."""

from __future__ import annotations

import functools

import numpy as np

from benchmark.synth.puncture import TAIL_BITS, PunctureProfile

TIME_INTERLEAVE_DEPTH = 16

# Tap masks with bit k = tap on u_{t-k} (time-reversed octal polys 133, 171,
# 145, 133).
TAP_MASKS = np.array([0b1101101, 0b1001111, 0b1010011, 0b1101101], dtype=np.int64)


def _parity(x: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x)
    x = x.copy()
    while np.any(x):
        p ^= x & 1
        x >>= 1
    return p


# OUTPUT_BITS[reg7, j] = output bit of generator j for transition reg7.
OUTPUT_BITS = _parity(np.arange(128, dtype=np.int64)[:, None]
                      & TAP_MASKS[None, :]).astype(np.uint8)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Data bits -> mother code output of length 4*(len+6), with TAIL_BITS
    zero flush bits appended; serialized per input bit (g1 g2 g3 g4 ...)."""
    bits = np.asarray(bits, dtype=np.uint8).ravel()
    padded = np.concatenate([bits, np.zeros(TAIL_BITS, dtype=np.uint8)])
    n = padded.shape[0]
    reg7 = np.zeros(n, dtype=np.int64)
    for k in range(7):
        shifted = np.zeros(n, dtype=np.int64)
        shifted[k:] = padded[: n - k]
        reg7 |= shifted << k
    return OUTPUT_BITS[reg7].reshape(-1)


@functools.lru_cache(maxsize=None)
def _keep_indices(profile: PunctureProfile) -> np.ndarray:
    return np.nonzero(profile.mask())[0].astype(np.int64)


def puncture(mother_bits: np.ndarray, profile: PunctureProfile) -> np.ndarray:
    """Keep only the unpunctured mother bits."""
    return np.asarray(mother_bits)[..., _keep_indices(profile)]


@functools.lru_cache(maxsize=None)
def prbs_bits(n: int) -> np.ndarray:
    """First n PRBS output bits (x^9 + x^5 + 1, register init all-ones)."""
    reg = np.ones(9, dtype=np.uint8)  # reg[0] input end, reg[8] output end
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        bit = reg[8] ^ reg[4]
        out[i] = bit
        reg[1:] = reg[:-1]
        reg[0] = bit
    return out


def descramble_bits(bits: np.ndarray) -> np.ndarray:
    """XOR a 0/1 bit array (last axis = stream) with the PRBS."""
    bits = np.asarray(bits, dtype=np.uint8)
    return bits ^ prbs_bits(bits.shape[-1])


# d(i mod 16): bit-reversed 0..15 sequence
_DELAYS = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15],
                   dtype=np.int32)


@functools.lru_cache(maxsize=None)
def interleave_delays(n_bits: int) -> np.ndarray:
    """Per-bit delay vector d(i mod 16) of length n_bits."""
    reps = -(-n_bits // 16)
    return np.tile(_DELAYS, reps)[:n_bits].copy()


def unpack_bits(data: np.ndarray) -> np.ndarray:
    """uint8 bytes -> 0/1 bits (MSB first); the last axis grows x8."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1)

"""K=7 rate-1/4 mother convolutional code: encoder and static trellis tables.

Counterpart of tpudab.fec.conv (numpy, no jax). EN 300 401 sec 11.1:
generators G1 = 1+x^2+x^3+x^5+x^6 (0o133), G2 = 1+x+x^2+x^3+x^6 (0o171),
G3 = 1+x+x^4+x^6 (0o145), G4 = G1.

Conventions: encoder register bit k holds input bit u_{t-k}; state s bit j
is u_{t-1-j}; transition id reg7 = (s << 1) | u_t, new state reg7 & 63.
"""

from __future__ import annotations

import numpy as np

from tpudab_torch.constants.puncture import TAIL_BITS

# Tap masks with bit k = tap on u_{t-k} (time-reversed octal polys).
TAP_MASKS = np.array([0b1101101, 0b1001111, 0b1010011, 0b1101101], dtype=np.int64)
N_STATES = 64
N_TRANSITIONS = 128


def _parity(x: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x)
    x = x.copy()
    while np.any(x):
        p ^= x & 1
        x >>= 1
    return p


_reg7 = np.arange(N_TRANSITIONS, dtype=np.int64)
# OUTPUT_BITS[reg7, j] = output bit of generator j for transition reg7.
OUTPUT_BITS = _parity(_reg7[:, None] & TAP_MASKS[None, :]).astype(np.uint8)
# OUTPUT_SIGNS[reg7, j] = 1 - 2*bit, for correlation branch metrics.
OUTPUT_SIGNS = (1.0 - 2.0 * OUTPUT_BITS).astype(np.float32)

# Predecessor index tables for the ACS butterfly.
_sprime = np.arange(N_STATES, dtype=np.int64)
PRED0 = _sprime >> 1            # transition id = s'
PRED1 = (_sprime >> 1) | 32     # transition id = s' | 64


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

"""Reed-Solomon RS(120,110) t=5 for DAB+ superframes (TS 102 563 sec 6).

Shortened from RS(255,245) over GF(2^8), field polynomial
x^8+x^4+x^3+x^2+1 (0x11D), generator roots alpha^0..alpha^9 (fcr=0, prim=1)
— the same code family as DVB RS(204,188).

The encoder alone: a frozen copy of tpudab_torch.fec.rs's field tables and
rs_encode.
"""

from __future__ import annotations

import numpy as np

PRIM_POLY = 0x11D
N_FULL, K_FULL = 255, 245
N, K = 120, 110
T = 5
N_SYND = 2 * T

# --- GF(256) tables ---
_EXP = np.zeros(512, dtype=np.int64)
_LOG = np.zeros(256, dtype=np.int64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= PRIM_POLY
_EXP[255:510] = _EXP[0:255]
_LOG[0] = -1  # sentinel; callers must mask zeros


def gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    nz = (a != 0) & (b != 0)
    la = _LOG[np.where(a != 0, a, 1)]
    lb = _LOG[np.where(b != 0, b, 1)]
    return np.where(nz, _EXP[la + lb], 0)


def gf_inv(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.int64)
    return np.where(a != 0, _EXP[255 - _LOG[np.where(a != 0, a, 1)]], 0)


def gf_pow_alpha(e: np.ndarray) -> np.ndarray:
    """alpha**e for integer exponents (any sign)."""
    return _EXP[np.mod(e, 255)]


# generator polynomial g(x) = prod_{i=0..9} (x - alpha^i), g[0] = x^10 coeff = 1
_g = np.array([1], dtype=np.int64)
for _i in range(N_SYND):
    _nxt = np.zeros(_g.shape[0] + 1, dtype=np.int64)
    _nxt[:-1] ^= gf_mul(_g, 1)          # x * g
    _nxt[1:] ^= gf_mul(_g, _EXP[_i])    # alpha^i * g
    _g = _nxt
GENERATOR = _g  # length 11, descending powers


def rs_encode(msg: np.ndarray) -> np.ndarray:
    """Systematic encode: (..., 110) data -> (..., 120) codeword."""
    msg = np.asarray(msg, dtype=np.int64)
    batch_shape = msg.shape[:-1]
    m = msg.reshape(-1, K)
    rem = np.zeros((m.shape[0], N_SYND), dtype=np.int64)
    for j in range(K):
        factor = rem[:, 0] ^ m[:, j]
        rem = np.concatenate([rem[:, 1:], np.zeros((m.shape[0], 1), dtype=np.int64)], axis=1)
        rem ^= gf_mul(factor[:, None], GENERATOR[None, 1:])
    out = np.concatenate([m, rem], axis=1)
    return out.reshape(batch_shape + (N,)).astype(np.uint8)

"""Reed-Solomon RS(120,110) t=5 for DAB+ superframes (TS 102 563 sec 6).

Shortened from RS(255,245) over GF(2^8), field polynomial
x^8+x^4+x^3+x^2+1 (0x11D), generator roots alpha^0..alpha^9 (fcr=0, prim=1)
— the same code family as DVB RS(204,188).

Implementation: batch-vectorized NumPy (syndromes via Horner, Berlekamp-Massey
with boolean-mask control flow fixed at 2t iterations, Chien search over all
120 positions, Forney). All loops have static trip counts, so this ports
directly to a jitted JAX version if RS ever becomes hot; at DAB rates it is
~1 codeword per 24 ms per 8 kbps of audio and stays host-side.

Counterpart of tpudab.fec.rs, rewritten here because the tpudab.fec
package imports jax.
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


def _syndromes(cw: np.ndarray) -> np.ndarray:
    """S_i = r(alpha^i), i = 0..2t-1. cw: (B, 120) -> (B, 10)."""
    b = cw.shape[0]
    s = np.zeros((b, N_SYND), dtype=np.int64)
    alphas = _EXP[np.arange(N_SYND)]
    for j in range(N):
        s = gf_mul(s, alphas[None, :]) ^ cw[:, j : j + 1]
    return s


def rs_decode(codewords: np.ndarray):
    """Decode (..., 120) -> (corrected (..., 120), n_errors (...,), failed (...,)).

    failed=True marks codewords with >t errors (left uncorrected).
    """
    cw_in = np.asarray(codewords, dtype=np.int64)
    batch_shape = cw_in.shape[:-1]
    cw = cw_in.reshape(-1, N).copy()
    bsz = cw.shape[0]

    synd = _syndromes(cw)
    no_err = ~np.any(synd != 0, axis=1)

    # Berlekamp-Massey, vectorized with masks, fixed 2t iterations.
    deg = N_SYND + 2
    C = np.zeros((bsz, deg), dtype=np.int64)
    Bx = np.zeros((bsz, deg), dtype=np.int64)
    C[:, 0] = 1
    Bx[:, 1] = 1  # x * B with B = 1
    L = np.zeros(bsz, dtype=np.int64)
    bscal = np.ones(bsz, dtype=np.int64)

    def shift1(p):
        out = np.zeros_like(p)
        out[:, 1:] = p[:, :-1]
        return out

    for r in range(N_SYND):
        # delta = sum_i C[i] * S[r-i]
        i_max = min(r, deg - 1)
        idx = np.arange(i_max + 1)
        delta = np.zeros(bsz, dtype=np.int64)
        for i in idx:
            delta ^= gf_mul(C[:, i], synd[:, r - i])
        coef = gf_mul(delta, gf_inv(bscal))
        C_new = C ^ gf_mul(coef[:, None], Bx)
        upd = (delta != 0) & (2 * L <= r)
        keep = delta == 0
        # case upd: C=C_new, L=r+1-L, b=delta, Bx=shift(old C)
        # case delta!=0, no upd: C=C_new, Bx=shift(Bx)
        # case delta==0: C unchanged, Bx=shift(Bx)
        Bx_next = np.where(upd[:, None], shift1(C), shift1(Bx))
        C = np.where(keep[:, None], C, C_new)
        L = np.where(upd, r + 1 - L, L)
        bscal = np.where(upd, delta, bscal)
        Bx = Bx_next

    # Chien search over the 120 valid positions. Error at byte index j
    # corresponds to power k = N-1-j; root test: Lambda(alpha^-k) == 0.
    ks = np.arange(N)[::-1].copy()  # power k for byte j: k = 119 - j -> ks[j]
    ks = (N - 1) - np.arange(N)
    eval_pts = gf_pow_alpha(-ks)  # alpha^{-k} per byte position, (120,)
    lam_eval = np.zeros((bsz, N), dtype=np.int64)
    x_pow = np.ones((1, N), dtype=np.int64)
    for i in range(deg):
        lam_eval ^= gf_mul(C[:, i : i + 1], x_pow)
        x_pow = gf_mul(x_pow, eval_pts[None, :])
    root_mask = lam_eval == 0  # (B, 120)

    n_roots = root_mask.sum(axis=1)

    # Forney: Omega = (S * Lambda) mod x^2t ; e_j = X_j * Omega(X_j^-1) / Lambda'(X_j^-1)
    omega = np.zeros((bsz, N_SYND), dtype=np.int64)
    for i in range(N_SYND):
        acc = np.zeros(bsz, dtype=np.int64)
        for m in range(i + 1):
            if m < deg:
                acc ^= gf_mul(C[:, m], synd[:, i - m])
        omega[:, i] = acc
    # evaluate Omega and Lambda' at alpha^{-k} for every position
    om_eval = np.zeros((bsz, N), dtype=np.int64)
    x_pow = np.ones((1, N), dtype=np.int64)
    for i in range(N_SYND):
        om_eval ^= gf_mul(omega[:, i : i + 1], x_pow)
        x_pow = gf_mul(x_pow, eval_pts[None, :])
    lamd_eval = np.zeros((bsz, N), dtype=np.int64)
    x_pow = np.ones((1, N), dtype=np.int64)
    for i in range(1, deg, 2):  # formal derivative keeps odd-power coeffs
        lamd_eval ^= gf_mul(C[:, i : i + 1], x_pow)
        if i + 2 < deg + 2:
            x_pow = gf_mul(gf_mul(x_pow, eval_pts[None, :]), eval_pts[None, :])
    X = gf_pow_alpha(ks)[None, :]  # alpha^{k}
    err_mag = gf_mul(X, gf_mul(om_eval, gf_inv(lamd_eval)))
    err = np.where(root_mask & (lamd_eval != 0), err_mag, 0)

    corrected = cw ^ err
    # validate: re-syndrome must be zero and root count must equal L
    resynd = _syndromes(corrected)
    ok = ~np.any(resynd != 0, axis=1)
    failed = ~no_err & (~ok | (n_roots != L) | (L > T))
    corrected = np.where(failed[:, None], cw, corrected)
    n_err = np.where(no_err, 0, np.where(failed, -1, n_roots))

    return (
        corrected.reshape(batch_shape + (N,)).astype(np.uint8),
        n_err.reshape(batch_shape),
        failed.reshape(batch_shape),
    )

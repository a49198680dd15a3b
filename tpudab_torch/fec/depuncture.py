"""Puncturing (synthesizer, numpy) and depuncturing (torch and numpy).

Counterpart of tpudab.fec.depuncture's puncture, depuncture, depuncture_t
and depuncture_np. tpudab depunctures with a one-hot matmul per puncture
run; every output position takes at most one input value, so here it is
an index gather, exact in any dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudab_torch.constants.puncture import PunctureProfile

BLOCK = 128  # mother bits per puncture block = 16 radix-2 super-steps


@functools.lru_cache(maxsize=None)
def _keep_indices(profile: PunctureProfile) -> np.ndarray:
    return np.nonzero(profile.mask())[0].astype(np.int64)


def puncture(mother_bits: np.ndarray, profile: PunctureProfile) -> np.ndarray:
    """Keep only the unpunctured mother bits (synthesizer side)."""
    return np.asarray(mother_bits)[..., _keep_indices(profile)]


@functools.lru_cache(maxsize=None)
def depuncture_index(profile: PunctureProfile) -> np.ndarray:
    """Gather map over the 128-padded mother positions (T2p * 8,), int64:
    index k < n_punct takes punctured input k, n_punct is an erasure (0.0)
    and n_punct + 1 the +1.0 virtual-flush value of the tail pad past the
    real mother bits (tpudab/fec/depuncture.py:137-143)."""
    mask = profile.mask()
    n_mother = mask.shape[0]
    n_punct = int(mask.sum())
    n_pad = -(-n_mother // BLOCK) * BLOCK
    idx = np.full(n_pad, n_punct + 1, dtype=np.int64)
    idx[:n_mother] = n_punct
    idx[_keep_indices(profile)] = np.arange(n_punct)
    return idx


@functools.lru_cache(maxsize=None)
def _mother_index(profile: PunctureProfile) -> np.ndarray:
    """Gather map over the mother positions (4 * (I + 6),), int64: index
    k < n_punct takes punctured input k, n_punct is an erasure (0.0)."""
    mask = profile.mask()
    n_punct = int(mask.sum())
    idx = np.full(mask.shape[0], n_punct, dtype=np.int64)
    idx[_keep_indices(profile)] = np.arange(n_punct)
    return idx


@functools.lru_cache(maxsize=None)
def _mother_index_on(profile: PunctureProfile, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mother_index(profile)).to(device)


def depuncture(soft_bits: torch.Tensor, profile: PunctureProfile) -> torch.Tensor:
    """Punctured soft (..., n_punct) -> mother (..., 4 * (I + 6)) in the same
    dtype and on the same device, 0.0 at the punctured positions."""
    ext = torch.cat([soft_bits, soft_bits.new_zeros(soft_bits.shape[:-1] + (1,))], dim=-1)
    return ext.index_select(-1, _mother_index_on(profile, soft_bits.device))


def depuncture_np(soft_bits: np.ndarray, profile: PunctureProfile) -> np.ndarray:
    """Numpy depuncture to f32, as tpudab.fec.depuncture.depuncture_np."""
    idx = _keep_indices(profile)
    n_mother = profile.mask().shape[0]
    out = np.zeros(soft_bits.shape[:-1] + (n_mother,), dtype=np.float32)
    out[..., idx] = soft_bits
    return out


def depuncture_t(soft_bits: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Punctured soft (B, n_punct) -> mother-transposed (T2p, 8, B) in the
    same dtype, the Viterbi input layout. index is depuncture_index(profile)
    as a tensor on soft_bits' device."""
    b = soft_bits.shape[0]
    ext = torch.cat([soft_bits, soft_bits.new_zeros(b, 1),
                     soft_bits.new_ones(b, 1)], dim=1)
    return ext.t().index_select(0, index).view(-1, 8, b)

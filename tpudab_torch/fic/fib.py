"""FIC frame decode: punctured soft bits -> CRC-checked FIB bytes.

Counterpart of tpudab.fic.fib. Per transmission frame (EN 300 401 sec
11.2): soft bits (nb_fic_bits,) -> groups (G, 2304|3072) -> depuncture ->
one batched Viterbi call over all groups of all frames (kernels K1 + K3 on
a CUDA tensor) -> energy-dispersal descramble and pack, on the soft bits'
device -> FIBs + CRC-16 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudab_torch.constants.dab_params import FIB_BYTES, get_dab_params
from tpudab_torch.constants.puncture import FIC_PROFILE, FIC_PROFILE_MODE3
from tpudab_torch.fec.crc import check_fib_crc
from tpudab_torch.fec.depuncture import depuncture
from tpudab_torch.fec.prbs import prbs_bytes_on
from tpudab_torch.ops.viterbi_cuda import viterbi_decode_best
from tpudab_torch.utils.bits import torch_pack_bits
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device


def fic_profile(mode: int):
    return FIC_PROFILE_MODE3 if mode == 3 else FIC_PROFILE


def fic_soft_to_fib_bytes(fic_soft, mode: int = 1, device=None) -> np.ndarray:
    """(F, nb_fic_bits) or (nb_fic_bits,) soft bits -> (F*G, group_bytes)
    uint8. fic_soft is a tensor or a numpy array; it is decoded on device,
    or, when device is None, where a tensor lies and on the card for a
    numpy array."""
    dab = get_dab_params(mode)
    profile = fic_profile(mode)
    if device is None:
        device = fic_soft.device if torch.is_tensor(fic_soft) else DEFAULT_DEVICE
    soft = torch.as_tensor(fic_soft, device=resolve_device(device))
    if soft.ndim == 1:
        soft = soft[None]
    f = soft.shape[0]
    n_bits = profile.data_bits
    groups = soft.reshape(f * dab.nb_fib_groups, dab.nb_fic_bits_per_group)
    mother = depuncture(groups, profile).reshape(groups.shape[0], n_bits + 6, 4)
    bits = viterbi_decode_best(mother, n_bits)                 # (F*G, n_bits)
    by = torch_pack_bits(bits) ^ prbs_bytes_on(n_bits // 8, bits.device)
    return by.cpu().numpy()


def decode_fic_frame(fic_soft, mode: int = 1, device=None):
    """Decode one or more frames of FIC soft bits.

    Returns (fibs, crc_ok): fibs (n_total_fibs, 32) uint8, crc_ok bool mask.
    """
    fibs = fic_soft_to_fib_bytes(fic_soft, mode, device).reshape(-1, FIB_BYTES)
    return fibs, check_fib_crc(fibs)

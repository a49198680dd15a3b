"""DAB logical frame geometry: FIC/MSC split, CIFs, FIBs per transmission frame.

Reference parity: vendor/DAB-Radio `dab/constants/dab_parameters.h` /
`get_dab_parameters(mode)` (proven API at the reference's src/radio_block.cpp:2,13).
Values derive from ETSI EN 300 401 (frame structure, sec. 5).
"""

from __future__ import annotations

import dataclasses

from benchmark.synth.ofdm_params import get_ofdm_params

CIF_BITS = 55_296          # bits per Common Interleaved Frame (864 CU x 64 bits)
CU_BITS = 64               # bits per capacity unit
CIF_CU = 864               # capacity units per CIF
FIB_BITS = 256             # bits per Fast Information Block (30 bytes + CRC16)
FIB_BYTES = 32
FIB_CRC_BYTES = 2


@dataclasses.dataclass(frozen=True)
class DABParams:
    mode: int
    nb_frame_bits: int          # soft bits per transmission frame
    nb_fibs: int                # FIBs per transmission frame
    nb_fibs_per_group: int      # FIBs jointly convolutionally coded (FIB group)
    nb_cifs: int                # CIFs per transmission frame
    nb_fic_bits: int            # punctured FIC bits per transmission frame
    nb_fic_bits_per_group: int  # punctured bits per FIB group

    @property
    def nb_fib_groups(self) -> int:
        return self.nb_fibs // self.nb_fibs_per_group

    @property
    def nb_msc_bits(self) -> int:
        return self.nb_frame_bits - self.nb_fic_bits

    def __post_init__(self):
        assert self.nb_msc_bits == self.nb_cifs * CIF_BITS, (
            f"mode {self.mode}: MSC bits {self.nb_msc_bits} != "
            f"{self.nb_cifs} CIFs x {CIF_BITS}"
        )


def _make(mode: int, nb_fibs: int, fibs_per_group: int, nb_cifs: int,
          fic_bits_per_group: int) -> DABParams:
    ofdm = get_ofdm_params(mode)
    groups = nb_fibs // fibs_per_group
    return DABParams(
        mode=mode,
        nb_frame_bits=ofdm.nb_frame_bits,
        nb_fibs=nb_fibs,
        nb_fibs_per_group=fibs_per_group,
        nb_cifs=nb_cifs,
        nb_fic_bits=groups * fic_bits_per_group,
        nb_fic_bits_per_group=fic_bits_per_group,
    )


_PARAMS = {
    # EN 300 401 sec 5.2: FIBs/CIFs per frame and FIC coding geometry.
    # Modes I/II/IV group 3 FIBs (768 bits -> 2304 punctured bits);
    # mode III groups 4 FIBs (1024 bits -> 3072 punctured bits).
    1: _make(1, nb_fibs=12, fibs_per_group=3, nb_cifs=4, fic_bits_per_group=2304),
    2: _make(2, nb_fibs=3, fibs_per_group=3, nb_cifs=1, fic_bits_per_group=2304),
    3: _make(3, nb_fibs=4, fibs_per_group=4, nb_cifs=1, fic_bits_per_group=3072),
    4: _make(4, nb_fibs=6, fibs_per_group=3, nb_cifs=2, fic_bits_per_group=2304),
}


def get_dab_params(mode: int) -> DABParams:
    if mode not in _PARAMS:
        raise ValueError(f"unknown DAB transmission mode {mode!r} (valid: 1..4)")
    return _PARAMS[mode]

"""FEC layer: convolutional code, puncturing, scrambling, CRC (counterpart of tpudab.fec)."""

from tpudab_torch.fec.conv import conv_encode, OUTPUT_SIGNS, PRED0, PRED1
from tpudab_torch.fec.depuncture import depuncture, puncture
from tpudab_torch.fec.prbs import prbs_bits, descramble_bits, descramble_bytes
from tpudab_torch.fec.crc import crc16_ccitt, check_fib_crc, firecode_check

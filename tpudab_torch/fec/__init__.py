"""FEC layer: convolutional code, puncturing, scrambling, CRC (counterpart of tpudab.fec)."""

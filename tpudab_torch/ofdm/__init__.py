"""OFDM demod (counterpart of tpudab.ofdm.demod)."""

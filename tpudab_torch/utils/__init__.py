"""Bit packing helpers (counterpart of tpudab.utils.bits)."""

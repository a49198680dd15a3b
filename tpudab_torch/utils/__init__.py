"""Bit packing (counterpart of tpudab.utils.bits) and device helpers."""

"""MSC path: CIF slicing and time deinterleave (counterpart of tpudab.msc)."""

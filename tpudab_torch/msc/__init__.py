"""MSC path: CIF slicing and time deinterleave (counterpart of tpudab.msc)."""

from tpudab_torch.msc.interleave import TIME_INTERLEAVE_DEPTH, interleave_delays

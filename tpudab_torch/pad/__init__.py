"""Programme-associated data: X-PAD, dynamic labels (counterpart of tpudab.pad)."""

from tpudab_torch.pad.xpad import (XPADProcessor, extract_pad_from_dabplus_au,
                                   extract_pad_from_mp2_frame, build_xpad_into_au,
                                   DynamicLabelDecoder)

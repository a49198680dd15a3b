"""FIC decode (counterpart of tpudab.fic): FIB bytes and the FIG parser."""

from tpudab_torch.fic.fib import decode_fic_frame, fic_soft_to_fib_bytes
from tpudab_torch.fic.fig_parser import parse_fib, FIGEvent

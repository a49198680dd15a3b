"""FIC decode (counterpart of tpudab.fic): FIB bytes and the FIG parser."""

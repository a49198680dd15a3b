"""DAB+ superframes and MP2 frames (counterpart of tpudab.audio, without the codecs)."""

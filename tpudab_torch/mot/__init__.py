"""MOT objects and the slideshow (counterpart of tpudab.mot)."""

"""Numerology and reference tables for DAB transmission modes I-IV.

Everything in this package is pure NumPy (no device dependency) so tables can
be precomputed at trace time and baked into jitted programs as constants.

The port's own copy of tpudab/constants (ofdm_params, dab_params,
interleaver, prs, puncture, tables, provenance), carried over verbatim so
that tpudab_torch imports nothing of tpudab (the module docstrings name
the reference's sources from its project root);
tests/test_torch_constants.py holds every table and function equal to the
original.
"""

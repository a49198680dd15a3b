"""Command-line entry points (counterpart of tpudab.host)."""

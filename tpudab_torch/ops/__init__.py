"""Device kernels and their plain torch twins (counterpart of tpudab.ops)."""

"""Programme-associated data: X-PAD, dynamic labels (counterpart of tpudab.pad)."""

"""The receive step and carry conversion (counterpart of tpudab.models)."""

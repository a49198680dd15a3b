"""The service database fed by FIG events (counterpart of tpudab.database)."""

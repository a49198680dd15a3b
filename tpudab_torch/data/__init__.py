"""MSC packet-mode data channels (counterpart of tpudab.data)."""

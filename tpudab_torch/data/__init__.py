"""MSC packet-mode data channels (counterpart of tpudab.data)."""

from tpudab_torch.data.packet import (PacketChannel, parse_packet, build_packets,
                                      PACKET_SIZES)

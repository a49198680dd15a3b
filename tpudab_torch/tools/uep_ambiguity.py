"""UEP table ambiguity report (the port of tools/uep_ambiguity.py): for
each budget-solved row ('s') of the UEP table, how many protection
profiles the hard constraints leave, the enumeration being
tpudab_torch.fec.uep_calibrate.candidate_profiles (the set the online
self-calibration scores against the received signal):

  sum(Li * 4 * (8 + PIi)) + 12 + padding == size_cu * 64
  sum(Li) == bitrate * 3/4 (mother blocks)
  PI ranges per protection level (+/- slack), the L1 bitrate family, L4
  and the padding as the 54 externally corroborated rows show them.

Prints one line a row and writes the report as JSON to --out, or to
standard output by default; it never writes the repository's
UEP_AMBIGUITY.json (tpudab's tool does).

Run: python -m tpudab_torch.tools.uep_ambiguity [--slack N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys

from tpudab_torch.constants.puncture import _UEP_ROWS
from tpudab_torch.fec.uep_calibrate import candidate_profiles, shipped_in_prior


def report(slack: int = 1) -> dict:
    """The report tpudab's tool writes, for one slack."""
    rows = []
    for br, pl, size, l0, pi0, pad0, conf in _UEP_ROWS:
        if conf != "s":
            continue
        # candidate_profiles puts the shipped row first, then the
        # alternatives; the shipped row counts as a candidate only where
        # it satisfies the structural prior itself
        cands = candidate_profiles(br, pl, slack=slack)
        alts = cands[1:]
        shipped_ok = shipped_in_prior(br, pl, slack)
        rows.append({
            "bitrate_kbps": br, "protection_level": pl, "size_cu": size,
            "shipped": {"L": list(l0), "PI": list(pi0), "padding": pad0},
            "n_candidates": len(alts) + (1 if shipped_ok else 0),
            "shipped_is_candidate": shipped_ok,
            "alternatives": [{"L": list(c.l), "PI": list(c.pi), "padding": c.padding_bits}
                             for c in alts[:12]],
        })
        print(f"{br:>4} kbps PL{pl}: {len(alts) + 1:>4} budget+structure-exact candidates "
              f"(self-calibrated online, fec/uep_calibrate.py)", file=sys.stderr)
    return {
        "method": "exhaustive enumeration under the bit-budget identity, "
                  "the block-count identity, and PI/L structure induced "
                  f"from the 54 corroborated rows (slack {slack}); "
                  "enumeration code: tpudab.fec.uep_calibrate."
                  "candidate_profiles (scored online against the received "
                  "signal by the self-calibration)",
        "slack": slack,
        "rows": rows,
    }


def main(argv=None) -> dict:
    """Parse [--slack N] [--out PATH], write the report; returns it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slack", type=int, default=1,
                    help="widen the induced PI/L1 ranges by this much")
    ap.add_argument("--out", default="-",
                    help="where the JSON goes (default '-': standard output)")
    args = ap.parse_args(argv)
    out = report(args.slack)
    if args.out == "-":
        json.dump(out, sys.stdout, indent=1)
        print()
    else:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"full detail -> {args.out}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()

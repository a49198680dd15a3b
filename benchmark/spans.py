"""What the per-layer metrics named span.* share: the program's own spans
(tpudab_torch.host.profiling.spans(), read in the benchmark's process
after the window), summed within each root and reduced to a median over
the traced run's stretch of steps profiled on the card alone.

A root is one call of the program's outermost span: a step (`step`), or,
in the step driver's traced run, which calls the step's two halves, each
half (`demod`, `fec`). The program records spans only under a profiler,
so the first r["steps"] roots of each kind are the driver's first
profiled stretch (the card alone); its host-recording stretch follows.
Off the card, or with a program that records no spans, the readers find
nothing and return None."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence


def records() -> List[dict]:
    """The program's span records; none where it has no span recorder."""
    try:
        from tpudab_torch.host.profiling import spans
    except ImportError:
        return []
    return spans()


def per_root(recs: Sequence[dict], name: str, clock: str = "device_ms") -> List[Optional[float]]:
    """The sum of `clock` over the spans called `name`, one sum a root that
    holds any, in the order the roots opened (None where a span lacks the
    clock)."""
    sums: Dict[int, Optional[float]] = {}
    for s in recs:
        if s["name"] == name:
            v, acc = s[clock], sums.get(s["root"], 0.0)
            sums[s["root"]] = None if v is None or acc is None else acc + v
    return list(sums.values())


def median_ms(r: dict, names: Sequence[str], clock: str = "device_ms") -> Optional[float]:
    """The median over the first r["steps"] steps of the sum of the spans
    in `names` a step (each name's roots taken in order); None off the
    card or where there is nothing to read."""
    if not r.get("cuda"):
        return None
    recs = records()
    rows = [per_root(recs, n, clock)[: r["steps"]] for n in names]
    steps = [sum(vs) for vs in zip(*rows) if None not in vs]
    return statistics.median(steps) if steps and len(steps) == min(map(len, rows)) else None

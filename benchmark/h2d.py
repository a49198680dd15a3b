"""The host-to-device copies of a torch.profiler chrome trace: what the
ingest metrics (benchmark/metrics/ingest_overlap.py, h2d_link_share.py)
read. A copy is a `gpu_memcpy` event from pinned host memory to the
device ("Memcpy HtoD (Pinned -> Device)"); its overlap is the part of it
during which any kernel ran (the union of the kernels' intervals)."""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from benchmark.trace import _union


def is_pinned_h2d(event: dict) -> bool:
    name = event.get("name", "")
    return event.get("cat") == "gpu_memcpy" and "HtoD" in name and "Pinned" in name


def summarize_events(events: List[dict]) -> Optional[Dict[str, float]]:
    """{"copies", "copy_s", "overlap_s", "bytes"} of the complete ("X")
    events' pinned host-to-device copies: their count, summed device time,
    the time of it during which a kernel ran, and their bytes (the trace's
    `bytes` argument; 0 where it has none). None where there is no copy."""
    events = [e for e in events if e.get("ph") == "X"]
    copies = [e for e in events if is_pinned_h2d(e)]
    if not copies:
        return None
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"])
    overlap = 0.0
    for c in copies:
        a, b = c["ts"], c["ts"] + c["dur"]
        overlap += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    return {"copies": len(copies),
            "copy_s": sum(c["dur"] for c in copies) / 1e6,
            "overlap_s": overlap / 1e6,
            "bytes": sum(int(c.get("args", {}).get("bytes", 0)) for c in copies)}


def summarize(path: str) -> Optional[Dict[str, float]]:
    """summarize_events of the chrome trace at path."""
    with open(path) as f:
        return summarize_events(json.load(f)["traceEvents"])

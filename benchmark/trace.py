"""Reduction of a torch.profiler chrome trace to what the per-layer metrics
and the result's `device` and `breakdown` read: the traced window (from
the first to the last of the harness's step or pass annotations, or, in a
trace of the card alone, from the first device operation to the end of the
last), the union of device activity inside it, each kernel's time and
count, and the idle gaps of the device named by what the host was doing."""

from __future__ import annotations

import heapq
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _attribute(gaps, host) -> Dict[str, float]:
    """Seconds of the gaps by the innermost host op running (the latest
    started of those still running), "(no host op)" where none is: a
    sweep over the ops' and the gaps' edges."""
    idle = defaultdict(float)
    edges = sorted({t for a, b in gaps for t in (a, b)} | {t for a, b, _ in host for t in (a, b)})
    starts = sorted(host)
    active: List[Tuple[float, float, str]] = []      # heap on -start
    gi, si = 0, 0
    for t0, t1 in zip(edges, edges[1:]):
        while si < len(starts) and starts[si][0] <= t0:
            a, b, name = starts[si]
            heapq.heappush(active, (-a, b, name))
            si += 1
        while active and active[0][1] <= t0:
            heapq.heappop(active)
        while gi < len(gaps) and gaps[gi][1] <= t0:
            gi += 1
        if gi < len(gaps) and gaps[gi][0] <= t0 < gaps[gi][1]:
            idle[active[0][2] if active else "(no host op)"] += (t1 - t0) / 1e6
    return idle


def summarize(path: str, marker: Optional[str]) -> Optional[Dict]:
    """The chrome trace at path, its window bounded by the user annotations
    named marker, or with marker None by the device's operations (None
    where it holds none). Returns {"window_s", "busy_s", "marks",
    "kernels": {name: [seconds, count]}, "launches", "device_ops": [[name,
    s]], "idle_gaps": [[host op, s]]}; times in seconds."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    marks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == marker]
    bounds = marks if marker is not None else [e for e in events
                                               if e.get("cat") in DEVICE_CATS]
    if not bounds:
        if marker is None:
            return None
        raise RuntimeError(f"the trace holds no {marker!r} annotation")
    w0 = min(e["ts"] for e in bounds)
    w1 = max(e["ts"] + e["dur"] for e in bounds)
    dev, kernels = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            kernels[e["name"]][0] += (b - a) / 1e6
            kernels[e["name"]][1] += 1
    busy = _union(dev)
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e["name"] != marker]
    idle = _attribute(gaps, host)
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "marks": len(marks),
            "kernels": dict(kernels),
            "launches": sum(c for _, c in kernels.values()),
            "device_ops": [[name, s] for name, (s, _) in ops[:TOP]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:TOP]}


def kernel_seconds(summary: Dict, name: str) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds `name` followed
    by a template or argument list, so that viterbi_kernel does not
    take in viterbi_bits_kernel."""
    s, n = 0.0, 0
    for k, (sec, cnt) in summary["kernels"].items():
        i = k.find(name)
        if i >= 0 and (i == 0 or not (k[i - 1].isalnum() or k[i - 1] == "_")) \
                and k[i + len(name): i + len(name) + 1] in ("<", "(", ""):
            s += sec
            n += cnt
    return s, n

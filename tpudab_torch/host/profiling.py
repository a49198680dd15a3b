"""Tracing/profiling: torch.profiler traces + per-stage host counters.
Counterpart of tpudab.host.profiling.

`trace()` captures a profile (host activity, and the card's kernels and
copies when the device is CUDA) and writes it as a Chrome trace, viewable in
Perfetto or chrome://tracing; StageTimer gives per-stage wall-time and
throughput counters that the dashboard and the smoke script report.
StageTimer reads the host clock: a stage that queues device work and ends
without a host read times the enqueue, and the device time lands in the
first later stage that waits for a result.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator

from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device=DEFAULT_DEVICE) -> Iterator[None]:
    """Capture a torch.profiler trace into log_dir/trace.json: CPU
    activity, plus CUDA activity when `device` is a CUDA device (which must
    exist)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall time + item counts per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.items: Dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.items[name] += items

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, total in self.totals.items():
            entry = {"seconds": total, "calls": self.counts[name]}
            if self.items[name]:
                entry["items_per_s"] = self.items[name] / max(total, 1e-12)
            out[name] = entry
        return out

    def report(self) -> str:
        lines = []
        for name, e in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["seconds"]):
            rate = f" {e['items_per_s']:.3g}/s" if "items_per_s" in e else ""
            lines.append(f"{name:<24} {e['seconds']:8.3f}s x{e['calls']}{rate}")
        return "\n".join(lines)

"""Tracing/profiling: the port's span recorder, torch.profiler traces and
per-stage host counters. Counterpart of tpudab.host.profiling.

span(name, items, device) marks a layer boundary of the program (the
receive step, its demod and FEC halves and their stages, the read-back,
and `ingest`, a HostFeed's copy of a step's u8 IQ from host memory,
items = bytes, timed on the feed's copy stream: a span's events go on the
current stream, which the feed makes its own around the copy).
Spans record only while a torch.profiler session records in the calling
thread, and never while the current CUDA stream is being captured into a
graph; otherwise span() returns one shared no-op context, at the cost of
one flag read. A recorded span opens a record_function range (the one
torch.profiler.record_function(name) opens), so it shows in the Chrome
trace as a user_annotation on the kernels' clock; it keeps the host's
perf_counter_ns at its start and end, and on a CUDA device a pair of
timing events on the current stream (the card's clock); and it stores a
record in a bounded ring (SPAN_CAPACITY): name, id, parent id, root id (a
span opened inside another takes its parent's root, so the spans of one
step share it) and items, a count of the work it covers. spans() reads
the ring, resolving the events then; reset_spans() clears it.

For an operator, `with trace(log_dir, device): ...` captures a profile
(host activity, and the card's kernels and copies when the device is CUDA)
into log_dir/trace.json, viewable in Perfetto or chrome://tracing, and the
spans recorded inside it into log_dir/spans.json.

StageTimer gives per-stage wall-time and throughput counters that the
dashboard and the smoke script report, and opens span("stage.<name>") for
each stage. It reads the host clock: a stage that queues device work and
ends without a host read times the enqueue, and the device time lands in
the first later stage that waits for a result.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device

SPAN_CAPACITY = 65536

_profiler_enabled = torch._C._autograd._profiler_enabled
# torch.profiler.record_function's user-scope range without its Python
# wrapper and dispatcher round trip (a quarter of its host time)
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit
_OFF = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "id", "parent", "root", "items", "t0", "t1", "ev0", "ev1",
                 "device_ms")

    def __init__(self, name: str, sid: int, parent: Optional["_Record"], items: float):
        self.name, self.id, self.items = name, sid, items
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else sid
        self.t0 = self.t1 = self.ev0 = self.ev1 = self.device_ms = None


class _Recorder:
    """The ring of span records, the ids and each thread's open spans."""

    def __init__(self, capacity: int):
        self.ring = collections.deque(maxlen=capacity)
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> List[_Record]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_RECORDER = _Recorder(SPAN_CAPACITY)


class _Span:
    __slots__ = ("name", "items", "stream", "rec", "range")

    def __init__(self, name: str, items: float, stream):
        self.name, self.items, self.stream = name, items, stream

    def __enter__(self):
        stack = _RECORDER.stack()
        rec = _Record(self.name, next(_RECORDER.ids), stack[-1] if stack else None, self.items)
        self.range = _range_enter(self.name)
        if self.stream is not None:
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record(self.stream)
        stack.append(rec)
        _RECORDER.ring.append(rec)
        self.rec = rec
        rec.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        if self.stream is not None:
            rec.ev1 = torch.cuda.Event(enable_timing=True)
            rec.ev1.record(self.stream)
        _RECORDER.stack().pop()
        _range_exit(self.range)
        return False


def profiling() -> bool:
    """Whether a torch.profiler session records in the calling thread."""
    return _profiler_enabled()


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def span(name: str, items: float = 0, device=None):
    """A context that records the span `name` covering `items` units of
    work, timed on the card when `device` is a CUDA device; the shared
    no-op context unless a profiler records in this thread, and while the
    current CUDA stream is being captured."""
    if not _profiler_enabled() or capturing():
        return _OFF
    stream = None
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
    return _Span(name, items, stream)


def _resolve(rec: _Record) -> dict:
    if rec.ev1 is not None:
        rec.ev1.synchronize()
        rec.device_ms = rec.ev0.elapsed_time(rec.ev1)
        rec.ev0 = rec.ev1 = None
    return {"name": rec.name, "id": rec.id, "parent": rec.parent, "root": rec.root,
            "items": rec.items, "host_start_ns": rec.t0, "host_end_ns": rec.t1,
            "host_ms": (rec.t1 - rec.t0) / 1e6, "device_ms": rec.device_ms}


def spans(since: int = -1) -> List[dict]:
    """The closed spans in the ring with an id above `since`, in the order
    they opened: {name, id, parent, root, items, host_start_ns,
    host_end_ns, host_ms, device_ms (None off the card)}. Reading waits
    for the card to pass each span's end."""
    return [_resolve(r) for r in list(_RECORDER.ring) if r.t1 is not None and r.id > since]


def reset_spans() -> None:
    _RECORDER.ring.clear()


@contextlib.contextmanager
def trace(log_dir: str, device=DEFAULT_DEVICE) -> Iterator[None]:
    """Capture a torch.profiler trace into log_dir/trace.json: CPU
    activity, plus CUDA activity when `device` is a CUDA device (which must
    exist); and the spans recorded meanwhile into log_dir/spans.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    since = next(_RECORDER.ids)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump(spans(since), f)


class StageTimer:
    """Accumulates wall time + item counts per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.items: Dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0) -> Iterator[None]:
        with span("stage." + name, items):
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

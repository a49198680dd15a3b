"""The span.* readers on a hand-made span store: sums within a root, the
median over the first `steps` roots only, the halves' roots paired step
by step, and None where there is nothing to read (no spans, no card, a
program without a span recorder)."""

import pytest

from benchmark import harness, spans
from tpudab_torch.host import profiling

STEPS = 4
NAMES = ["span.demod_ms", "span.fec_ms", "span.enqueue_ms", "span.demod.carve_ms",
         "span.demod.dft_ms", "span.demod.demap_ms", "span.demod.norm_ms",
         "span.demod.stats_ms", "span.fec.deint_ms", "span.fec.viterbi_ms"]


def store(n_steps, extra=1000.0, forward=False):
    """The driver's traced run: each step a `demod` root with its five
    stages and a `fec` root with two fec.deint and two fec.viterbi (with
    forward=True both under one `step` root); step k takes k ms a stage,
    device and host alike (host ms halved), and steps past STEPS add
    `extra`."""
    recs, ids = [], iter(range(10 ** 6))

    def add(name, root, parent, ms):
        sid = next(ids)
        recs.append({"name": name, "id": sid, "parent": parent,
                     "root": sid if root is None else root, "items": 0,
                     "host_ms": ms / 2, "device_ms": ms})
        return sid

    for k in range(n_steps):
        ms = k + 1.0 + (extra if k >= STEPS else 0.0)
        top = add("step", None, None, 9 * ms) if forward else None
        d = add("demod", top, top, 5 * ms)
        for st in ("carve", "dft", "demap", "norm", "stats"):
            add(f"demod.{st}", top if forward else d, d, ms)
        f = add("fec", top, top, 4 * ms)
        for st in ("deint", "viterbi", "deint", "viterbi"):
            add(f"fec.{st}", top if forward else f, f, ms)
    return recs


def read(name, r, monkeypatch, recs):
    monkeypatch.setattr(spans, "records", lambda: recs)
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(r)


def test_per_root_sums_within_each_root():
    recs = store(3)
    assert spans.per_root(recs, "fec.deint") == [2.0, 4.0, 6.0]
    assert spans.per_root(recs, "demod") == [5.0, 10.0, 15.0]
    assert spans.per_root(recs, "demod.dft", "host_ms") == [0.5, 1.0, 1.5]
    assert spans.per_root(recs, "readback") == []
    recs[1]["device_ms"] = None
    assert spans.per_root(recs, "demod.carve") == [None, 2.0, 3.0]


@pytest.mark.parametrize("name, want", [
    ("span.demod_ms", 12.5), ("span.fec_ms", 10.0), ("span.enqueue_ms", 11.25),
    ("span.demod.carve_ms", 2.5), ("span.demod.dft_ms", 2.5), ("span.demod.demap_ms", 2.5),
    ("span.demod.norm_ms", 2.5), ("span.demod.stats_ms", 2.5), ("span.fec.deint_ms", 5.0),
    ("span.fec.viterbi_ms", 5.0)])
def test_median_over_the_first_steps_roots(name, want, monkeypatch):
    """Steps 1-4 read k ms a stage, steps 5-7 over 1000: the median is
    over steps 1-4 alone."""
    assert read(name, {"cuda": True, "steps": STEPS}, monkeypatch, store(STEPS + 3)) == want


def test_forward_roots_read_as_the_halves(monkeypatch):
    """Under forward's `step` root the halves share a root a step: the
    readers give what they give when the halves are roots of their own."""
    r = {"cuda": True, "steps": STEPS}
    whole, split = store(STEPS + 3, forward=True), store(STEPS + 3)
    assert len({s["root"] for s in whole}) == STEPS + 3
    for name in NAMES:
        assert read(name, r, monkeypatch, whole) == read(name, r, monkeypatch, split)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_is_none(name, monkeypatch):
    r = {"cuda": True, "steps": STEPS}
    assert read(name, r, monkeypatch, []) is None
    assert read(name, {"cuda": False, "steps": STEPS}, monkeypatch, store(STEPS)) is None
    off_card = store(STEPS)
    for s in off_card:
        s["device_ms"] = None
    want_none = name != "span.enqueue_ms"
    assert (read(name, r, monkeypatch, off_card) is None) == want_none


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent's program has no span recorder: nothing to read."""
    monkeypatch.delattr(profiling, "spans")
    assert spans.records() == []
    monkeypatch.undo()
    assert spans.records() == profiling.spans()

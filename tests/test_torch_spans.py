"""The port's span recorder (host/profiling.py) and the spans inside the
receive step: off without a profiler (one shared no-op context, nothing
recorded), results bit-equal on and off, the tree a step records under a
profiler (names, parents, roots and items), the sharded step's, trace()'s
spans.json and user_annotation events, StageTimer's stage spans, the
ring's bound, no spans under CUDA graph capture, and StepDriver's
read-back."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpudab_torch.constants.dab_params import CU_BITS, get_dab_params
from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.constants.puncture import eep_profile
from tpudab_torch.host import profiling
from tpudab_torch.host.profiling import StageTimer, reset_spans, span, spans, trace
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.models.step_driver import StepDriver, read_back
from tpudab_torch.msc.subchannel import SubchannelConfig
from tpudab_torch.parallel.mesh import Mesh
from tpudab_torch.parallel.sharded_step import ShardedReceiveStep
from tpudab_torch.tools.bench import bench_subchannels

DEMOD_STAGES = ["demod.carve", "demod.dft", "demod.demap", "demod.norm", "demod.stats"]
N_FRAMES = 1


@pytest.fixture(autouse=True)
def empty_ring():
    reset_spans()
    yield
    reset_spans()


@pytest.fixture(scope="module")
def step():
    return ReceiveStep(1, bench_subchannels())


@pytest.fixture(scope="module")
def args(step):
    return step.example_args(N_FRAMES, seed=3, device="cpu")


def one_thread(fn):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def halves(step, args):
    carry, re, im, freq = args
    soft, stats = step.demod(re, im, freq)
    return (soft, stats) + step.decode_soft(carry, soft)


@pytest.fixture(scope="module")
def off(step, args):
    reset_spans()
    out = one_thread(lambda: (halves(step, args), step(*args)))
    assert spans() == []
    return out


@pytest.fixture(scope="module")
def on(step, args):
    """The halves then forward under a profiler recording the CPU, with
    the spans each recorded."""
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("demod") is not profiling._OFF
        h = one_thread(lambda: halves(step, args))
        split = spans()
        reset_spans()
        fwd = one_thread(lambda: step(*args))
        whole = spans()
    reset_spans()
    return h, fwd, split, whole


def test_off_records_nothing_and_span_is_shared(off):
    assert spans() == []
    s = span("demod", 5, "cpu")
    assert s is span("fec") is profiling._OFF
    with s, span("step"):
        pass
    assert spans() == []


def test_outputs_bit_equal_with_spans_on_and_off(off, on):
    (soft0, stats0, carry0, fic0, sub0), (fcarry0, fout0) = off
    (soft1, stats1, carry1, fic1, sub1), (fcarry1, fout1), _, _ = on
    assert torch.equal(soft0, soft1) and torch.equal(fic0, fic1)
    assert sub0.keys() == sub1.keys() and all(torch.equal(sub0[k], sub1[k]) for k in sub0)
    assert all(torch.equal(stats0[k], stats1[k]) for k in ("mean_power", "const_re", "const_im"))
    assert all(torch.equal(carry0[k], carry1[k]) for k in carry0)
    assert all(torch.equal(fcarry0[k], fcarry1[k]) for k in fcarry0)
    for k in ("fic_bytes", "mean_power", "const_re", "const_im"):
        assert torch.equal(fout0[k], fout1[k])
    assert all(torch.equal(fout0["subch"][k], fout1["subch"][k]) for k in fout0["subch"])


def test_halves_record_the_stage_tree(step, on):
    _, _, split, _ = on
    p, dab = get_ofdm_params(1), get_dab_params(1)
    by_id = {s["id"]: s for s in split}
    roots = [s for s in split if s["parent"] is None]
    assert [s["name"] for s in roots] == ["demod", "fec"]
    demod, fec = roots
    assert demod["items"] == N_FRAMES and fec["items"] == 0
    kids = {r["id"]: [s for s in split if s["parent"] == r["id"]] for r in roots}
    assert [s["name"] for s in kids[demod["id"]]] == DEMOD_STAGES
    n_groups = len(step.groups)
    assert [s["name"] for s in kids[fec["id"]]] == \
        ["fec.deint", "fec.viterbi", "fec.deint"] + ["fec.viterbi"] * n_groups
    for s in split:
        top = s
        while top["parent"] is not None:
            top = by_id[top["parent"]]
        assert s["root"] == top["id"]
        assert s["device_ms"] is None and s["host_ms"] >= 0
        assert s["host_end_ns"] >= s["host_start_ns"]
    items = {s["name"]: s["items"] for s in kids[demod["id"]]}
    assert items == {"demod.carve": N_FRAMES * p.nb_symbols * p.nb_fft, "demod.dft": 0,
                     "demod.demap": 0, "demod.norm": N_FRAMES * p.nb_frame_bits,
                     "demod.stats": 0}
    deint = [s["items"] for s in kids[fec["id"]] if s["name"] == "fec.deint"]
    slice_bits = sum(c.size_cu * CU_BITS for c in bench_subchannels())
    assert deint == [N_FRAMES * dab.nb_fic_bits, N_FRAMES * dab.nb_cifs * slice_bits]
    codewords = [s["items"] for s in kids[fec["id"]] if s["name"] == "fec.viterbi"]
    assert codewords == [N_FRAMES * dab.nb_fib_groups,
                         len(bench_subchannels()) * N_FRAMES * dab.nb_cifs]
    # a child lies inside its parent on the host's clock
    for s in split:
        if s["parent"] is not None:
            q = by_id[s["parent"]]
            assert q["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"] \
                <= q["host_end_ns"]


def test_forward_roots_every_span_at_step(on):
    _, _, split, whole = on
    (root,) = [s for s in whole if s["parent"] is None]
    assert root["name"] == "step" and root["items"] == N_FRAMES
    assert all(s["root"] == root["id"] for s in whole)
    assert [s["name"] for s in whole if s["parent"] == root["id"]] == ["demod", "fec"]
    assert sorted(s["name"] for s in whole) == sorted(["step"] + [s["name"] for s in split])


def test_trace_writes_spans_and_annotations(tmp_path, step, args):
    with trace(str(tmp_path / "tr"), device="cpu"):
        one_thread(lambda: step(*args))
    recorded = json.loads((tmp_path / "tr" / "spans.json").read_text())
    names = {s["name"] for s in recorded}
    assert names == {"step", "demod", "fec", "fec.deint", "fec.viterbi", *DEMOD_STAGES}
    assert len({s["root"] for s in recorded}) == 1
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert names <= annotated
    # only what the trace saw
    with trace(str(tmp_path / "tr2"), device="cpu"):
        pass
    assert json.loads((tmp_path / "tr2" / "spans.json").read_text()) == []


def test_stage_timer_opens_stage_spans():
    t = StageTimer()
    with t.stage("read"):
        pass
    assert spans() == [] and t.counts["read"] == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with t.stage("step", 786432):
            with span("demod", 4):
                pass
    outer, inner = spans()
    assert (outer["name"], outer["items"], outer["parent"]) == ("stage.step", 786432, None)
    assert (inner["name"], inner["parent"], inner["root"]) == ("demod", outer["id"], outer["id"])
    assert t.counts == {"read": 1, "step": 1} and t.items["step"] == 786432


def test_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder(3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span(f"s{i}", i):
                pass
    assert [s["name"] for s in spans()] == ["s2", "s3", "s4"]
    assert [s["items"] for s in spans(since=spans()[0]["id"])] == [3, 4]


def test_no_spans_while_a_graph_is_captured(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("step", 1) as s:
            assert s is None
    assert spans() == []


class _Receiver:
    """What StepDriver.process asks of a Receiver, recording its input."""
    dab = get_dab_params(1)

    def process_step_outputs(self, fic_bytes, subch_bytes, first_logical):
        self.got = (fic_bytes, subch_bytes, first_logical)
        return {}


def test_read_back_is_process_copy(step, args, off):
    _, (_, out) = off
    fic, sub = read_back(out)
    assert isinstance(fic, np.ndarray) and np.array_equal(fic, out["fic_bytes"].numpy())
    assert list(sub) == list(out["subch"])
    assert all(np.array_equal(sub[k], out["subch"][k].numpy()) for k in sub)
    assert spans() == []
    n_bytes = fic.nbytes + sum(v.nbytes for v in sub.values())
    with profile(activities=[ProfilerActivity.CPU]):
        read_back(out)
    (rb,) = spans()
    assert rb["name"] == "readback" and rb["items"] == n_bytes and rb["parent"] is None
    reset_spans()

    drv = StepDriver(1, step.window_offset, "cpu")
    drv.step, drv.carry = step, args[0]
    drv.first_logical = {c.subch_id: 0 for c in step.subchannels}
    rx = _Receiver()
    with profile(activities=[ProfilerActivity.CPU]):
        one_thread(lambda: drv.process(rx, *args[1:]))
    got_fic, got_sub, _ = rx.got
    assert np.array_equal(got_fic, fic) and all(np.array_equal(got_sub[k], sub[k]) for k in sub)
    assert [s["name"] for s in spans() if s["parent"] is None] == ["step", "readback"]


def test_sharded_step_roots_its_spans_at_step():
    """At mesh (1, 1) (no exchange, no process group) a call is one `step`
    root over the demod of the edge frames, then of the interior, and the
    FEC half."""
    sub = (SubchannelConfig(1, 0, 24, eep_profile(24, 3, 0)),)
    step = ShardedReceiveStep(Mesh((1, 1), 0, None, None, "gloo"), 1, sub, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 5, 1536, 128)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]):
        one_thread(lambda: step(step.init_carry(1), frames, frames, torch.zeros(1)))
    rec = spans()
    (root,) = [s for s in rec if s["parent"] is None]
    assert (root["name"], root["items"]) == ("step", 5)
    assert all(s["root"] == root["id"] for s in rec)
    assert [s["name"] for s in rec if s["parent"] == root["id"]] == DEMOD_STAGES * 2 + ["fec"]
    assert [s["items"] for s in rec if s["name"] == "demod.norm"] == \
        [4 * get_ofdm_params(1).nb_frame_bits, get_ofdm_params(1).nb_frame_bits]

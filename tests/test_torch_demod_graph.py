"""When ReceiveStep's demod replays a CUDA graph (models/demod_graph.py),
on the CPU: the rule over the frames' keys, the key itself, the test for
a recording profiler, and the route a call takes through DemodGraphs with
the capture faked. The graphs themselves run on the card
(tests/test_torch_cuda.py)."""

import pytest
import torch

from tpudab_torch.models import demod_graph
from tpudab_torch.models.demod_graph import (CAPTURE, EAGER, GRAPHS, REPLAY, SEEN,
                                             DemodGraphs, GraphRule, engages, frames_key)
from tpudab_torch.models.ingest import BUFFERS
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.ofdm.demod import dft_operands


def test_first_sighting_eager_second_captures_then_replays():
    rule = GraphRule()
    assert [rule.route("a") for _ in range(5)] == [EAGER, CAPTURE, REPLAY, REPLAY, REPLAY]


def test_two_keys_at_most_a_third_eager():
    """A HostFeed's two buffers alternate: each captures at its second
    sighting; a third key, seen as often, never captures."""
    assert GRAPHS == BUFFERS == 2
    rule = GraphRule()
    got = [rule.route(k) for k in "abababcccc"]
    assert got == [EAGER, EAGER, CAPTURE, CAPTURE, REPLAY, REPLAY] + [EAGER] * 4
    assert rule.held == {"a", "b"}


def test_frames_that_never_repeat_stay_eager():
    """Frames at a new block every call never capture, and the rule
    remembers no more than SEEN first sightings: a key seen again after
    SEEN others is a first sighting again."""
    rule = GraphRule()
    assert {rule.route(k) for k in range(100)} == {EAGER}
    assert len(rule.seen) == SEEN and not rule.held
    assert rule.route(0) == EAGER and rule.route(0) == CAPTURE


def test_eager_under_a_recording_profiler():
    """The graph engages on CUDA with the bf16 operands, never under a
    profiler recording in this thread, on the CPU or with f32 operands."""
    cuda = torch.device("cuda", 0)
    bf16, f32 = dft_operands(1, "bfloat16"), dft_operands(1, "float32")
    assert engages(cuda, bf16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert not engages(cuda, bf16)
    assert engages(cuda, bf16)
    assert not engages(torch.device("cpu"), bf16)
    assert not engages(cuda, f32)


def _frames():
    re = torch.zeros((2, 4, 1536, 128), dtype=torch.bfloat16)
    return re, torch.zeros_like(re)


@pytest.mark.parametrize("case,same", [
    ("rewritten_in_place", True),
    ("clone", False),
    ("flat", False),
    ("strided", False),
    ("dtype", False),
    ("im_elsewhere", False),
])
def test_key_is_address_shape_strides_dtype(case, same):
    """The key of (frames_re, frames_im): address, shape, strides and dtype
    of each, so frames rewritten in place keep it and any other tensor,
    view or part changes it."""
    re, im = _frames()
    key = frames_key(re, im)
    other = {
        "rewritten_in_place": lambda: (re.fill_(3.0), im.fill_(-1.0)),
        "clone": lambda: (re.clone(), im),
        "flat": lambda: (re.reshape(2, 4, -1), im.reshape(2, 4, -1)),
        "strided": lambda: (re.transpose(0, 1), im.transpose(0, 1)),
        "dtype": lambda: (re.view(torch.int16), im.view(torch.int16)),
        "im_elsewhere": lambda: (re, im.clone()),
    }[case]()
    assert (frames_key(*other) == key) is same
    assert all(x.data_ptr() == p[0] for x, p in zip((re, im), key))


def test_key_of_u8_frames():
    u8 = torch.zeros((4, 196608, 2), dtype=torch.uint8)
    key = frames_key(u8, None)
    assert key == ((u8.data_ptr(), (4, 196608, 2), (393216, 2, 1), torch.uint8), None)


class _FakeGraph:
    """_Graph's contract without a capture: records the frequency each
    replay was handed and returns it as its output."""

    made = []

    def __init__(self, chain, operands, frames_re, frames_im, freq_shape, pool):
        self.freq_shape, self.freqs = freq_shape, []
        _FakeGraph.made.append(self)

    def replay(self, freq_hz):
        self.freqs.append(freq_hz)
        return "graph", {"freq": freq_hz}


def test_route_through_demod_graphs(monkeypatch):
    """With the graph engaging (faked, as on the card), the same frames
    handed with a new frequency each call: the first runs the chain, the
    second captures and replays, later calls replay with their own
    frequency; freq is not part of the key. Counters: captures 1, replays
    (the capture's call included) 3, eager 1."""
    monkeypatch.setattr(demod_graph, "engages", lambda device, operands: True)
    monkeypatch.setattr(demod_graph, "_Graph", _FakeGraph)
    monkeypatch.setattr(demod_graph.torch.cuda, "graph_pool_handle", lambda: "pool")
    _FakeGraph.made = []
    calls = []

    def chain(re, im, freq):
        calls.append(freq)
        return "eager", {}

    graphs = DemodGraphs()
    re, im = _frames()
    got = [graphs.run(chain, (), re, im, freq, (2,))[0] for freq in (10.0, 20.0, 30.0, 40.0)]
    assert got == ["eager", "graph", "graph", "graph"]
    assert calls == [10.0]
    (g,) = _FakeGraph.made
    assert g.freq_shape == (2,) and g.freqs == [20.0, 30.0, 40.0]
    assert (graphs.captures, graphs.replays, graphs.eager) == (1, 3, 1)
    assert graphs.pool == "pool"


def test_step_on_the_cpu_runs_eagerly():
    """ReceiveStep.demod on the CPU: every call runs the chain, nothing is
    captured and the rule is never asked."""
    step = ReceiveStep(1, ())
    _, re, im, freq = step.example_args(n_frames=1, device="cpu")
    outs = [step.demod(re, im, freq) for _ in range(2)]
    assert (step.graphs.captures, step.graphs.replays, step.graphs.eager) == (0, 0, 2)
    assert not step.graphs.rule.seen and not step.graphs.graphs
    assert torch.equal(outs[0][0], outs[1][0])

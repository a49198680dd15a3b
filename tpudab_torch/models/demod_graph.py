"""The receive step's demod half replayed as one CUDA graph.

On the card, ReceiveStep.demod enqueues about twenty launches a step: the
frequency's broadcast, K5's rotator tables (a dozen small ATen ops), K5,
the three bf16 DFT products and the demod tail's three kernels, each
wrapper with its allocations. The card runs them faster than the host
enqueues them, so it waits. DemodGraphs records the chain once as a
torch.cuda.CUDAGraph and then replays it in one launch: the same kernels,
in the same order, on the same inputs, so the same bits.

When a call replays (engages, GraphRule). The call is on a CUDA device
with the bf16 DFT operands (ofdm/demod.py::_tail_kernels), no profiler
records in the calling thread (so under a profiler every span and kernel
reads as on the eager chain) and the current stream is not being
captured. Then its frames' key (frames_key: address, shape, strides and
dtype of frames_re and of frames_im) decides: a key's first sighting runs
eagerly (it warms cuBLAS and loads the kernels' library before any
capture), its second captures the graph and replays it, later ones
replay. A step holds at most GRAPHS graphs, one a HostFeed buffer,
sharing one memory pool; other keys run eagerly. Every other call runs
the chain eagerly.

Inputs. A graph reads whatever lies at its frames' address when it
replays, so frames rewritten in place (a HostFeed's buffers) or a new
batch in a reused block are read afresh. freq_hz is copied into the
graph's own f32 input before each replay (fill_ from a number, copy_
from anything else), so it is not part of the key; a tracked stream hands
a dict of tensors in its place, its Tracker's state (ofdm/track.py), each
copied into the graph's own. The graph keeps the DFT operands it read
alive.

Outputs. mean_power and the tap are copied out into one tensor the
caller owns (one torch.cat a call); any other output of the chain (a
tracked stream's next state and consumed counts) is cloned. soft stays
the graph's buffer: valid until the step's next demod on the same
frames; with two graphs in one
pool, a replay of either may reuse the other's memory, so until the
step's next demod. Stream order keeps decode_soft, enqueued before that,
correct.

Counters: captures; replays (a capture's own call included); eager
calls. The kernel wrappers' `.launches` (counted()) still count every
launch the card runs once: what a capture counted is taken back and
added at each replay.
"""

from __future__ import annotations

import collections

import torch

from tpudab_torch.host.profiling import capturing, profiling
from tpudab_torch.models.ingest import BUFFERS
from tpudab_torch.ofdm import demod
from tpudab_torch.ops import carve, demod_tail

GRAPHS = BUFFERS     # one graph a HostFeed buffer
SEEN = 2 * GRAPHS    # first sightings remembered while a graph is free
EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"


def counted():
    """The kernel wrappers the demod chain calls that count their launches."""
    return (carve.carve_rotate_cuda, demod_tail.demap_cuda, demod_tail.norm_cuda,
            demod_tail.stats_cuda)


def frames_key(frames_re, frames_im):
    """The key of a demod call's frames: (address, shape, strides, dtype)
    of frames_re and of frames_im, None for rtl_sdr's u8 frames."""
    def part(x):
        return None if x is None else (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
    return part(frames_re), part(frames_im)


def engages(device, operands) -> bool:
    """Whether a demod call on `device` with these DFT operands may run as a
    graph: the kernels' path of ofdm/demod.py (CUDA, bf16 operands), no
    profiler recording in this thread, no capture under way."""
    return demod._tail_kernels(operands, device) and not profiling() and not capturing()


class GraphRule:
    """Which way a call whose frames have `key` runs, given the calls
    before it: EAGER at a key's first sighting, CAPTURE at its second while
    fewer than GRAPHS keys hold a graph, REPLAY once it holds one; EAGER
    for every other key."""

    def __init__(self):
        self.held = set()
        self.seen = collections.deque(maxlen=SEEN)

    def route(self, key) -> str:
        if key in self.held:
            return REPLAY
        if len(self.held) == GRAPHS:
            return EAGER
        if key in self.seen:
            self.held.add(key)
            return CAPTURE
        self.seen.append(key)
        return EAGER


STATS = ("mean_power", "const_re", "const_im")


def _clone(x):
    return {k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone()


class _Graph:
    """One captured demod chain: its f32 frequency input (or a tracked
    stream's state), its outputs and the launches its capture counted."""

    def __init__(self, chain, operands, frames_re, frames_im, freq_shape, pool):
        """freq_shape: the f32 frequency input's shape, or a dict of
        tensors (a tracked stream's state) whose copies are the inputs."""
        self.operands = operands
        if isinstance(freq_shape, dict):
            self.freq = _clone(freq_shape)
        else:
            self.freq = torch.zeros(freq_shape, dtype=torch.float32, device=frames_re.device)
        wrappers = counted()
        before = [w.launches for w in wrappers]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.soft, stats = chain(frames_re, frames_im, self.freq)
        self.stats = tuple(stats[k] for k in STATS)
        self.extra = {k: v for k, v in stats.items() if k not in STATS}
        self.launches = [(w, w.launches - n) for w, n in zip(wrappers, before)]
        for w, n in zip(wrappers, before):
            w.launches = n

    def replay(self, freq_hz):
        if isinstance(freq_hz, dict):
            for k, v in freq_hz.items():
                self.freq[k].copy_(v)
        elif isinstance(freq_hz, (int, float)):    # no copy from the host
            self.freq.fill_(freq_hz)
        else:
            self.freq.copy_(torch.as_tensor(freq_hz, dtype=torch.float32))
        self.graph.replay()
        for w, n in self.launches:
            w.launches += n
        out = torch.cat(self.stats)
        n_mp, n_tap = self.stats[0].numel(), self.stats[1].numel()
        return self.soft, {"mean_power": out[:n_mp], "const_re": out[n_mp:n_mp + n_tap],
                           "const_im": out[n_mp + n_tap:],
                           **{k: _clone(v) for k, v in self.extra.items()}}


class DemodGraphs:
    """A ReceiveStep's demod graphs and its counters (captures, replays,
    eager); see the module's docstring."""

    def __init__(self):
        self.rule = GraphRule()
        self.graphs = {}
        self.pool = None
        self.captures = self.replays = self.eager = 0

    def run(self, chain, operands, frames_re, frames_im, freq_hz, freq_shape):
        """chain(frames_re, frames_im, freq_hz) -> (soft, stats), eagerly
        or as a graph whose f32 frequency input has freq_shape (the shape
        the chain's freq_hz broadcasts to), or, freq_hz a dict of tensors,
        copies of them."""
        way = EAGER
        if engages(frames_re.device, operands):
            key = frames_key(frames_re, frames_im)
            way = self.rule.route(key)
        if way == EAGER:
            self.eager += 1
            return chain(frames_re, frames_im, freq_hz)
        if way == CAPTURE:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            inputs = freq_hz if isinstance(freq_hz, dict) else freq_shape
            self.graphs[key] = _Graph(chain, operands, frames_re, frames_im, inputs, self.pool)
            self.captures += 1
        self.replays += 1
        return self.graphs[key].replay(freq_hz)

"""HostFeed: rtl_sdr's raw u8 IQ from host memory to the card, one step ahead.

An rtl_sdr front end (osmocom's rtl_sdr / rtl_tcp) delivers 8-bit unsigned
interleaved I/Q into host memory, two bytes a sample. The receive step
reads those bytes as they are (K5 and stats_kernel convert them in
registers, ofdm/demod.py), so what crosses PCIe is the raw u8, a quarter of
the f32 pair that host-side conversion would send. A wideband receiver's
8-bit signed I/Q crosses as the same bytes, fed as a uint8 view: a
ReceiveStep with a ChannelPlan views the buffer it takes as int8.

A HostFeed owns two device buffers of the step's frames, shape
([E,] F, frame_len, 2) uint8, and on CUDA a copy stream of its own:

- feed(host) enqueues the copy of one step's frames from host memory
  (pinned, so the copy is a DMA that runs beside the kernels) into the
  next buffer, on the copy stream (one call of csrc/ingest.cu enqueues a
  copy a host region), inside span("ingest", items = bytes) timed there,
  adds them to bytes_copied, and returns. The copy first waits on the
  event recorded after the last kernel that read that buffer, so a buffer
  is never overwritten while a step still reads it. The host memory stays
  as it is, and alive, until the copy is done: until the step that reads
  these frames has run (a ring whose slot is handed back after the step),
  or until synchronize() returns, for a caller that rewrites it at once.
- take() hands the step the oldest buffer fed, after making the step's
  stream wait on that buffer's copy (a wait on the card; the host does not
  block); release() records, on the step's stream, the event after the
  last kernel that reads it (ReceiveStep.demod calls both).

A tracked stream (a ReceiveStep with a Tracker, ofdm/track.py) is fed
from each dongle's ring: feed(rings, offsets) copies row e of the buffer,
shape (E, L, 2), from ring e at sample offsets[e], the dongle's read
pointer, which the host advances by the samples the step reports it
consumed.

Fed before step k is enqueued, step k + 1's copy runs under step k's
kernels. `started` is the event recorded on the copy
stream just before the last copy began (None on the CPU, where a feed is
a plain copy).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Union

import torch

from tpudab_torch.host.profiling import span
from tpudab_torch.ops import _build
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device

BUFFERS = 2


class HostFeed:
    """Two device buffers of u8 frames of `shape`, fed from host memory on
    a copy stream; see the module's docstring."""

    def __init__(self, shape, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.shape = torch.Size(shape)
        if self.shape[-1] != 2:
            raise ValueError(f"HostFeed holds interleaved I/Q pairs, ([E,] F, frame_len, 2); "
                             f"got {tuple(self.shape)}")
        self.buffers = [torch.empty(self.shape, dtype=torch.uint8, device=self.device)
                        for _ in range(BUFFERS)]
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.bytes_copied = 0
        self.started: Optional[torch.cuda.Event] = None
        self._copied = [None] * BUFFERS      # event: the buffer's copy done
        self._free = [None] * BUFFERS        # event: the last kernel reading it done
        self._fed = collections.deque()      # buffers fed and not yet taken, oldest first
        self._taken: Optional[int] = None
        self._next = 0

    def feed(self, host: Union[torch.Tensor, Sequence[torch.Tensor]],
             offsets: Optional[Sequence[int]] = None) -> None:
        """Enqueue the copy of one step's frames to the next buffer: `host`
        a uint8 tensor of the buffers' size, or a sequence of them, one for
        each row of the leading axis (one host region an ensemble), in
        pinned memory for the copy to overlap the card's work. With
        `offsets`, host is one region a row, each a dongle's ring of I/Q
        pairs at least offsets[e] + a row's pairs long, and row e is copied
        from its pair offsets[e] on. Returns once the copy is enqueued; the
        host memory stays as it is, and alive, until the step that takes
        them has run or synchronize() returns."""
        i = self._next
        if i in self._fed or i == self._taken:
            raise RuntimeError("both buffers hold frames that no step has taken and released")
        parts = [host] if isinstance(host, torch.Tensor) else list(host)
        dst = self.buffers[i].view(len(parts), -1) if len(parts) in (1, self.shape[0]) else None
        skip = [0] * len(parts) if offsets is None else [2 * int(o) for o in offsets]
        if dst is None or len(skip) != len(parts) or any(
                p.dtype != torch.uint8 or p.device.type != "cpu" or not p.is_contiguous()
                or (p.numel() != dst.shape[1] if offsets is None
                    else not 0 <= k <= p.numel() - dst.shape[1])
                for p, k in zip(parts, skip)):
            raise ValueError(f"feed takes contiguous host uint8 frames of {tuple(self.shape)}, "
                             f"whole or as {self.shape[0]} rows, or {self.shape[0]} rings "
                             f"holding a row from each offset; got "
                             f"{[(tuple(p.shape), p.dtype, str(p.device)) for p in parts]}, "
                             f"offsets {offsets}")
        n_bytes = dst.numel()
        if self.stream is None:
            with span("ingest", n_bytes, self.device):
                for row, p, k in zip(dst, parts, skip):
                    row.copy_(p.reshape(-1)[k:k + dst.shape[1]])
        else:
            n = len(parts)
            dst_ptrs = (ctypes.c_void_p * n)(*(dst.data_ptr() + j * dst.shape[1]
                                               for j in range(n)))
            src_ptrs = (ctypes.c_void_p * n)(*(p.data_ptr() + k for p, k in zip(parts, skip)))
            sizes = (ctypes.c_longlong * n)(*([dst.shape[1]] * n))
            with torch.cuda.stream(self.stream):
                if self._free[i] is not None:
                    self.stream.wait_event(self._free[i])
                self.started = torch.cuda.Event(enable_timing=True)
                self.started.record(self.stream)
                with span("ingest", n_bytes, self.device):
                    _build.launch(_build.load_library().tpudab_copy_h2d, dst.get_device(),
                                  "copy_h2d", ctypes.addressof(dst_ptrs),
                                  ctypes.addressof(src_ptrs), ctypes.addressof(sizes), n)
                done = torch.cuda.Event()
                done.record(self.stream)
            self._copied[i] = done
        self.bytes_copied += n_bytes
        self._fed.append(i)
        self._next = (i + 1) % BUFFERS

    def synchronize(self) -> None:
        """Block the host until the last copy fed is on the card, so that
        its host memory may be rewritten."""
        done = self._copied[(self._next - 1) % BUFFERS]
        if done is not None:
            done.synchronize()

    def take(self) -> torch.Tensor:
        """The oldest buffer fed, for the step on the current stream, which
        waits on its copy."""
        if self._taken is not None:
            raise RuntimeError("the buffer taken last was not released")
        if not self._fed:
            raise RuntimeError("no frames were fed for this step")
        i = self._fed.popleft()
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_event(self._copied[i])
        self._taken = i
        return self.buffers[i]

    def release(self) -> None:
        """After the last kernel that reads the buffer taken was enqueued
        on the current stream: a later copy into it waits for that kernel."""
        i, self._taken = self._taken, None
        if i is None:
            raise RuntimeError("no buffer was taken")
        if self.stream is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._free[i] = ev

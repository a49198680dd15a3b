"""The receive step sharded over the (ensemble, time) mesh on
torch.distributed (counterpart of tpudab.parallel.sharded_step).

- 'ensemble' axis: independent DAB ensembles, pure data parallel, no
  communication.
- 'time' axis: each rank holds a contiguous run of transmission frames of
  the same ensembles. The only sequential coupling is the 16-CIF time
  deinterleaver; its 15-CIF history crosses to the right time neighbour as
  ONE message carrying all subchannels' tails concatenated, after which
  every rank decodes its frames on its own. The rank's trailing (edge)
  frames are demodulated first, so the exchange is posted before the bulk
  interior demod and flows while the card runs it.

Each rank runs the port's single-device chain: a ReceiveStep of E_l
ensembles (models/step.py), whose demod_frames_split (K5, the bf16 DFT
GEMMs, the tail's three kernels of csrc/demod_tail.cu) runs twice, on the edge frames and on the interior, and whose
decode_soft (K4 mode (b) from the soft bits and the halo to the Viterbi
input, K1+K2, the PRBS XOR) takes the halo as its carry. tpudab's sharded
step runs an f32 depuncture, deinterleave and non-transposed Viterbi
instead; the decoded bytes are the same.

The step-level carry, the stream's tail after the last time rank's block,
reaches time rank 0 for the next call over the same ring (rank T-1 sends
to rank 0), so a call stays one exchange. At T = 1 it stays local.

Transport follows the time group's backend: on NCCL the halo stays on the
card; on gloo, whose point-to-point ops take CPU tensors, it is copied to
host memory before the send and back after the receive.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpudab_torch.constants.dab_params import CIF_BITS, CU_BITS, get_dab_params
from tpudab_torch.host.profiling import span
from tpudab_torch.models.convert import carry_from_jax
from tpudab_torch.models.step import ReceiveStep, frames_on_device
from tpudab_torch.msc.interleave import TIME_INTERLEAVE_DEPTH
from tpudab_torch.msc.subchannel import SubchannelConfig
from tpudab_torch.ofdm.demod import demod_frames_split
from tpudab_torch.parallel.mesh import Mesh
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device

_H = TIME_INTERLEAVE_DEPTH - 1  # 15-CIF halo


class ShardedReceiveStep:
    """One rank's share of the sharded receive step.

    carry, out = step(carry, frames_re, frames_im, freq_hz) on this rank's
    block: frames (E_l, T_l, frame_len//128, 128) f32 on the step's device
    (shard_inputs), freq_hz (E_l,). carry {"deint_<id>": (E_l, 15,
    slice_bits)} in soft_dtype is read by time rank 0 only. Returns the
    next call's carry (on time rank 0 the stream's tail, received over the
    ring; other time ranks hand back the carry they were given) and this
    rank's outputs: fic_bytes (E_l, T_l * n_groups, group_bytes) and subch
    {id: (E_l, T_l * nb_cifs, frame_bytes)} uint8, whose row r is global
    CIF row t * T_l * nb_cifs + r, logical frame that row - 15 (rows 0-14
    of time rank 0's first call are the deinterleaver's warm-up).

    halo_exchange=False sends nothing: zeros stand in for the halo (the
    seams decode wrong), and at T > 1 for the next call's carry; it
    isolates the exchange's cost.
    """

    def __init__(self, mesh: Mesh, mode: int, subchannels: Tuple[SubchannelConfig, ...],
                 window_offset: int = 12, halo_exchange: bool = True,
                 soft_dtype: str = "bfloat16", device=DEFAULT_DEVICE):
        self.mesh = mesh
        self.mode = mode
        self.subchannels = tuple(subchannels)
        self.window_offset = window_offset
        self.halo_exchange = halo_exchange
        self.soft_dtype = soft_dtype
        self.device = resolve_device(device)
        self.dab = get_dab_params(mode)
        self.n_ens, self.n_time = mesh.shape
        self.e_idx, self.t_idx = mesh.coords
        self.staged = mesh.backend != "nccl"   # gloo: the halo crosses through host memory
        self._steps: Dict[int, ReceiveStep] = {}
        self.last_exchange: Dict[str, float] = {}

    # ---------------- carry ----------------

    def step_for(self, e_l: int) -> ReceiveStep:
        """The single-device ReceiveStep of e_l ensembles on the step's device."""
        if e_l not in self._steps:
            self._steps[e_l] = ReceiveStep(self.mode, self.subchannels, self.window_offset,
                                           n_ensembles=e_l,
                                           soft_dtype=self.soft_dtype).to(self.device)
        return self._steps[e_l]

    def _e_l(self, n_ensembles: int) -> int:
        if n_ensembles % self.n_ens:
            raise ValueError(f"{n_ensembles} ensembles do not split over the mesh's "
                             f"{self.n_ens} ensemble ranks")
        return n_ensembles // self.n_ens

    def init_carry(self, n_ensembles: int) -> Dict[str, torch.Tensor]:
        """Zero history for this rank's share of n_ensembles ensembles."""
        e_l = self._e_l(n_ensembles)
        return {f"deint_{c.subch_id}": torch.zeros(
                    (e_l, _H, c.slice_bits), dtype=self.step_for(e_l).soft_dtype,
                    device=self.device)
                for c in self.subchannels}

    def carry_from_jax(self, carry) -> Dict[str, torch.Tensor]:
        """tpudab's global carry {"deint_<id>": (E, 15, slice_bits)} (numpy,
        f32 or bf16) -> this rank's rows on the step's device, in
        soft_dtype (bit for bit where the dtypes agree)."""
        full = carry_from_jax(carry, "cpu")
        e_l = self._e_l(next(iter(full.values())).shape[0])
        rows = slice(self.e_idx * e_l, (self.e_idx + 1) * e_l)
        dtype = self.step_for(e_l).soft_dtype
        return {k: v[rows].to(self.device, dtype) for k, v in full.items()}

    # ---------------- the step ----------------

    def _demod(self, step: ReceiveStep, re, im, freq) -> torch.Tensor:
        """(E_l, n, rows, 128) frames -> (E_l, n, nb_frame_bits) soft bits."""
        e_l, n = re.shape[:2]
        tile = re.shape[2:]
        soft, _ = demod_frames_split(re.reshape((e_l * n,) + tile), im.reshape((e_l * n,) + tile),
                                     freq.repeat_interleave(n),
                                     (step.dft_re, step.dft_sum, step.dft_diff), self.mode,
                                     self.window_offset, out_dtype=step.soft_dtype)
        return soft.view(e_l, n, -1)

    def _neighbour(self, dt: int) -> int:
        return self.mesh.rank_at(self.e_idx, (self.t_idx + dt) % self.n_time)

    def __call__(self, carry, frames_re, frames_im, freq_hz):
        with span("step", frames_re.shape[0] * frames_re.shape[1], frames_re.device):
            return self._call(carry, frames_re, frames_im, freq_hz)

    def _call(self, carry, frames_re, frames_im, freq_hz):
        dab = self.dab
        e_l, t_l = frames_re.shape[:2]
        if t_l * dab.nb_cifs < _H:
            raise ValueError(f"need >= {-(-_H // dab.nb_cifs)} frames per time shard so the "
                             f"15-CIF deinterleaver halo fits in one neighbour exchange "
                             f"(got {t_l})")
        step = self.step_for(e_l)
        freq = torch.as_tensor(freq_hz, dtype=torch.float32,
                               device=frames_re.device).broadcast_to((e_l,))

        # the trailing edge frames first: they alone make the 15-CIF halo
        edge_f = min(t_l, -(-_H // dab.nb_cifs))
        soft_edge = self._demod(step, frames_re[:, t_l - edge_f:], frames_im[:, t_l - edge_f:],
                                freq)
        cifs_tail = soft_edge[:, :, dab.nb_fic_bits:].reshape(
            e_l, edge_f * dab.nb_cifs, CIF_BITS)[:, -_H:]
        tail_cat = torch.cat([cifs_tail[:, :, c.start_cu * CU_BITS:
                                        c.start_cu * CU_BITS + c.slice_bits]
                              for c in self.subchannels], dim=2)   # ONE message for all

        exchange = self.halo_exchange and self.n_time > 1
        if exchange:
            pending = self.post_halo(tail_cat)

        # the interior while the exchange flows
        if edge_f < t_l:
            soft_int = self._demod(step, frames_re[:, :t_l - edge_f],
                                   frames_im[:, :t_l - edge_f], freq)
            soft = torch.cat([soft_int, soft_edge], dim=1)
        else:
            soft = soft_edge
        soft = soft.reshape(e_l * t_l, -1)

        if exchange:
            ring = self.wait_halo(pending)
        else:
            ring = torch.zeros_like(tail_cat)
        ring = self._split(ring)

        # time rank 0 takes the step-level carry, the others the halo
        hist = carry if self.t_idx == 0 else ring
        lead = (lambda v: v[0]) if e_l == 1 else (lambda v: v)
        step_carry, fic_bytes, subch = step.decode_soft(
            {k: lead(v) for k, v in hist.items()}, soft)
        if self.n_time == 1:
            new_carry = {k: v.reshape((e_l,) + v.shape[-2:]) for k, v in step_carry.items()}
        else:
            new_carry = ring if self.t_idx == 0 else carry
        out = {"fic_bytes": fic_bytes.reshape((e_l, -1) + fic_bytes.shape[-1:]),
               "subch": {k: v.reshape((e_l, -1) + v.shape[-1:]) for k, v in subch.items()}}
        return new_carry, out

    def post_halo(self, tail: torch.Tensor):
        """Send tail to the right time neighbour and post the receive of the
        left one's (copied through host memory on gloo); wait_halo takes
        the handle."""
        t0 = time.perf_counter()
        send = tail.cpu() if self.staged else tail
        recv = torch.empty_like(send)
        stage_s = time.perf_counter() - t0
        group = self.mesh.time_group
        reqs = [dist.isend(send, self._neighbour(1), group=group),
                dist.irecv(recv, self._neighbour(-1), group=group)]
        return send, recv, reqs, stage_s

    def wait_halo(self, pending) -> torch.Tensor:
        """post_halo's receive, on the step's device; records the exchange's
        bytes, staging and wait in last_exchange."""
        send, recv, reqs, stage_s = pending
        t0 = time.perf_counter()
        for r in reqs:
            r.wait()
        t1 = time.perf_counter()
        ring = recv.to(self.device) if self.staged else recv
        t2 = time.perf_counter()
        self.last_exchange = {"halo_bytes": send.numel() * send.element_size(),
                              "stage_ms": 1e3 * (stage_s + t2 - t1),
                              "wait_ms": 1e3 * (t1 - t0)}
        return ring

    def _split(self, cat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(E_l, 15, sum of slice_bits) -> {"deint_<id>": contiguous (E_l, 15,
        slice_bits)}, the subchannels in order."""
        out, col = {}, 0
        for cfg in self.subchannels:
            out[f"deint_{cfg.subch_id}"] = cat[:, :, col:col + cfg.slice_bits].contiguous()
            col += cfg.slice_bits
        return out

    # ---------------- host-facing ----------------

    def shard_inputs(self, frames, freq_hz):
        """frames: complex (E, T, frame_len) host array of the whole mesh,
        freq_hz (E,) -> this rank's (E_l, T_l) block as lane-tiled f32
        re/im (frames_on_device) and its (E_l,) frequencies, on the step's
        device."""
        frames = np.asarray(frames)
        e, t = frames.shape[:2]
        e_l = self._e_l(e)
        if t % self.n_time:
            raise ValueError(f"{t} frames do not split over the mesh's {self.n_time} time ranks")
        t_l = t // self.n_time
        block = frames[self.e_idx * e_l:(self.e_idx + 1) * e_l,
                       self.t_idx * t_l:(self.t_idx + 1) * t_l]
        freq = np.broadcast_to(np.asarray(freq_hz, np.float32), (e,))
        freq = np.array(freq[self.e_idx * e_l:(self.e_idx + 1) * e_l])
        return (*frames_on_device(block, self.device), torch.from_numpy(freq).to(self.device))

    def gather_outputs(self, out) -> Optional[dict]:
        """Every rank's outputs -> on rank 0 the whole mesh's, in tpudab's
        order: fic_bytes (E, T * n_groups, group_bytes) and subch {id: (E,
        T * nb_cifs, frame_bytes)}, each ensemble's rows contiguous in
        time; None on the other ranks. Every rank must call it."""
        first = self.mesh.rank == 0
        n_e, n_t = self.mesh.shape

        def gather(x):
            wire = (x.cpu() if self.staged else x).contiguous()
            parts = [torch.empty_like(wire) for _ in range(n_e * n_t)] if first else None
            dist.gather(wire, parts, dst=0)
            if not first:
                return None
            rows = [torch.cat(parts[e * n_t:(e + 1) * n_t], dim=1) for e in range(n_e)]
            return torch.cat(rows, dim=0).to(self.device)

        fic = gather(out["fic_bytes"])
        subch = {k: gather(v) for k, v in out["subch"].items()}
        return {"fic_bytes": fic, "subch": subch} if first else None

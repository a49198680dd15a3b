#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpudab_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
1. identify the card (torch and CUDA versions, nvidia-smi name and power
   limit); no CUDA device is a failure;
2. build the CUDA kernels from tpudab_torch/csrc/; print ptxas' registers
   and spills of each, the Viterbi decode and traceback kernels' in a table
   (a decode kernel spilling more than PARENT_SPILLS allows fails), K5's
   (more registers or spills than PARENT_K5_REGS fails), and the
   opcode mix of the Viterbi kernels' SASS;
3. hold each kernel against its plain torch twin at the receive step's
   shapes: Viterbi (K1+K2) for the MSC and the FIC batch, bytes equal;
   deinterleave (K4's mode (a), logical rows), exact; carve + rotate (K5)
   with the bf16 sum, bit-equal to carve_rotate_tables_ref and within 1
   bf16 ulp of carve_rotate_ref; the bit-level Viterbi (K1+K3) at the
   host path's three shapes (FIC (64, 774, 4), MSC (64, 3462, 4), UEP
   calibration (260, 3078, 4)), bits equal (K1+K2 and K1+K3 also by their
   device time alone, device_ms, and their host time a launch); K4's mode (a) again as the
   host path runs it, on f32 (79, 108 * 64) and (79, 96 * 64) subchannel
   buffers, exact; and K4's mode (b), soft bits and carry to the Viterbi
   input, bit-equal on the step's MSC group and FIC, timed beside the
   chain of copies and gathers it replaced (unfused_chain); and rtl_sdr's
   raw u8 frames (512 x frame_len x 2, random bytes): K5's and
   stats_kernel's u8 instantiations bit-equal to carve_rotate_tables_ref
   and stats_ref on the same frames, each timed beside its bound (a 2-byte
   read a sample); and the wideband channeliser at the hackrf8 cell's
   shapes (4 receivers' s8 streams of 16 frames -> 32 ensembles' bf16
   frames): within a bf16 ulp of channelise_tables_ref and a relative RMS
   of 1.5e-3 of channelise_ref, timed beside its bound and the plain path,
   and launched once a step by a wideband ReceiveStep;
4. run the receive step at the bench's size (mode I, six 108-CU EEP 3-A
   subchannels, 32 ensembles x 16 frames per step, bf16 IQ) over three
   chained steps of a synthesised signal: every FIB CRC must pass, the
   known payload of subchannel 1 must come out byte for byte, every
   kernel's launch count must rise (K4's mode (b) once per subchannel and
   once for the FIC in each step, mode (a) never), and ensemble 0's first
   step must equal the same step run on the CPU through the plain twins;
   then one step of the same signal as rtl_sdr's u8 (each rail's RMS 32
   LSB) fed from 32 pinned host regions through a HostFeed: K5 and
   stats_kernel launched once each (counts set to 0 just before),
   E x F x 2 x frame_len bytes copied, every FIB CRC passing, subchannel
   1's payload byte for byte, and the same bytes as the step on the f32
   frames (x - 127.5) / 128;
5. time the step and each kernel beside its plain twin with CUDA events
   (K4 and K5, shorter than their wrappers' host work, also alone by the
   profiler's device time: kernel_ms);
6. trace three more steps with torch.profiler, recording device activity
   only: device time by kernel, and the device's idle share in the
   CUDA-event window of those steps; then the FEC half alone, which must
   hold no gather, index_select or cat kernel;
7. the host per-stage path (Receiver, the path behind decode-bits) on one
   full multiplex: six 108-CU EEP 3-A DAB+ services and one UEP 128 kbps
   PL3 MP2-type service (744 of 864 CU), 64 frames of f32 soft bits
   (1 - 2b + N(0, 0.5^2)) in batches of 16. Gate: every FIB CRC passes;
   the database holds the ensemble, 7 services and 7 subchannels; the UEP
   calibration locks the shipped table; every DAB+ AU comes out byte-equal
   with Fire code, RS and AU CRC ok; the UEP subchannel's frames equal its
   payload; K3 and K4 were launched; the CPU Receiver (plain twins) gives
   identical outputs. Prints wall seconds per batch, the real-time factor
   and the device busy time over a traced rerun's wall window;
8. the kernel-experiment tools (tpudab_torch/tools/, the port of tpudab's
   tools/exp_*.py, X1-X7) at their own shapes (B = 6144 codewords of 3456
   bits, chunk 32; X6 at 6144 x 6912 punctured bf16; X7 at 256 frames):
   every forward variant and traceback mode equal to its plain twin on the
   first 128 codewords; full, prefetch, dbuf and gmm4 (X1's wide) equal to
   full on the whole batch; int16 (X3) equal to f32 full from the second
   group on; fwd_t + shuffle traceback (X6) equal to the fused K1+K2; the
   three traceback modes (X5) equal; every int16 probe op (X4) equal to
   torch, at the tools' (64, 256) and at a ragged, unaligned shape; the
   carve ablations (X7, instantiations of K5's body) bit-equal to their
   twins, the three that roll and rotate also to K5, no-rotate also to
   torch's .to(bfloat16) of the windows (its library yardstick, timed in
   the same run). Prints each kernel's ms, plain ms and bound (the
   traceback modes, each X4 op and each carve ablation also by their
   device time alone, device_ms, X4 beside torch.add's call in the same run, and
   the host cost of each part of a ctypes launch); then runs each tool's main as
   `python -m tpudab_torch.tools.<name>` would (the Viterbi decomposition
   among them), with the launch counts set to 0 before and read after;
9. the decode path (`python -m tpudab_torch.host.cli decode`) on the
   bench multiplex with DAB+ streams, 48 frames, impaired (CFO 3,400 Hz,
   7,777 samples of delay, 15 dB, one echo): acquisition on the card
   (frame start and coarse bins as made, and equal to the port's numpy
   oracle acquire_np's on the same four frames, the net frequency within
   ORACLE_HZ of the oracle's; B = 1 and B = 32 timed); the step
   leg's kernels at its shapes (E = 1, F = 16, f32 frames) beside their
   twins on a batch of the capture; `info`; the decode with and without
   --device-step, untraced in the order step, host, host, step for the
   walls, and traced once each for the device busy time. Gate: FIB CRC
   1.0, subchannel 1's AUs byte-equal to the payload, every run's payload
   files identical, the step leg launching all five kernels and the host
   leg K1+K3, K4 (a) and K5 alone; then a --checkpoint run and a --resume
   run whose AUs, concatenated, equal the one-shot run's;
10. the live loop (`stream`, tpudab_torch.host.streaming.StreamingRadio)
   on phase 9's capture, written as an f32 file and read by the port's
   native IQReader, batches of 4 frames. First each tracking tap of
   ofdm/sync_device.py alone (its ms a call; this also builds its cuFFT
   plans) and the step's kernels at F = 4 beside their twins, as in phase
   9; then on the device step (the default on the card) and on the host
   path, untraced in the order step, host, host, step for the walls and
   traced once each for the device busy share; the first host run keeps
   the first input of each shape that K1+K3 and K4 (a) get, and these are
   held against viterbi_decode_ref and deinterleave_ref. Gate, on every
   run: FIB CRC 1.0 and no reacquisition; each subchannel's AUs are the
   payload's, in order, from the first that decodes on; all runs
   byte-equal; the step built on the step path only; K1+K2, K4 (b) and K5
   launched on the step path, K1+K3, K4 (a) and K5 on the host path, the
   same in each run. Prints each path's walls, real-time factors,
   StageTimer summaries and track stage a batch. Then `python -m tpudab_torch.host.cli
   stream CAP --no-dashboard --wav mix.wav` must exit 0 with one mix block
   a batch; and the codec probe's line: where it finds FFmpeg, `stream` of
   a capture whose DAB+ service carries AAC of a tone (the port's encoder)
   on each path must write equal WAVs with an RMS above CODEC_RMS_FLOOR;
   where it does not, the WAV above must be silence;
11. the sharded step (tpudab_torch.parallel.ShardedReceiveStep) at the
   bench multiplex's full width: (a) in this process, a world of 1 on NCCL
   (its version printed), mesh (1, 1), E = 32 x F = 16 f32 frames, gated
   on FIB CRC 1.0, subchannel 1's payload and every byte equal to a
   ReceiveStep on the same frames, both timed with CUDA events in turns
   (ms a step, real-time factor, the extra K5 launch of the split demod);
   (b) two spawned processes on cuda:0 joined by gloo, the halo staged
   through host memory, mesh (1, 2), E = 32, 8 frames a rank, two chained
   calls: the gathered outputs byte-equal to ReceiveStep over the same
   frames in the same calls, the seam rows included; the halo's bytes and
   each exchange's staging and wait ms; rank 1 holds K5, K4 mode (b) (its
   carry the halo) and K1+K2 on the first inputs the step gave them
   bit-equal to their twins. A check of the protocol, not of scaling;
12. `python -m tpudab_torch.host.cli stream --tcp HOST:PORT --channel 12C
   --no-dashboard` in this process on each path (the device step, then
   --no-device-step) against the port's RtlTcpServer, which serves phase
   9's capture on 12C and a second ensemble on 12D at a dongle's real-time
   rate; after TCP_RETUNE_FRAMES frames the key controller presses '>'
   (StreamingRadio.retune to 12D). Gate, on each path: FIB CRC 1.0 on each
   channel and no reacquisition on 12C, each subchannel's AUs the
   payload's in order on each channel, the database on the second
   ensemble after the retune, the path's kernels launched; 12C's frames
   and AUs byte-equal between the paths. Prints the stream's real-time
   factor, the client ring's lag and the retune's wall. Then `synth` where
   the codec probe finds FFmpeg (its verdict printed either way);
13. `python -m tpudab_torch.host.cli decode` on a packet-mode multiplex
   synthesised by the port alone (packet_mux_spec: phase 9's layout and
   DAB+ streams on subchannels 1-5, a packet-mode MOT slideshow on
   subchannel 6 carrying an 8 KB image round and round, an FM link on
   service 1 and a DRM link on service 2), 48 frames through phase 9's
   impairments, once with and once without --device-step. Gate, on each
   leg: acquisition held to acquire_np as in phase 9, FIB CRC 1.0, the
   slide file byte-equal to the MOT body, subchannel 1's AUs the
   payload's, the legs' files identical, the legs' launches as in phase
   9; then an in-process OfflinePipeline on the card: the packet
   component's SCId on subchannel 6 with DSCTy 60 and packet address 2,
   the FM and DRM services with their frequencies in the database, and
   their lines in host.dashboard.render_text;
14. the step's measurement tools (the port of tpudab's
   tools/profile_step3.py, exp_step_shapes.py, exp_demod_output.py,
   exp_conv_demod.py, exp_aligned_demod.py, exp_viterbi_params.py and
   exp_viterbi_sweep.py), each through its main as `python -m
   tpudab_torch.tools.<name>` runs it, at its own shapes: the in-step
   breakdown at E x F = 16 x 16 and 32 x 16 (stage 3's MSC bytes equal
   the step's), the six step shapes (every one must run), the demod's
   output variants (norm parts within 1 bf16 ulp of the demod), the
   products on a strided view of the rotated frame (and whether
   torch.matmul copies the view), the row-aligned windows (sign match),
   the Viterbi chain at the bench's batch (bytes equal to the plain twin
   on the first codewords). Every check must hold, and K5, K4 mode (b)
   and K1+K2 must be launched, with the launch counts set to 0 before and
   read after;
15. the port's bench.py and bench_scaling.py (tpudab_torch/tools/bench.py,
   bench_scaling.py), each as `python -m` runs it: the bench at E = 32 x
   F = 16 bf16 behind bench.py's gate (FIB CRC, subchannel 1's payload)
   and the Viterbi's twin check, with bench.py's keys, RTF and Mbit/s above
   0, printed beside phase 5's CUDA-event step; its run() once in process,
   which must launch K5, K4 mode (b) and K1+K2 (counts set to 0 before and
   read after); then the weak-scaling sweep with one trial: rows for 1, 2,
   4 and 8 ranks and the summary, each size on NCCL where its ranks have
   a card each, else on gloo and oversubscribed (one card: a check of the
   protocol and its overhead, not of scaling).
Each phase from 9 on prints its seconds.
Every line with a device time carries the card's name and power limit. A
bound is the least time the card could take for the work: the larger of
its bytes over the HBM rate and its operations over the ALU rate (see
HBM_BYTES_PER_S).
The line before the last is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Exits non-zero without it on any failure.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpudab_torch.constants.channels import channel_freq_hz
from tpudab_torch.constants.dab_params import CU_BITS, get_dab_params
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.constants.puncture import FIC_PROFILE, eep_profile, get_uep_profile
from tpudab_torch.fec.conv import conv_encode
from tpudab_torch.fec.crc import check_fib_crc
from tpudab_torch.fec.depuncture import (depuncture_index, depuncture_np, depuncture_t,
                                         puncture)
from tpudab_torch.host.cli import main as cli_main
from tpudab_torch.models.ingest import HostFeed
from tpudab_torch.models.receiver import Receiver
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.msc.interleave import (SoftRows, deinterleave_cuda,
                                         deinterleave_depuncture_t_cuda,
                                         deinterleave_depuncture_t_ref, deinterleave_ref,
                                         interleave_delays)
from tpudab_torch.msc.subchannel import subch_cif_slices
from tpudab_torch.ofdm import demod as demod_mod
from tpudab_torch.ofdm.demod import demod_frames_split
from tpudab_torch.ofdm.sync_device import acquire_device, acquire_host
from tpudab_torch.ofdm.sync_np import acquire_np
from tpudab_torch.ops import _build, demod_tail
from tpudab_torch.ops.carve import (_windows, carve_rotate_cuda, carve_rotate_ref,
                                   carve_rotate_tables_ref, rotator_tables, u8_frames_at)
from tpudab_torch.ops.carve_exp import carve_variant_cuda, carve_variant_ref
from tpudab_torch.ops.i16_probe import OPS as I16_OPS
from tpudab_torch.ops.i16_probe import i16_probe_cuda, i16_probe_ref
from tpudab_torch.ops.viterbi import branch_metric_table, mother_to_t, radix_tables
from tpudab_torch.ops.viterbi_cuda import (BFLY4_LAYOUT, K12_LAYOUTS, k12_layout,
                                           k12_resident_blocks, kernel_table_on, signs_on,
                                           sm_count_of, viterbi_decode_bits_cuda,
                                           viterbi_decode_bytes_t_cuda,
                                           viterbi_decode_bytes_t_ref, viterbi_decode_ref)
from tpudab_torch.ops.viterbi_exp import (fwd_variant_cuda, fwd_variant_ref, traceback_bytes_cuda,
                                          traceback_bytes_ref, traceback_maps_ref)
from tpudab_torch.synth import (ASCTY_DAB, ASCTY_DAB_PLUS, TMID_PACKET_DATA, EnsembleSpec,
                                EnsembleSynthesizer, Impairments, ServiceSpec, SubchannelSpec,
                                apply_impairments, modulate_frame_bits)
from tpudab_torch.synth.ensemble import DRMLinkSpec, FMLinkSpec
from tpudab_torch.synth.payload import dabplus_stream
from tpudab_torch.tools import bench as bench_tool
from tpudab_torch.tools import (exp_aligned_demod, exp_carve, exp_conv_demod, exp_demod_output,
                                exp_depunct_t, exp_i16_probe, exp_step_shapes, exp_tb_tree,
                                exp_viterbi, exp_viterbi_decompose, exp_viterbi_i16,
                                exp_viterbi_params, exp_viterbi_sweep, profile_step3)
from tpudab_torch.tools._common import card as card_name
from tpudab_torch.tools.bench import bench_capture, bench_subchannels
from tpudab_torch.tools.launch_multihost import free_port
from tpudab_torch.tools._common import timer

ROOT = Path(__file__).resolve().parent
N_ENS, N_FRAMES, N_STEPS = 32, 16, 3
SEED = 0
KERNELS = {  # name -> (source, replaced TPU kernel, wrapper)
    "viterbi_fwd_traceback": ("tpudab_torch/csrc/viterbi.cu",
                              "tpudab/ops/viterbi_pallas.py:60",
                              viterbi_decode_bytes_t_cuda),
    "viterbi_bits": ("tpudab_torch/csrc/viterbi.cu",
                     "tpudab/ops/viterbi_pallas.py:153", viterbi_decode_bits_cuda),
    "deinterleave": ("tpudab_torch/csrc/deinterleave.cu",
                     "tpudab/msc/interleave.py:97", deinterleave_cuda),
    "deinterleave_depuncture_t": ("tpudab_torch/csrc/deinterleave.cu",
                                  "tpudab/msc/interleave.py:97",
                                  deinterleave_depuncture_t_cuda),
    "carve_rotate": ("tpudab_torch/csrc/carve.cu", "tpudab/ops/carve.py:96",
                     carve_rotate_cuda),
    "viterbi_fwd_variant": ("tpudab_torch/csrc/viterbi.cu",
                            "tools/exp_viterbi_decompose.py:42", fwd_variant_cuda),
    "viterbi_traceback": ("tpudab_torch/csrc/viterbi.cu", "tools/exp_tb_tree.py:42",
                          traceback_bytes_cuda),
    "i16_probe": ("tpudab_torch/csrc/i16_probe.cu", "tools/exp_i16_probe.py:7", i16_probe_cuda),
    "carve_variant": ("tpudab_torch/csrc/carve.cu", "tools/exp_carve.py:33",
                      carve_variant_cuda),
}
ALSO_REPLACES = {   # the other TPU kernels each wrapper's kernel stands for
    "viterbi_fwd_traceback": ["tpudab/ops/viterbi_pallas.py:124"],
    "viterbi_fwd_variant": ["tools/exp_viterbi_decompose.py:103",
                            "tools/exp_viterbi_decompose.py:154",
                            "tools/exp_viterbi_decompose.py:202", "tools/exp_viterbi.py:35",
                            "tools/exp_viterbi_i16.py:45", "tools/exp_depunct_t.py:42"],
    "viterbi_traceback": ["tools/exp_tb_tree.py:14", "tools/exp_viterbi_decompose.py:406",
                          "tools/exp_depunct_t.py:68"],
}
# the XLA index maps (not Pallas kernels) that K4's mode (b) also takes in
FUSES = {"deinterleave_depuncture_t": ["tpudab/models/step.py:139-170",
                                       "tpudab/fec/depuncture.py:96"]}
STEP_KERNELS = ("viterbi_fwd_traceback", "deinterleave_depuncture_t", "carve_rotate")
HOST_KERNELS = ("viterbi_bits", "deinterleave")
TOOL_KERNELS = ("viterbi_fwd_variant", "viterbi_traceback", "i16_probe", "carve_variant")
TOOLS = (exp_viterbi_decompose, exp_viterbi, exp_viterbi_i16, exp_tb_tree, exp_depunct_t,
         exp_i16_probe, exp_carve)
# phase 14: the step's measurement tools and the kernels they launch
STEP_TOOLS = (profile_step3, exp_step_shapes, exp_demod_output, exp_conv_demod,
              exp_aligned_demod, exp_viterbi_params, exp_viterbi_sweep)
HOST_FRAMES, HOST_BATCH, HOST_SIGMA = 64, 16, 0.5
HOST_UEP = (7, 648, 96, 128, 3)   # subch id, start CU, size CU, kbps, protection level
# phase 9: the decode path on an impaired capture of the bench multiplex
DECODE_FRAMES, DECODE_BATCH, DECODE_SPLIT, ACQ_BATCH, ACQ_STRIDE = 48, 16, 20, 32, 6000
DECODE_IMP = {"freq_offset_hz": 3400.0, "delay_samples": 7777, "snr_db": 15.0,
              "multipath": ((300, 0.4, 1.1),), "seed": 9}   # echo inside the 504-sample guard
ORACLE_HZ = 1.0   # acquire_host's net frequency against acquire_np's (tests/test_torch_sync.py)
# phase 13: phase 9's multiplex with subchannel 6 a packet-mode MOT slideshow
# (DSCTy 60, PACKET_LEN-byte packets at PACKET_ADDR, PACKETS_PER_FRAME a
# logical frame and 24-byte padding packets after them) carrying one
# SLIDE_BYTES image in a carousel, an FM link on service 1 and a DRM link
# on service 2 (tests/test_host_wiring.py:216-224's PI, id and frequencies)
PACKET_SUBCH, PACKET_DSCTY, PACKET_LEN, PACKET_ADDR, PACKETS_PER_FRAME = 6, 60, 96, 2, 4
SLIDE_BYTES, SLIDE_SEGMENT, SLIDE_NAME = 8192, 512, "slide.png"
FM_LINK = (0xC201, 0xC479, [95_800_000])    # service id, RDS PI, frequencies (Hz)
DRM_LINK = (0xC202, 0x00A7, [6_095_000])    # service id, DRM id, frequencies (Hz)
# phase 10: the live loop (StreamingRadio) on phase 9's capture, and a short
# capture whose DAB+ service carries AAC of a tone (96 kbps EEP 3-A, 72 CU)
STREAM_BATCH, CODEC_FRAMES, CODEC_RMS_FLOOR = 4, 16, 2000.0   # floor: int16 RMS of the WAV
STREAM_PATHS = {"step": ({}, []), "host": ({"use_device_step": False}, ["--no-device-step"])}
STREAM_KERNELS = {"step": ("viterbi_fwd_traceback", "deinterleave_depuncture_t", "carve_rotate"),
                  "host": ("viterbi_bits", "deinterleave", "carve_rotate")}
# phase 11: the sharded step. (b): SHARD_RANKS processes on cuda:0 joined by
# gloo, mesh (1, SHARD_RANKS), SHARD_FRAMES frames a rank a call, two calls
SHARD_RANKS, SHARD_FRAMES, SHARD_CALLS, SHARD_TIMEOUT_S = 2, 8, 2, 600
# phase 12: `stream --tcp`: phase 9's capture on 12C, a second ensemble on
# 12D (one 96 kbps DAB+ service, TCP_FRAMES_D frames), served at TCP_PACE
# times real time (a dongle's rate); the retune after TCP_RETUNE_FRAMES
# frames of 12C, the stop after TCP_D_BATCHES batches with the second
# ensemble in the database (TCP_MAX_POLLS at most)
TCP_FRAMES_D, TCP_RETUNE_FRAMES, TCP_D_BATCHES, TCP_MAX_POLLS = 64, 24, 3, 60
TCP_PACE = 1.0
TCP_EID_D = 0xD12D
# phase 15: the port's bench.py and bench_scaling.py, each a subprocess with
# this time limit (s); the sweep's sizes
BENCH_TIMEOUT_S, SCALING_TIMEOUT_S = 300, 600
SCALING_SIZES = [1, 2, 4, 8]
# wrapper -> the kernel whose ptxas resources its kernels line carries
PTXAS_OF = {"viterbi_fwd_traceback": "viterbi_kernel<", "viterbi_bits": "viterbi_bits_kernel<",
            "viterbi_traceback": "viterbi_traceback_kernel<"}
DECODE_KERNELS = ("viterbi_bits", "deinterleave", "carve_rotate", "deinterleave_depuncture_t",
                  "viterbi_fwd_traceback")

# Bounds: the least time the card could take for a kernel's work, the
# larger of its bytes (each input read once, each output written once) over
# the HBM rate and its operations over the ALU rate (H100 SXM, NVIDIA's
# data sheet: 3.35 TB/s; 67 TFLOP/s of f32 counts an FMA as 2, so 33.5e12
# simple f32 ops/s, used for the integer ops too).
HBM_BYTES_PER_S, ALU_OPS_PER_S = 3.35e12, 33.5e12
# the channeliser's operations run on the tensor cores: its bound takes
# their dense f16 rate (the data sheet's 989.4 TFLOP/s), as ddc_roofline
# does; the hackrf8 cell's receivers
DDC_TENSOR_OPS_PER_S = 989.4e12
DDC_CENTRES = (181e6, 195e6, 209e6, 223e6)


def prefix_tree_adds() -> int:
    """Adds per super-step of the branch metrics: the 256 super-transitions
    have 32 distinct sums up to sign (branch_metric_table), and the kernels
    must stay bit-equal to their twins, whose sums run in index order
    ((s0 x0 + s1 x1) + ...) + s7 x7. So the least work is one add per
    distinct index-order prefix of length 2..8 of those 32 sign patterns
    (the prefix tree's levels: 2, 4, 4, 8, 16, 32, 32 for DAB's code)."""
    pats = branch_metric_table(torch.from_numpy(radix_tables()[0]))[0].tolist()
    return sum(len({tuple(p[:k]) for p in pats}) for k in range(2, 9))


# Simple ops per radix-2 super-step and codeword (64 states, 256
# super-transitions). Branch metrics: the prefix tree's adds (98; a negated
# metric is folded into the add of the path metric). ACS: per state 4 adds,
# 3 compares, 3 selects. Decisions: per state the 2-bit index and its
# packing (4 ops). noacs: the branch metrics and, per state, a compare and
# its packing (3 ops) and the running max that keeps j = 2, 3 (2 ops).
# Traceback: per super-step select, extract, pack, shift (4 ops).
BM_OPS, ACS_OPS, DEC_OPS, TB_OPS = prefix_tree_adds(), 64 * 10, 64 * 4, 4
FWD_OPS = {"full": BM_OPS + ACS_OPS + DEC_OPS, "nodec": BM_OPS + ACS_OPS,
           "noacs": BM_OPS + 64 * 5}
FWD_OPS.update(prefetch=FWD_OPS["full"], dbuf=FWD_OPS["full"], gmm4=FWD_OPS["full"],
               bmonly=FWD_OPS["noacs"])
# The serial bound of one codeword: per super-step the dependent chain
# add -> compare -> select -> compare -> select, 4 cycles each at the
# H100 SXM's 1.98 GHz boost clock.
SERIAL_STEP_S = 5 * 4 / 1.98e9
# The chain of the traceback before its group maps: per
# super-step its TB_OPS ops, each on the last one's result. Not a bound of
# the map design, whose chain is one pick per 4 super-steps: printed as the
# old chain's figure only.
TB_SERIAL_STEP_S = TB_OPS * 4 / 1.98e9
# Spill stores (bytes) of each decode kernel before the traceback's group
# maps (ptxas -v, the same flags): none may spill more.
PARENT_SPILLS = {"viterbi_kernel": 4, "viterbi_bits_kernel": 0}
# K5's registers before X7 shared its body (ptxas -v, the same flags; no
# spills): the body's templating must not cost K5 any.
PARENT_K5_REGS = {"carve_kernel<f32>": 64, "carve_kernel<bf16>": 48}
SECTOR = 32       # bytes: the least a load from device memory moves
CARVE_OPS = 12    # per output sample: rotator by angle addition (6), rotation (6)

EXP_B, EXP_BITS, EXP_CHUNK, TWIN_B = 6144, 3456, 32, 128   # the Viterbi tools' shapes
EXP_FRAMES = 256                                            # exp_carve's frames
CARVE_VARIANTS = (("fb4", 4, True, True), ("fb8", 8, True, True), ("fb16", 16, True, True),
                  ("noroll", 8, False, True), ("norotate", 8, True, False),
                  ("copy", 8, False, False))              # exp_carve's: label, fb, roll, rotate


cuda_ms = timer(torch.device("cuda", 0))   # cuda_ms(fn, reps): mean device ms after a warm-up


def kernel_ms(fn, reps: int, name: str) -> float:
    """Mean device ms per fn() call of the kernels whose name holds `name`,
    from a torch.profiler trace of reps calls after a warm-up: the kernel
    alone. cuda_ms brackets the whole call, so where a kernel is shorter
    than its wrapper's host work it measures the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(3):   # a trace that recorded nothing is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(k.self_device_time_total for k in prof.key_averages()
                    if k.device_type == DeviceType.CUDA and name in k.key)
        if total > 0:
            break
    require(total > 0, f"the profiler recorded no device time for {name} in 3 traces")
    return total / 1e3 / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms per fn() call without the host's part: the calls are
    queued behind a spin kernel (torch.cuda._sleep, ~2.5 ms) that outlasts
    their enqueue, so the CUDA events around them time the device alone
    (the kernels and the gaps between back-to-back launches). Phase 8 uses
    it in phases 3 and 8, where the profiler recorded part of the launches
    or none in some runs (kernel_ms)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host microseconds per fn() call: the host clock over reps calls
    issued back to back after a warm-up, synchronised after the clock
    stops (the device's queue takes them without making the host wait)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / reps


def bound(n_bytes: float, n_ops: float):
    """(least ms, "bytes" or "operations"): see HBM_BYTES_PER_S."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def carve_bound(frames: torch.Tensor, out: torch.Tensor, rotate: bool = True, n_out: int = 2):
    """Bound of a carve kernel: the re and im samples of the windows in (F x
    n_sym x n_fft each; the null symbol and the cyclic prefixes are never
    read), the f32 rotator tables (F x (n_sym + n_fft) x 2) when it
    rotates, n_out bf16 windows out (re, im and, for K5 in the step, their
    sum)."""
    p = get_ofdm_params(1)
    tables = frames.shape[0] * (p.nb_symbols + p.nb_fft) * 2 * 4 if rotate else 0
    return bound(2 * out.numel() * frames.element_size() + tables + n_out * out.numel() * 2,
                 out.numel() * (CARVE_OPS + (n_out == 3)) if rotate else 0)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def bf16_ulp_err(xr, xi, rr, ri) -> float:
    """Largest |kernel - plain| of a rotated IQ pair in units of the bf16
    ulp at the pair's magnitude, compared in f32. The rotation keeps
    |x|, and the two versions round the f32 phase differently, so a
    component near zero may differ by far more than its own ulp."""
    xr, xi, rr, ri = xr.float(), xi.float(), rr.float(), ri.float()
    mag = torch.maximum(torch.hypot(xr, xi), torch.hypot(rr, ri))
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    err = torch.maximum((xr - rr).abs(), (xi - ri).abs())
    return (err / ulp).max().item()


def identify() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA GPU")
    card = card_name(torch.device("cuda", 0))
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"card: {card}")
    # tpudab's dots accumulate in f32 and round once to bf16; keep cuBLAS
    # from reducing split-K partial sums in bf16 (and f32 products in TF32)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build() -> tuple:
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.BuildInfo.seconds:.2f} s)"
          f" -> {_build.BuildInfo.path}")
    for line in _build.BuildInfo.log.splitlines():   # each kernel's name, then its resources
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    resources = ptxas_resources(_build.BuildInfo.log)
    for label, (regs, spill, smem) in resources.items():
        print(f"  resources {label}: {regs} registers, {spill} bytes spill stores, {smem} bytes smem")
    sass = sass_mix()
    n_viterbi = 2 * len(K12_LAYOUTS) + 2 + 3
    require(len(resources) == n_viterbi + 3, f"ptxas reported {len(resources)} of the "
            f"{n_viterbi} Viterbi decode and traceback kernels and K5's 3: {sorted(resources)}")
    for label, regs in PARENT_K5_REGS.items():
        require(resources[label][0] <= regs and resources[label][1] == 0,
                f"{label}: {resources[label][0]} registers, {resources[label][1]} bytes spill "
                f"stores; before X7 shared its body, {regs} and 0")
    for label, (_, spill, _) in resources.items():
        kernel = label.split("<")[0]
        require(spill <= PARENT_SPILLS.get(kernel, spill),
                f"{label} spills {spill} bytes; before the group maps it spilled "
                f"{PARENT_SPILLS.get(kernel)}")
    check_bfly4(resources, sass)
    return resources, sass


def check_bfly4(resources: dict, sass: dict) -> None:
    """The four-butterfly layout at the MSC's batch: its registers and
    spills, the codewords one wave holds on this card (the occupancy
    calculator's resident blocks of 16), and its inner loop's SASS a
    codeword and super-step; no spills, one wave and at most
    BFLY4_SASS_MAX instructions, or it fails."""
    label = "viterbi_kernel<bf16, bfly4>"
    regs, spill, _ = resources[label]
    b, sms = 6 * N_ENS * 4 * N_FRAMES, sm_count_of(0)
    blocks = k12_resident_blocks(BFLY4_LAYOUT, True)
    wave = blocks * 16 * sms
    per_cw = sass.get(label, {}).get("per_codeword")
    print(f"  {label}: {regs} registers, {spill} bytes spill stores; {blocks} blocks of 16 "
          f"codewords resident an SM, {wave} codewords a wave on {sms} SMs: the MSC's {b} in "
          f"{-(-b // wave)} wave(s); inner loop "
          + (f"{per_cw:.2f}" if per_cw is not None else "not measured")
          + " SASS instructions a codeword and super-step")
    require(spill == 0, f"{label} spills {spill} bytes")
    require(b <= wave, f"{label}: the MSC's {b} codewords take {-(-b // wave)} waves")
    require(per_cw is None or per_cw <= BFLY4_SASS_MAX,
            f"{label}: {per_cw} SASS instructions a codeword and super-step, over "
            f"{BFLY4_SASS_MAX}")


def ptxas_resources(log: str) -> dict:
    """{label: (registers, spill store bytes, static shared bytes)} of the
    Viterbi decode kernels (viterbi_kernel in f32 and bf16, each in its
    layouts, K12_LAYOUTS; viterbi_bits_kernel in f32 and bf16), the
    traceback kernel's three modes and K5 (carve_kernel, f32, bf16 and
    u8), from ptxas' -v report."""
    out, label = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d(viterbi_kernel|viterbi_bits_kernel|viterbi_traceback_kernel|"
                          r"carve_kernel)I(\w+)", m.group(1))
            label = None
            if k:
                arg = k.group(2)
                tag = ("shuffle", "masked", "tree")[int(arg[2])] if arg.startswith("Li") \
                    else "bf16" if arg.startswith("13__nv_bfloat16") \
                    else "u8" if arg.startswith("hE") else "f32"
                layout = re.match(r"(?:f|13__nv_bfloat16)Li(\d+)E", arg) \
                    if k.group(1) == "viterbi_kernel" else None
                if layout:
                    tag += ", " + K12_LAYOUTS[int(layout.group(1))]
                label = f"{k.group(1)}<{tag}>"
                out[label] = [0, 0, 0]
            continue
        if label is None:
            continue
        for pattern, slot in ((r"Used (\d+) registers", 0), (r"(\d+) bytes spill stores", 1),
                              (r"(\d+) bytes smem", 2)):
            m = re.search(pattern, line)
            if m:
                out[label][slot] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


SASS_KERNELS = {**{f"viterbi_kernel<bf16, {name}>": rf"viterbi_kernelI13__nv_bfloat16Li{layout}E"
                   for layout, name in K12_LAYOUTS.items()},
                "viterbi_bits_kernel<f32>": r"viterbi_bits_kernelIf",
                "viterbi_traceback_kernel<shuffle>": r"viterbi_traceback_kernelILi0E",
                "forward full f32 rebase 32": r"variant_kernelIfNS_9F32MetricELi0ELi32"}
# codewords a warp of each viterbi_kernel layout advances together, and the
# super-steps of its inner loop (forward_acs: a group of 4;
# forward_butterflies: BflyMap::kSteps, 8 for two butterflies, 4 for four)
K12_CODEWORDS_PER_WARP = {"viterbi_kernel<bf16, warp>": 1, "viterbi_kernel<bf16, bfly>": 4,
                          "viterbi_kernel<bf16, bfly4>": 8}
K12_LOOP_STEPS = {"viterbi_kernel<bf16, warp>": 4, "viterbi_kernel<bf16, bfly>": 8,
                  "viterbi_kernel<bf16, bfly4>": 4}
# the four-butterfly layout at the MSC's batch (12288 codewords at T2p 1744
# on 132 SMs): one wave, no spills, and at most this many SASS instructions
# a codeword and super-step in its inner loop
BFLY4_SASS_MAX = 37.0
SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)([^;]*);")


def inner_loop(part: str):
    """(instructions, opcode counts) of a function's inner loop of
    super-steps: the shortest loop (a backward branch) that holds 48 FFMA
    or more (the traceback's loops hold none)."""
    ops = [(int(m.group(1), 16), m.group(2).split(".")[0], m.group(3))
           for m in SASS_OP.finditer(part)]
    addr = [a for a, _, _ in ops]
    best = None
    for i, (a, op, rest) in enumerate(ops):
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
            body = ops[addr.index(int(m.group(1), 16)): i + 1]
            if sum(o == "FFMA" for _, o, _ in body) >= 48 \
                    and (best is None or len(body) < len(best)):
                best = body
    return (len(best), collections.Counter(o for _, o, _ in best)) if best else (0, {})


def sass_mix() -> dict:
    """Opcode counts of the Viterbi kernels' machine code (cuobjdump -sass
    of the built library), whole functions: where the instructions go,
    for cards where a profiler of issue stalls (ncu) cannot run. For
    viterbi_kernel's layouts also the inner loop's instructions a
    super-step: a warp's, and a codeword's (a warp's over its codewords).
    Returns {label: {"per_warp": .., "per_codeword": ..}}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: not measured (no cuobjdump)")
        return {}
    sass = subprocess.run([tool, "-sass", _build.BuildInfo.path], capture_output=True,
                          text=True, timeout=300).stdout
    integer = ("IMAD", "LEA", "SHF", "LOP3", "IADD3", "VIADD", "SEL", "ISETP")
    per_step = {}
    for label, pattern in SASS_KERNELS.items():
        for part in sass.split("Function : ")[1:]:
            if re.search(pattern, part.split("\n", 1)[0]):
                ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", part))
                print(f"  sass {label}: {sum(ops.values())} instructions; "
                      + ", ".join(f"{op} {ops[op]}" for op in
                                  ("FFMA", "FADD", "FSETP", "FSEL", "FMNMX", "SEL", "SHFL", "LDS",
                                   "STS", "BAR"))
                      + f", integer {sum(ops[op] for op in integer)}")
                if label in K12_CODEWORDS_PER_WARP:
                    n, group = inner_loop(part)
                    steps = K12_LOOP_STEPS[label]
                    per_step[label] = {"per_warp": n / steps,
                                       "per_codeword": n / steps / K12_CODEWORDS_PER_WARP[label],
                                       "loop": dict(group.most_common(12))}
                    print(f"  sass {label} inner loop of {steps} super-steps: {n} instructions, "
                          f"{n / steps:.2f} a warp and super-step, "
                          f"{n / steps / K12_CODEWORDS_PER_WARP[label]:.2f} a codeword "
                          f"({dict(group.most_common(12))})")
    return per_step


def k12_entry(soft_t: torch.Tensor, n_data_bits: int, layout: int) -> torch.Tensor:
    """K1+K2 on soft_t (T2p, 8, B) through its C entry in the given layout
    (the wrapper takes k12_layout's) -> (B, n_data_bits // 8) uint8."""
    t2p, _, b = soft_t.shape
    dec = torch.empty((b, t2p // 4, 64), dtype=torch.uint8, device=soft_t.device)
    out = torch.empty((b, n_data_bits // 8), dtype=torch.uint8, device=soft_t.device)
    _build.launch(_build.load_library().tpudab_viterbi_decode_bytes_t, soft_t.get_device(),
                  "viterbi", soft_t.data_ptr(), int(soft_t.dtype == torch.bfloat16),
                  kernel_table_on(soft_t.device).data_ptr(), dec.data_ptr(), out.data_ptr(), t2p,
                  b, n_data_bits // 8, layout)
    return out


def check_kernels(dev, rng, card: str):
    """Phase 3: each kernel against its plain twin at the step's shapes."""
    signs = signs_on(dev)
    res = {}
    for label, profile, b in (("msc", eep_profile(108, 3, 0), 6 * N_ENS * 4 * N_FRAMES),
                              ("fic", FIC_PROFILE, N_ENS * N_FRAMES * 4)):
        n_punct = int(profile.mask().sum())
        soft = torch.from_numpy(rng.standard_normal((b, n_punct), dtype=np.float32))
        soft_t = depuncture_t(soft.to(dev, torch.bfloat16),
                              torch.tensor(depuncture_index(profile), device=dev))
        n = profile.data_bits
        got = viterbi_decode_bytes_t_cuda(soft_t, signs, n)
        want = viterbi_decode_bytes_t_ref(soft_t, signs, n)
        torch.cuda.synchronize()
        err = (got.int() - want.int()).abs().max().item()
        if err != 0:
            raise AssertionError(f"viterbi {label}: {(got != want).sum().item()} "
                                 f"bytes differ from the plain decoder")
        call = lambda: viterbi_decode_bytes_t_cuda(soft_t, signs, n)
        ms = cuda_ms(call, 10)
        dev_ms = device_ms(call, 10)
        host = host_us(call, 10)
        plain = cuda_ms(lambda: viterbi_decode_bytes_t_ref(soft_t, signs, n), 1)
        t2p = soft_t.shape[0]
        bnd = bound(soft_t.numel() * soft_t.element_size() + got.numel(),
                    b * t2p * (FWD_OPS["full"] + TB_OPS))
        layout = K12_LAYOUTS[k12_layout(b, sm_count_of(0))]
        print(f"K1+K2 viterbi {label} B={b} T2p={t2p} layout {layout}: bytes equal; "
              f"kernel {ms:.3f} ms ({b * n / ms / 1e3:.1f} Mbit/s decoded; device time "
              f"{dev_ms:.4f} ms, host {host:.1f} us a launch), "
              f"plain {plain:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]})  [{card}]")
        res[f"viterbi_{label}"] = (err, ms, plain)
        res[f"bound_viterbi_{label}"] = bnd
        res[f"viterbi_{label}_device"] = (dev_ms, host)
        res[f"viterbi_{label}_layout"] = layout
        # each layout through the C entry, whichever the rule picks here
        by_layout = {}
        for lay, name in K12_LAYOUTS.items():
            call = lambda lay=lay: k12_entry(soft_t, n, lay)
            require(torch.equal(call(), want), f"viterbi {label}: layout {name}'s bytes differ "
                    f"from the plain decoder's")
            by_layout[name] = device_ms(call, 10)
        print(f"K1+K2 viterbi {label} B={b} T2p={t2p} by layout through the C entry, bytes "
              f"equal, device ms: " + ", ".join(f"{k} {v:.4f}" for k, v in by_layout.items())
              + f"  [{card}]")
        res[f"viterbi_{label}_by_layout"] = by_layout

    for label, profile, b in (("fic", FIC_PROFILE, 64),
                              ("msc", eep_profile(108, 3, 0), 64),
                              ("calibration", get_uep_profile(128, 3).to_profile(), 260)):
        mother = awgn_mother(rng, profile, b)
        n = profile.data_bits
        x = torch.from_numpy(mother).to(dev)
        got = viterbi_decode_bits_cuda(x, signs, n)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = viterbi_decode_ref(x, signs, n)     # timed once: ~10^4 small launches
        end.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(end)
        if not torch.equal(got, want):
            raise AssertionError(f"viterbi bits {label}: {(got != want).sum().item()} "
                                 f"bits differ from the plain decoder")
        call = lambda: viterbi_decode_bits_cuda(x, signs, n)
        ms = cuda_ms(call, 10)
        dev_ms = device_ms(call, 10)
        host = host_us(call, 10)
        t2p = -(-x.shape[1] // 32) * 16
        bnd = bound(x.numel() * 4 + got.numel(), b * t2p * (FWD_OPS["full"] + TB_OPS))
        serial = t2p * SERIAL_STEP_S * 1e3
        print(f"K1+K3 viterbi bits {label} {tuple(x.shape)} f32: bits equal; kernel "
              f"{ms:.3f} ms ({b * n / ms / 1e3:.1f} Mbit/s decoded; device time {dev_ms:.4f} ms, "
              f"host {host:.1f} us a launch), plain {plain:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}), the forward's serial bound {serial:.4f} ms"
              f"  [{card}]")
        res[f"viterbi_bits_{label}"] = (0.0, ms, plain)
        res[f"bound_viterbi_bits_{label}"] = (*bnd, serial)
        res[f"viterbi_bits_{label}_device"] = (dev_ms, host)

    c, s = 4 * N_FRAMES, 108 * 64
    buf = torch.from_numpy(rng.standard_normal((N_ENS, c + 15, s), dtype=np.float32))
    buf = buf.to(dev, torch.bfloat16)
    got, want = deinterleave_cuda(buf, c), deinterleave_ref(buf, c)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("deinterleave kernel differs from the plain gather")
    ms = kernel_ms(lambda: deinterleave_cuda(buf, c), 20, "deint_kernel")
    call = cuda_ms(lambda: deinterleave_cuda(buf, c), 20)
    plain = cuda_ms(lambda: deinterleave_ref(buf, c), 20)
    # the library yardstick: one torch.gather with a precomputed index
    idx = (torch.arange(c, device=dev)[:, None] + torch.as_tensor(
        interleave_delays(s), dtype=torch.long, device=dev)[None, :]).expand(N_ENS, -1, -1)
    if not torch.equal(torch.gather(buf, 1, idx), want):
        raise AssertionError("torch.gather differs from the plain deinterleave")
    library = cuda_ms(lambda: torch.gather(buf, 1, idx), 20)
    bnd = bound(2 * 2 * want.numel(), 0)    # bf16: c of the c + 15 rows read, c written
    print(f"K4 deinterleave {tuple(buf.shape)} bf16: exact; kernel {ms:.4f} ms (a call "
          f"{call:.3f} ms), plain {plain:.3f} ms, torch.gather {library:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})  [{card}]")
    res["deinterleave_call_ms"] = call
    res["deinterleave"] = (0.0, ms, plain)
    res["bound_deinterleave"] = bnd
    res["library_deinterleave"] = library

    f = N_ENS * N_FRAMES
    rows = get_ofdm_params(1).nb_frame_length // 128
    fr = torch.from_numpy(rng.standard_normal((f, rows, 128), dtype=np.float32))
    fi = torch.from_numpy(rng.standard_normal((f, rows, 128), dtype=np.float32))
    fr, fi = fr.to(dev, torch.bfloat16), fi.to(dev, torch.bfloat16)
    freq = torch.from_numpy(rng.uniform(-2000.0, 2000.0, f).astype(np.float32)).to(dev)
    xr, xi, xs = carve_rotate_cuda(fr, fi, freq, with_sum=True)
    tr, ti, ts = carve_rotate_tables_ref(fr, fi, freq, with_sum=True)
    rr, ri = carve_rotate_ref(fr, fi, freq)
    torch.cuda.synchronize()
    require(same_bits(xr, tr) and same_bits(xi, ti) and same_bits(xs, ts),
            "carve kernel differs from carve_rotate_tables_ref")
    ulps = bf16_ulp_err(xr, xi, rr, ri)
    err = max((xr.float() - rr.float()).abs().max().item(),
              (xi.float() - ri.float()).abs().max().item())
    if ulps > 1.0:
        raise AssertionError(f"carve kernel is {ulps} bf16 ulp from the plain version")
    ms = kernel_ms(lambda: carve_rotate_cuda(fr, fi, freq, with_sum=True), 20, "carve_kernel")
    ms2 = kernel_ms(lambda: carve_rotate_cuda(fr, fi, freq), 20, "carve_kernel")
    call = cuda_ms(lambda: carve_rotate_cuda(fr, fi, freq, with_sum=True), 20)
    plain = cuda_ms(lambda: carve_rotate_tables_ref(fr, fi, freq, with_sum=True), 5)
    plain_ref = cuda_ms(lambda: carve_rotate_ref(fr, fi, freq, with_sum=True), 5)
    bnd = carve_bound(fr, xr, n_out=3)
    bnd2 = carve_bound(fr, xr)
    print(f"K5 carve_rotate ({f}, {rows}, 128) bf16: xr, xi, xs bit-equal to the tables twin, "
          f"max {ulps:.0f} bf16 ulp (max abs {err:.3g}) from carve_rotate_ref; kernel "
          f"{ms:.3f} ms with xs (a call {call:.3f} ms; bound {bnd[0]:.3f} ms, {bnd[1]}), "
          f"{ms2:.3f} ms without "
          f"(bound {bnd2[0]:.3f} ms); plain: tables twin {plain:.3f} ms, carve_rotate_ref "
          f"{plain_ref:.3f} ms  [{card}]")
    res["carve_rotate"] = (0.0, ms, plain)
    res["bound_carve_rotate"] = bnd
    res["carve_rotate_extra"] = {"call_ms": call, "ms_without_sum": ms2, "bound_ms_without_sum": bnd2[0],
                                 "ref_max_ulp": ulps, "ref_max_abs_err": err,
                                 "ref_plain_ms": plain_ref}

    # K4 as the host path runs it: a SubchannelDecoder's f32 (15 + C, S)
    # buffer, 4-byte elements, for the 108-CU EEP and the 96-CU UEP subchannel
    c = 4 * HOST_BATCH
    for size_cu in (108, 96):
        buf = torch.from_numpy(rng.standard_normal((c + 15, size_cu * 64), dtype=np.float32))
        buf = buf.to(dev)
        got, want = deinterleave_cuda(buf, c), deinterleave_ref(buf, c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"deinterleave kernel differs from the plain gather "
                                 f"at {tuple(buf.shape)} f32")
        ms = kernel_ms(lambda: deinterleave_cuda(buf, c), 20, "deint_kernel")
        plain = cuda_ms(lambda: deinterleave_ref(buf, c), 20)
        print(f"K4 deinterleave {tuple(buf.shape)} f32: exact; kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms  [{card}]")
        res[f"deinterleave_host_{size_cu}cu"] = (0.0, ms, plain)
    return res


def unfused_chain(soft, carries, index, fic_index):
    """The FEC index chain as the step ran it before K4's mode (b): per
    subchannel the CIF-slice copy, the concatenation with
    the carry, K4's mode (a) and the carry clone; then the concatenation of
    the group and depuncture_t's transposed gather; and the FIC's
    depuncture_t."""
    dab = get_dab_params(1)
    c = N_FRAMES * dab.nb_cifs
    logicals = []
    for cfg, carry in zip(bench_subchannels(), carries):
        sl = subch_cif_slices(soft, cfg, dab.nb_fic_bits, dab.nb_cifs)
        buf = torch.cat([carry, sl.reshape((N_ENS, c, cfg.slice_bits))], dim=-2)
        logicals.append(deinterleave_cuda(buf, c).reshape(-1, cfg.slice_bits))
        buf[..., -15:, :].clone()
    fic = soft[:, : dab.nb_fic_bits].reshape(-1, dab.nb_fic_bits_per_group)
    return depuncture_t(torch.cat(logicals), index), depuncture_t(fic, fic_index)


def check_demod_tail(dev, card):
    """Phase 3, the demod's tail (csrc/demod_tail.cu) at the step's shapes:
    the three bf16 products of E x F = 512 random mode-I frames; the
    partials, the bf16 soft bits, mean_power and the tap bit-equal to the
    plain twins on the CPU for the last 16 frames (each frame's numbers
    depend on that frame alone, the tap on the last). Times each kernel
    (profiler device time) beside its bound and the eager ATen chain it
    replaced on the same products (ofdm/demod.py::eager_tail, the CPU
    path, run on the card: the plain version's time)."""
    f, tail = N_ENS * N_FRAMES, 16
    n = get_ofdm_params(1).nb_frame_length
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fr, fi = (torch.randn((f, n // 128, 128), generator=gen, device=dev).mul_(0.3)
              .to(torch.bfloat16) for _ in range(2))
    freq = torch.linspace(-2000.0, 2000.0, f, device=dev)
    ops = tuple(w.to(dev) for w in demod_mod.dft_operands(1))
    m = demod_mod._spectra(fr, fi, freq, ops, 1, 12, False)
    partials = demod_tail.demap_cuda(*m)
    soft = demod_tail.norm_cuda(*m, partials)
    power, tap = demod_tail.stats_cuda(fr, fi, *m)
    torch.cuda.synchronize()
    mc = tuple(x[-tail:].cpu() for x in m)
    want = demod_tail.demap_ref(*mc)
    require(same_bits(partials[-tail:].cpu(), want), "demap_kernel differs from demap_ref")
    require(same_bits(soft[-tail:].cpu(), demod_tail.norm_ref(*mc, want)),
            "norm_kernel differs from norm_ref")
    ref = demod_tail.stats_ref(fr[-tail:].cpu(), fi[-tail:].cpu(), *mc)
    require(same_bits(power[-tail:].cpu(), ref[0]) and same_bits(tap.cpu(), ref[1]),
            "stats_kernel differs from stats_ref")

    def eager():
        return demod_mod.eager_tail((m[0] - m[1], m[2] + m[0]), fr, fi, torch.bfloat16)
    m_bytes = sum(x.numel() * 2 for x in m)
    bounds = {"demap_kernel": bound(m_bytes, 0), "norm_kernel": bound(m_bytes + soft.numel() * 2, 0),
              "stats_kernel": bound(2 * fr.numel() * 2, 0)}
    calls = {"demap_kernel": lambda: demod_tail.demap_cuda(*m),
             "norm_kernel": lambda: demod_tail.norm_cuda(*m, partials),
             "stats_kernel": lambda: demod_tail.stats_cuda(fr, fi, *m)}
    res = {}
    for name, fn in calls.items():
        res[name] = (kernel_ms(fn, 20, name), *bounds[name])
    plain = cuda_ms(eager, 5)
    total = sum(r[0] for r in res.values())
    print(f"demod tail (512, 76, 1536) bf16 products: partials, soft bits, mean_power and tap "
          f"bit-equal to the twins (last {tail} frames); " + ", ".join(
              f"{k} {v[0]:.4f} ms (bound {v[1]:.4f}, {100 * v[1] / v[0]:.1f}%)"
              for k, v in res.items())
          + f"; all {total:.4f} ms, bound {sum(r[1] for r in res.values()):.4f}; the eager "
          f"chain {plain:.3f} ms  [{card}]")
    return {"demod_tail": res, "demod_tail_eager_ms": plain}


def check_u8(dev, card):
    """Phase 3, rtl_sdr's raw u8 frames at the step's shapes: E x F = 512
    random u8 frames (F, frame_len, 2) on the card. K5's u8 instantiation
    (with the sum) bit-equal to carve_rotate_tables_ref on the card, and
    stats_kernel's to stats_ref on the CPU, on every frame; each kernel
    timed on the device alone (K5 by the profiler, kernel_ms; stats_kernel
    by device_ms, which holds only that kernel) beside its bound, whose
    read is 2 bytes a sample, and beside its plain twin. A time under its
    bound fails. K5 and stats_kernel also read the same frames at
    per-frame starts (a tracked stream's), each bit-equal to its twin and
    timed beside the aligned."""
    f = N_ENS * N_FRAMES
    n = get_ofdm_params(1).nb_frame_length
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    u8 = torch.randint(0, 256, (f, n, 2), generator=gen, device=dev, dtype=torch.uint8)
    freq = torch.linspace(-2000.0, 2000.0, f, device=dev)
    xr, xi, xs = carve_rotate_cuda(u8, None, freq, with_sum=True)
    want = carve_rotate_tables_ref(u8, None, freq, with_sum=True)
    torch.cuda.synchronize()
    require(all(same_bits(a, b) for a, b in zip((xr, xi, xs), want)),
            "K5's u8 instantiation differs from carve_rotate_tables_ref")
    del want
    carve = lambda: carve_rotate_cuda(u8, None, freq, with_sum=True)
    carve_ms = kernel_ms(carve, 20, "carve_kernel")
    carve_call = cuda_ms(carve, 20)
    carve_plain = cuda_ms(lambda: carve_rotate_tables_ref(u8, None, freq, with_sum=True), 5)
    carve_bnd = carve_bound(u8, xr, n_out=3)      # u8: 1-byte elements, I and Q

    # a tracked stream's frames (ofdm/track.py): the same bytes as one
    # segment buffer, frame j moved on by j % 8 pairs, K5 reading them there
    seg = torch.cat([u8.reshape(-1, 2), u8.new_zeros((16, 2))])
    starts = torch.arange(f, device=dev) * n + torch.arange(f, device=dev) % 8
    at = carve_rotate_cuda(seg, None, freq, with_sum=True, starts=starts)
    want = carve_rotate_tables_ref(u8_frames_at(seg, starts, n), None, freq, with_sum=True)
    torch.cuda.synchronize()
    require(all(same_bits(a, b) for a, b in zip(at, want)),
            "K5 at per-frame starts differs from carve_rotate_tables_ref")
    del want, at
    carve_at_ms = kernel_ms(lambda: carve_rotate_cuda(seg, None, freq, with_sum=True,
                                                      starts=starts), 20, "carve_kernel")
    print(f"u8 frames at per-frame starts (j % 8 pairs on): K5 bit-equal to the tables twin; "
          f"kernel {carve_at_ms:.4f} ms ({100 * carve_bnd[0] / carve_at_ms:.1f}% of the bound)")

    ops = tuple(w.to(dev) for w in demod_mod.dft_operands(1))
    m = demod_mod._spectra(u8, None, freq, ops, 1, 12, False)
    power, tap = demod_tail.stats_cuda(u8, None, *m)
    torch.cuda.synchronize()
    ref = demod_tail.stats_ref(u8.cpu(), None, *(x.cpu() for x in m))
    require(same_bits(power.cpu(), ref[0]) and same_bits(tap.cpu(), ref[1]),
            "stats_kernel's u8 instantiation differs from stats_ref")
    # CUDA events behind a spin kernel: on an H100 the profiler recorded one
    # launch in about twenty of this kernel (kernel_ms read 0.0035 ms a call)
    stats_ms = device_ms(lambda: demod_tail.stats_cuda(u8, None, *m), 20)
    stats_plain = cuda_ms(lambda: demod_tail.stats_ref(u8, None, *m), 5)
    stats_bnd = bound(u8.numel(), 0)               # the frames read once
    # the same frames at the per-frame starts K5 read above: the path a
    # tracked stream's frames take (the second 16-byte load and the shifts)
    power, tap = demod_tail.stats_cuda(seg, None, *m, starts=starts, frame_len=n)
    torch.cuda.synchronize()
    ref = demod_tail.stats_ref(seg.cpu(), None, *(x.cpu() for x in m), starts=starts.cpu(),
                               frame_len=n)
    require(same_bits(power.cpu(), ref[0]) and same_bits(tap.cpu(), ref[1]),
            "stats_kernel's u8 instantiation at per-frame starts differs from stats_ref")
    stats_at_ms = device_ms(lambda: demod_tail.stats_cuda(seg, None, *m, starts=starts,
                                                          frame_len=n), 20)
    require(min(carve_ms, carve_at_ms) >= carve_bnd[0] / 1.05
            and min(stats_ms, stats_at_ms) >= stats_bnd[0] / 1.05,
            f"a u8 kernel's time is under its bound: K5 {carve_ms:.4f} / {carve_at_ms:.4f} ms "
            f"(bound {carve_bnd[0]:.4f}), stats_kernel {stats_ms:.4f} / {stats_at_ms:.4f} ms "
            f"(bound {stats_bnd[0]:.4f})")
    print(f"u8 frames ({f}, {n}, 2): K5 carve_rotate xr, xi, xs bit-equal to the tables twin; "
          f"kernel {carve_ms:.4f} ms (a call {carve_call:.3f} ms; bound {carve_bnd[0]:.4f} ms, "
          f"{carve_bnd[1]}, {100 * carve_bnd[0] / carve_ms:.1f}%), plain {carve_plain:.3f} ms; "
          f"stats_kernel mean_power and tap bit-equal to stats_ref (CPU, all {f} frames); "
          f"kernel {stats_ms:.4f} ms (device_ms; bound {stats_bnd[0]:.4f} ms, {stats_bnd[1]}, "
          f"{100 * stats_bnd[0] / stats_ms:.1f}%), plain {stats_plain:.3f} ms; at per-frame "
          f"starts bit-equal to stats_ref, kernel {stats_at_ms:.4f} ms "
          f"({100 * stats_bnd[0] / stats_at_ms:.1f}% of the bound)  [{card}]")
    return {"carve_rotate_u8": {"ms": carve_ms, "call_ms": carve_call, "plain_ms": carve_plain,
                                "bound_ms": carve_bnd[0], "bound_by": carve_bnd[1],
                                "at_starts_ms": carve_at_ms},
            "stats_kernel_u8": {"ms": stats_ms, "plain_ms": stats_plain,
                                "bound_ms": stats_bnd[0], "bound_by": stats_bnd[1],
                                "at_starts_ms": stats_at_ms}}


def check_channelise(dev, card):
    """Phase 3, the wideband channeliser (csrc/channelise.cu) at the hackrf8
    cell's shapes: four receivers' random s8 streams of F = 16 frames
    ((4, 25,165,824, 2) and their random tails) and random frame offsets (0
    and frame_len - 1 among them) -> (32, 16, 1536, 128) bf16 re and im.
    The next tail the stream's last samples exactly; the frames within one
    bf16 ulp plus 2e-6 of channelise_tables_ref (the kernel's arithmetic in
    torch, on the card; 99% bit-equal) and within a relative RMS of 1.5e-3
    of channelise_ref (the plain conv1d path with f32 taps, on the card):
    tests/test_torch_cuda.py's tolerances. Times the kernel (profiler
    device time) and a call beside its bound (DDC_TENSOR_OPS_PER_S) and
    channelise_ref's time on the card; then two chained steps of a
    ReceiveStep built with the plan on these streams, the launch counts
    zeroed before them and read after: one channeliser launch a step."""
    from tpudab_torch.ofdm.channelise import (ChannelPlan, Channeliser, channelise_ref,
                                              channelise_tables_ref)
    from tpudab_torch.ops.channelise_cuda import channelise_cuda
    plan = ChannelPlan.band_iii(DDC_CENTRES)
    ch = Channeliser(plan).to(dev)
    n = get_ofdm_params(1).nb_frame_length
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    streams = torch.randint(-128, 128, (plan.receivers, 8 * N_FRAMES * n, 2), generator=gen,
                            device=dev, dtype=torch.int8)
    tail = ch.init_tail(dev)
    tail.copy_(torch.randint(-128, 128, tuple(tail.shape), generator=gen, device=dev,
                             dtype=torch.int8))
    offsets = torch.randint(0, n, (plan.n_ensembles,), generator=gen, device=dev)
    offsets[:2] = torch.tensor([0, n - 1], device=dev)
    offsets = offsets.to(torch.int32)
    new_tail, re, im = ch(tail, streams, offsets)
    torch.cuda.synchronize()
    require(torch.equal(new_tail, torch.cat([tail, streams], dim=1)[:, -ch.n_tail:]),
            "the channeliser's next tail is not the stream's last samples")
    t_re, t_im = torch.empty_like(re), torch.empty_like(im)
    channelise_tables_ref(tail, streams, offsets.cpu(), plan, ch.b_taps, ch.scale, t_re, t_im)
    excess, same = 0.0, 1.0
    for got, want in ((re, t_re), (im, t_im)):
        g, w = got.float(), want.float()
        excess = max(excess, float(((g - w).abs() - w.abs() * 2 ** -7).max()))
        same = min(same, float((got == want).float().mean()))
    del t_re, t_im
    require(excess <= 2e-6 and same > 0.99,
            f"channelise_kernel against channelise_tables_ref: {excess:.3g} past one bf16 "
            f"ulp, {100 * same:.2f}% bit-equal")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # the plain path's conv1d in f32
    p_re, p_im = torch.empty_like(re), torch.empty_like(im)
    plain = lambda: channelise_ref(tail, streams, offsets, plan, p_re, p_im)
    plain()
    d = (re.double() - p_re.double()) ** 2 + (im.double() - p_im.double()) ** 2
    rel = float((d.sum() / (p_re.double() ** 2 + p_im.double() ** 2).sum()).sqrt())
    del d
    require(rel < 1.5e-3, f"channelise_kernel against channelise_ref: relative RMS {rel:.3g}")
    plain_ms = cuda_ms(plain, 3)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    del p_re, p_im

    call = lambda: channelise_cuda(tail, streams, ch.frag, ch.phase_step, ch.scale, offsets,
                                   re, im, new_tail, plan)
    ms = kernel_ms(call, 20, "channelise_kernel")
    call_ms = cuda_ms(call, 20)
    outputs = re.numel()
    n_bytes = streams.numel() + 2 * tail.numel() + 2 * 2 * outputs
    n_ops = 8 * plan.taps * outputs
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / DDC_TENSOR_OPS_PER_S
    bnd = (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")
    require(ms >= bnd[0] / 1.05, f"channelise_kernel {ms:.4f} ms is under its bound {bnd[0]:.4f}")

    step = ReceiveStep(1, bench_subchannels(), n_ensembles=plan.n_ensembles,
                       channels=plan).to(dev)
    freq = torch.zeros(plan.n_ensembles, device=dev)
    carry = step.init_carry(dev)
    torch.cuda.synchronize()
    channelise_cuda.launches = 0
    for _ in range(2):
        carry, out = step(carry, streams, None, freq, offsets)
    torch.cuda.synchronize()
    launches = channelise_cuda.launches
    require(launches == 2 and (step.ddc.calls, step.ddc.launches) == (2, 2)
            and step.ddc.samples_in == 2 * (streams.numel() // 2)
            and out["fic_bytes"].shape[0] == plan.n_ensembles,
            f"two wideband steps launched the channeliser {launches} times "
            f"(step.ddc: {step.ddc.calls} calls, {step.ddc.launches} launches)")
    del step, carry, out, ch, streams, tail, new_tail, re, im
    torch.cuda.empty_cache()
    print(f"channeliser ({plan.receivers}, {8 * N_FRAMES * n}, 2) s8 + tails -> "
          f"({plan.n_ensembles}, {N_FRAMES}, {n // 128}, 128) bf16 x2: tail exact; within a "
          f"bf16 ulp of the tables twin ({100 * same:.2f}% bit-equal), relative RMS {rel:.3g} "
          f"against channelise_ref; kernel {ms:.4f} ms (a call {call_ms:.3f} ms; bound "
          f"{bnd[0]:.4f} ms, {bnd[1]}, {100 * bnd[0] / ms:.1f}%), plain {plain_ms:.3f} ms; "
          f"a wideband ReceiveStep launched it {launches} times in 2 steps  [{card}]")
    return {"name": "channelise", "route": "cuda", "source": "tpudab_torch/csrc/channelise.cu",
            "replaces": None, "launches": launches, "past_bf16_ulp": excess, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "bit_equal_share": same, "plain_rel_rms": rel}


def check_chain(dev, card):
    """Phase 3, K4's mode (b) at the step's shapes: the six 108-CU EEP 3-A
    subchannels of one group (E = 32, c = 64: B = 12,288, T2p = 1,744) and
    the FIC (B = 2,048, T2p = 400), from random bf16 soft bits and carries:
    the Viterbi input and the new carries bit-equal to the twin. Times one
    MSC launch, the group's six, the FIC's, the twin's and the unfused
    chain (unfused_chain) beside their bounds."""
    dab = get_dab_params(1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    soft = torch.randn((N_ENS * N_FRAMES, dab.nb_frame_bits), generator=gen,
                       device=dev).to(torch.bfloat16)
    subch = bench_subchannels()
    s, profile = subch[0].slice_bits, subch[0].profile
    carries = [torch.randn((N_ENS, 15, s), generator=gen, device=dev).to(torch.bfloat16)
               for _ in subch]
    index = torch.as_tensor(depuncture_index(profile), device=dev)
    n_punct = profile.punctured_bits
    c = N_FRAMES * dab.nb_cifs
    n = N_ENS * c
    rows = [SoftRows.cif_slices(dab.nb_fic_bits, dab.nb_cifs, cfg.start_cu * CU_BITS, s)
            for cfg in subch]
    outs = [soft.new_empty((index.shape[0] // 8, 8, len(subch) * n)) for _ in range(2)]

    def group(fn, out):
        return [fn(soft, r, carry, index, n_punct, out, i * n)
                for i, (r, carry) in enumerate(zip(rows, carries))]
    new_k = group(deinterleave_depuncture_t_cuda, outs[0])
    new_r = group(deinterleave_depuncture_t_ref, outs[1])
    torch.cuda.synchronize()
    require(same_bits(outs[0], outs[1]) and all(same_bits(a, b) for a, b in zip(new_k, new_r)),
            "K4 mode (b) differs from its twin on the MSC group")
    one = lambda fn: fn(soft, rows[0], carries[0], index, n_punct, outs[0], 0)
    ms = kernel_ms(lambda: one(deinterleave_depuncture_t_cuda), 20, "deint_kernel")
    plain = cuda_ms(lambda: one(deinterleave_depuncture_t_ref), 5)
    group_ms = kernel_ms(lambda: group(deinterleave_depuncture_t_cuda, outs[0]), 10,
                         "deint_kernel")
    group_call = cuda_ms(lambda: group(deinterleave_depuncture_t_cuda, outs[0]), 10)
    group_plain = cuda_ms(lambda: group(deinterleave_depuncture_t_ref, outs[1]), 3)
    # read: the slice and the carry; written: the Viterbi input's columns
    # and the new carry; and the index
    slice_bytes, carry_bytes = n * s * 2, N_ENS * 15 * s * 2
    bnd = bound(slice_bytes + 2 * carry_bytes + index.shape[0] * n * 2 + index.numel() * 8, 0)

    fic_index = torch.as_tensor(depuncture_index(FIC_PROFILE), device=dev)
    fic_rows = SoftRows.fib_groups(dab.nb_fib_groups, dab.nb_fic_bits_per_group)
    n_fic = N_ENS * N_FRAMES * dab.nb_fib_groups
    fics = [soft.new_empty((fic_index.shape[0] // 8, 8, n_fic)) for _ in range(2)]
    fic = lambda fn, out: fn(soft, fic_rows, None, fic_index, FIC_PROFILE.punctured_bits, out)
    fic(deinterleave_depuncture_t_cuda, fics[0])
    fic(deinterleave_depuncture_t_ref, fics[1])
    torch.cuda.synchronize()
    require(same_bits(fics[0], fics[1]), "K4 mode (b) differs from its twin on the FIC")
    fic_ms = kernel_ms(lambda: fic(deinterleave_depuncture_t_cuda, fics[0]), 20, "deint_kernel")
    fic_plain = cuda_ms(lambda: fic(deinterleave_depuncture_t_ref, fics[1]), 5)
    fic_bnd = bound(N_ENS * N_FRAMES * dab.nb_fic_bits * 2 + fic_index.shape[0] * n_fic * 2
                    + fic_index.numel() * 8, 0)

    msc_t, fic_t = unfused_chain(soft, carries, index, fic_index)
    torch.cuda.synchronize()
    require(same_bits(msc_t, outs[1]) and same_bits(fic_t, fics[1]),
            "the unfused chain differs from the twin")
    unfused = cuda_ms(lambda: unfused_chain(soft, carries, index, fic_index), 5)
    print(f"K4 mode (b) deinterleave_depuncture_t MSC (E={N_ENS}, c={c}, S={s}) -> "
          f"({index.shape[0] // 8}, 8, {len(subch) * n}) bf16: bit-equal to the twin "
          f"(Viterbi input and new carries); kernel {ms:.4f} ms per subchannel, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}); the group's {len(subch)} launches {group_ms:.4f} ms "
          f"(the calls {group_call:.4f} ms); "
          f"plain {plain:.3f} ms per subchannel, {group_plain:.3f} ms the group  [{card}]")
    print(f"K4 mode (b) FIC ({N_ENS * N_FRAMES} frames) -> ({fic_index.shape[0] // 8}, 8, "
          f"{n_fic}) bf16: bit-equal; kernel {fic_ms:.4f} ms, bound {fic_bnd[0]:.4f} ms "
          f"({fic_bnd[1]}), plain {fic_plain:.3f} ms; the unfused chain (K4 mode (a), "
          f"copies, depuncture_t gathers) for the group and the FIC {unfused:.3f} ms, "
          f"mode (b) {group_ms + fic_ms:.4f} ms  [{card}]")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None, "group_ms": group_ms,
            "group_call_ms": group_call,
            "group_plain_ms": group_plain, "fic_ms": fic_ms, "fic_plain_ms": fic_plain,
            "fic_bound_ms": fic_bnd[0], "unfused_chain_ms": unfused}


def awgn_mother(rng, profile, b: int) -> np.ndarray:
    """b AWGN-coded codewords of profile as the host path feeds the
    decoder: random bits, conv encode, puncture, 1 - 2c + N(0, 0.5^2),
    depuncture with 0.0 erasures -> (b, data_bits + 6, 4) f32."""
    bits = rng.integers(0, 2, (b, profile.data_bits)).astype(np.uint8)
    tx = 1.0 - 2.0 * puncture(np.stack([conv_encode(r) for r in bits]), profile)
    rx = (tx + 0.5 * rng.standard_normal(tx.shape)).astype(np.float32)
    return depuncture_np(rx, profile).reshape(b, -1, 4)


def check_outputs(out, payload, k: int, sid: int):
    fic = out["fic_bytes"].cpu().numpy()
    ok = check_fib_crc(fic.reshape(-1, 3, 32))
    if ok.mean() != 1.0:
        raise AssertionError(f"step {k}: FIB CRC pass rate {ok.mean():.4f} != 1.0")
    got = out["subch"][sid].cpu().numpy()                     # (E, C, bytes)
    c = got.shape[1]
    first = 15 if k == 0 else 0
    want = payload[k * c + first - 15: (k + 1) * c - 15]
    if not (got[:, first:] == want[None]).all():
        raise AssertionError(f"step {k}: subchannel {sid} payload mismatch")


def run_main_path(dev, card):
    """Phases 4 and 5."""
    subch = bench_subchannels()
    t0 = time.perf_counter()
    frames, payload = bench_capture(N_STEPS * N_FRAMES)
    print(f"synth: {N_STEPS * N_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    step = ReceiveStep(1, subch, n_ensembles=N_ENS).to(dev)
    tiled = step.tile_frames(frames)                          # (T, rows, 128)

    def ens_chunk(k):
        part = tiled[k * N_FRAMES:(k + 1) * N_FRAMES]
        re = torch.from_numpy(np.ascontiguousarray(part.real, np.float32)).to(torch.bfloat16)
        im = torch.from_numpy(np.ascontiguousarray(part.imag, np.float32)).to(torch.bfloat16)
        return re, im
    chunks = []
    for k in range(N_STEPS):
        re, im = ens_chunk(k)
        chunks.append(tuple(x.to(dev).expand((N_ENS,) + x.shape).contiguous()
                            for x in (re, im)))
    freq = torch.zeros((), dtype=torch.float32, device=dev)
    carry = step.init_carry(dev)
    torch.cuda.synchronize()

    tail = (demod_tail.demap_cuda, demod_tail.norm_cuda, demod_tail.stats_cuda)
    for w in [w[2] for w in KERNELS.values()] + list(tail):
        w.launches = 0
    viterbi_decode_bytes_t_cuda.layout_launches.clear()
    outs = []
    for k in range(N_STEPS):
        carry, out = step(carry, chunks[k][0], chunks[k][1], freq)
        outs.append(out)
    torch.cuda.synchronize()
    k12_layouts = {K12_LAYOUTS[k]: n
                   for k, n in viterbi_decode_bytes_t_cuda.layout_launches.items()}
    print(f"main path: K1+K2 launches by layout {k12_layouts}")
    require(k12_layouts == {"bfly4": N_STEPS, "warp": N_STEPS},
            f"the main path's K1+K2 launches by layout {k12_layouts}: want the MSC's "
            f"{N_STEPS} on bfly4 and the FIC's {N_STEPS} on warp")
    launches = {name: KERNELS[name][2].launches for name in STEP_KERNELS}
    mode_a = deinterleave_cuda.launches
    print(f"main path: {N_STEPS} steps of E={N_ENS} x F={N_FRAMES}; launches {launches}; "
          f"K4 mode (a) {mode_a}; demod tail {[w.launches for w in tail]}")
    require(all(w.launches == N_STEPS for w in tail),
            "the step's demod tail did not run as its three kernels once a step")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    n_chain = N_STEPS * (len(subch) + 1)   # each subchannel's, and the FIC's
    require(launches["deinterleave_depuncture_t"] >= n_chain and mode_a == 0,
            f"the step's FEC chain did not run through K4 mode (b) alone: "
            f"{launches['deinterleave_depuncture_t']} launches (want {n_chain}), "
            f"mode (a) {mode_a}")
    for k, out in enumerate(outs):
        check_outputs(out, payload, k, subch[0].subch_id)
    print("main path: FIB CRC 1.0 on every step; subchannel 1 payload byte-equal")

    # the same first step for ensemble 0 on the CPU, through the plain twins
    cpu_step = ReceiveStep(1, subch)
    re0, im0 = ens_chunk(0)
    _, out_cpu = cpu_step(cpu_step.init_carry("cpu"), re0, im0, 0.0)
    if not torch.equal(out_cpu["fic_bytes"], outs[0]["fic_bytes"][0].cpu()):
        raise AssertionError("FIC bytes differ between the CUDA and the CPU step")
    for c in subch:
        if not torch.equal(out_cpu["subch"][c.subch_id], outs[0]["subch"][c.subch_id][0].cpu()):
            raise AssertionError(f"subchannel {c.subch_id} differs between CUDA and CPU")
    print("main path: ensemble 0 step 0 equals the CPU plain-twin step byte for byte")

    # rtl_sdr's front end: step 0's signal as u8, fed from pinned host memory
    run_hostfed_step(dev, step, frames[:N_FRAMES], freq, payload, subch[0].subch_id)

    # phase 5: timing
    state = {"carry": carry}

    def one_step():
        state["carry"], _ = step(state["carry"], chunks[0][0], chunks[0][1], freq)
    step_ms = cuda_ms(one_step, 5)
    rtf = N_ENS * N_FRAMES * get_ofdm_params(1).nb_frame_length / SAMPLING_RATE / (step_ms / 1e3)
    print(f"step: {step_ms:.2f} ms per step of E={N_ENS} x F={N_FRAMES}, "
          f"real-time factor {rtf:.1f}  [{card}]")

    # step shares, each component timed alone at its in-step shapes
    x = torch.randn((N_ENS * N_FRAMES, 76, 2048), device=dev).to(torch.bfloat16)
    dft_ms = cuda_ms(lambda: (torch.matmul(x, step.dft_re), torch.matmul(x, step.dft_sum),
                              torch.matmul(x, step.dft_diff)), 10)

    def demod():
        return demod_frames_split(chunks[0][0].view(-1, 1536, 128),
                                  chunks[0][1].view(-1, 1536, 128), freq,
                                  (step.dft_re, step.dft_sum, step.dft_diff),
                                  out_dtype=torch.bfloat16)[0]
    soft = demod()
    parts = {"dft_matmuls": dft_ms, "demod_total": cuda_ms(demod, 5),
             "fec_total": cuda_ms(lambda: step.decode_soft(step.init_carry(dev), soft), 5)}
    print(f"step parts [{card}]: " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / step_ms:.1f}%)" for k, v in parts.items()))
    state["carry"] = device_breakdown(step, state["carry"], chunks[0], freq, step_ms, card)
    fec_breakdown(step, state["carry"], soft, card)
    return launches, step_ms, frames, payload, k12_layouts


def run_hostfed_step(dev, step, frames: np.ndarray, freq, payload, sid: int) -> None:
    """Phase 4, the step on rtl_sdr's raw IQ: frames (F, frame_len) complex
    quantised as rtl_sdr delivers them (each rail's RMS 32 LSB around
    127.5, rounded, clipped to 0..255), one pinned host region an ensemble,
    fed through a HostFeed into a first step. K5 and stats_kernel must run
    once each (counts set to 0 just before the step), the feed must count
    every byte, and the bytes must be those of the f32 frames
    (x - 127.5) / 128 through the same step, and the payload."""
    x = frames.ravel().astype(np.complex128)
    x *= 32.0 / np.sqrt(np.mean(np.abs(x) ** 2) / 2)
    iq = np.clip(np.rint(np.stack([x.real, x.imag], axis=-1) + 127.5), 0, 255)
    u8 = torch.from_numpy(iq.astype(np.uint8)).reshape(frames.shape + (2,))
    regions = [torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True).copy_(u8)
               for _ in range(N_ENS)]
    feed = HostFeed((N_ENS,) + tuple(u8.shape), dev)
    torch.cuda.synchronize()
    carve_rotate_cuda.launches = demod_tail.stats_cuda.launches = 0
    feed.feed(regions)
    _, got = step(step.init_carry(dev), feed, None, freq)
    torch.cuda.synchronize()
    k5, st = carve_rotate_cuda.launches, demod_tail.stats_cuda.launches
    due = N_ENS * u8.numel()
    print(f"main path, u8 through HostFeed: E={N_ENS} x F={u8.shape[0]}, {feed.bytes_copied} B "
          f"copied from {N_ENS} pinned regions (due {due}); launches K5 {k5}, stats_kernel {st}")
    require(k5 == 1 and st == 1, "the u8 step did not run K5 and stats_kernel once each")
    require(feed.bytes_copied == due, "HostFeed did not count the step's bytes")
    check_outputs(got, payload, 0, sid)
    re = ((u8[..., 0].float() - 127.5) / 128.0).to(dev).expand((N_ENS,) + u8.shape[:-1])
    im = ((u8[..., 1].float() - 127.5) / 128.0).to(dev).expand((N_ENS,) + u8.shape[:-1])
    _, want = step(step.init_carry(dev), re.contiguous(), im.contiguous(), freq)
    require(torch.equal(got["fic_bytes"], want["fic_bytes"])
            and all(torch.equal(got["subch"][i], want["subch"][i]) for i in want["subch"]),
            "the u8 step's bytes differ from the step on the f32 frames")
    print("main path, u8 through HostFeed: FIB CRC 1.0; subchannel 1 payload byte-equal; "
          "the bytes equal the step's on the f32 frames (x - 127.5) / 128")


def device_breakdown(step, carry, chunk, freq, step_ms: float, card: str):
    """Phase 6: N_STEPS steps traced with only device activities recorded.
    Busy time is the sum of device events (one stream, so none overlap);
    the idle share is of the CUDA-event window around the steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(N_STEPS):
            carry, _ = step(carry, chunk[0], chunk[1], freq)
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end) / N_STEPS
    kernels = [(k.key, k.self_device_time_total / 1e3 / N_STEPS, k.count // N_STEPS)
               for k in prof.key_averages()
               if k.device_type == DeviceType.CUDA and k.self_device_time_total > 0]
    busy = sum(r[1] for r in kernels)
    if busy == 0.0:
        print("device breakdown: not measured (the profiler recorded no device time)")
        return carry
    print(f"device breakdown [{card}]: window {window:.3f} ms/step traced "
          f"(untraced {step_ms:.3f}), busy {busy:.3f} ms/step, "
          f"idle share {1 - busy / window:.4f}")
    for name, ms, n in sorted(kernels, key=lambda r: -r[1])[:25]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<4d} {name[:100]}")
    return carry


def fec_breakdown(step, carry, soft, card: str) -> None:
    """Phase 6, the FEC half (decode_soft) traced alone, device activity
    only: its kernels by name. Fails if a gather, index_select or cat
    kernel is left in it: K4's mode (b) does that work now."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.decode_soft(carry, soft)
        torch.cuda.synchronize()
    kernels = [(k.key, k.self_device_time_total / 1e3, k.count) for k in prof.key_averages()
               if k.device_type == DeviceType.CUDA and k.self_device_time_total > 0]
    if not kernels:
        print("FEC breakdown: not measured (the profiler recorded no device time)")
        return
    print(f"FEC half alone, traced [{card}]: busy {sum(r[1] for r in kernels):.3f} ms, "
          f"{sum(r[2] for r in kernels)} device activities")
    for name, ms, n in sorted(kernels, key=lambda r: -r[1]):
        print(f"  {ms:9.3f} ms  x{n:<4d} {name[:100]}")
    left = [name for name, *_ in kernels if any(
        w in name.lower() for w in ("indexselect", "index_select", "gather", "catarray"))]
    require(not left, f"the FEC half still runs gather, index_select or cat kernels: {left}")


def host_capture(n_frames: int):
    """Phase 7's input: the multiplex of six 108-CU EEP 3-A DAB+ services
    (bench_subchannels(), superframes of seeded random AUs) and one UEP
    128 kbps PL3 MP2-type service (seeded random bytes), as n_frames frames
    of f32 soft bits 1 - 2b + N(0, HOST_SIGMA^2). Returns (soft, {subch id:
    AUs}, UEP payload (4 * n_frames, 384) uint8)."""
    sid, start, size, kbps, level = HOST_UEP
    subch = bench_subchannels()
    subs = [SubchannelSpec(c.subch_id, c.start_cu, c.size_cu, ("eep", 3, 0)) for c in subch]
    subs.append(SubchannelSpec(sid, start, size, ("uep", kbps, level)))
    spec = EnsembleSpec(
        ensemble_id=0xBE9D, label="Host Ensemble",
        services=[ServiceSpec(0xC200 + c.subch_id, f"Host {c.subch_id}",
                              [(0, ASCTY_DAB_PLUS, c.subch_id)]) for c in subch]
        + [ServiceSpec(0xC200 + sid, "Host MP2", [(0, ASCTY_DAB, sid)])],
        subchannels=subs)
    synth = EnsembleSynthesizer(spec, seed=1)
    n_logical = 4 * n_frames
    aus = {}
    for sub in subs[:-1]:
        stream, aus[sub.subch_id] = dabplus_stream(sub.bitrate_kbps, n_logical,
                                                   seed=10 + sub.subch_id)
        synth.payload_fn[sub.subch_id] = lambda m, st=stream: st[m].tobytes()
    rng = np.random.default_rng(3)
    uep = rng.integers(0, 256, (n_logical, kbps * 3)).astype(np.uint8)
    synth.payload_fn[sid] = lambda m: uep[m].tobytes()
    bits = np.stack([synth.frame_bits(i) for i in range(n_frames)])
    soft = (1.0 - 2.0 * bits + HOST_SIGMA * rng.standard_normal(bits.shape)).astype(np.float32)
    return soft, aus, uep


def decode_host(dev, soft):
    """Phase 7's run: Receiver(1, dev) over soft in batches of HOST_BATCH,
    then finalize. Returns (receiver, {subch id: [outputs]}, wall seconds
    of each batch (finalize in the last), total wall seconds)."""
    rx = Receiver(1, dev)
    acc, walls = {}, []
    t_all = time.perf_counter()
    for lo in range(0, soft.shape[0], HOST_BATCH):
        t0 = time.perf_counter()
        outs = rx.process_frame_bits(soft[lo: lo + HOST_BATCH])   # bytes come back: synced
        if lo + HOST_BATCH >= soft.shape[0]:
            outs = [outs, rx.finalize()]
        else:
            outs = [outs]
        walls.append(time.perf_counter() - t0)
        for o in outs:
            for sid, out in o.items():
                acc.setdefault(sid, []).append(out)
    return rx, acc, walls, time.perf_counter() - t_all


def host_result(rx, acc):
    """What phase 7 holds equal between devices: stats, database labels,
    calibration, and per subchannel the raw frames, AUs and flags."""
    res = {"stats": dict(rx.stats), "ensemble": rx.db.ensemble.label,
           "services": sorted((k, v.label) for k, v in rx.db.services.items()),
           "subchannels": sorted(rx.db.subchannels),
           "calibration": {k: (c.chosen, c.locked, c.swapped, c.best_score,
                               c.runner_up_score) for k, c in rx.uep_calibrations.items()}}
    for sid, outs in acc.items():
        raw = [o.raw_frames for o in outs if o.raw_frames is not None and len(o.raw_frames)]
        sfs = [sf for o in outs for sf in o.superframes]
        res[sid] = (np.concatenate(raw).tobytes() if raw else b"",
                    [(sf.firecode_ok, sf.rs_ok, tuple(sf.au_crc_ok),
                      tuple(bytes(a) for a in sf.access_units)) for sf in sfs])
    return res


def check_host(res, aus, uep, n_frames: int) -> None:
    """Phase 7's gate on the card's result."""
    sid_uep = HOST_UEP[0]
    stats = res["stats"]
    if stats["fibs"] != 12 * n_frames or stats["fib_crc_errors"] != 0:
        raise AssertionError(f"host path FIC: {stats}")
    if res["ensemble"] != "Host Ensemble" or len(res["services"]) != 7 \
            or len(res["subchannels"]) != 7:
        raise AssertionError(f"host path database: {res['ensemble']!r} "
                             f"{res['services']} {res['subchannels']}")
    cal = res["calibration"].get(sid_uep)
    if cal is None or not cal[1] or cal[2]:
        raise AssertionError(f"UEP calibration did not lock the shipped table: {cal}")
    complete = 4 * n_frames - 15            # logical frames with all 16 CIFs
    for sid, want in aus.items():
        sfs = res[sid][1]
        if len(sfs) != complete // 5:
            raise AssertionError(f"subch {sid}: {len(sfs)} superframes, want {complete // 5}")
        if not all(f and r and all(a) for f, r, a, _ in sfs):
            raise AssertionError(f"subch {sid}: a Fire code, RS or AU CRC failed")
        got = [a for *_, sf_aus in sfs for a in sf_aus]
        if got != want[: len(got)]:
            raise AssertionError(f"subch {sid}: AUs differ from the payload")
    raw = np.frombuffer(res[sid_uep][0], np.uint8).reshape(-1, uep.shape[1])
    if raw.shape[0] != complete or not np.array_equal(raw, uep[:complete]):
        raise AssertionError(f"UEP subchannel: {raw.shape[0]} frames, payload mismatch")


def run_host_path(dev, card):
    """Phase 7."""
    t0 = time.perf_counter()
    soft, aus, uep = host_capture(HOST_FRAMES)
    print(f"host path synth: {HOST_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    for name in HOST_KERNELS:
        KERNELS[name][2].launches = 0
    rx, acc, walls, wall = decode_host(dev, soft)
    launches = {name: KERNELS[name][2].launches for name in HOST_KERNELS}
    print(f"host path: {HOST_FRAMES} frames in batches of {HOST_BATCH}; launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the host path")
    res = host_result(rx, acc)
    check_host(res, aus, uep, HOST_FRAMES)
    for sid, cal in sorted(rx.uep_calibrations.items()):
        print(f"host path: subch {sid}: {cal.summary()}")
    print("host path: FIB CRC 1.0; database 7 services / 7 subchannels; UEP shipped "
          "table locked; every AU byte-equal with Fire code, RS, AU CRC ok; UEP "
          "payload byte-equal")
    signal_s = HOST_FRAMES * get_ofdm_params(1).nb_frame_length / SAMPLING_RATE
    print(f"host path [{card}]: wall per {HOST_BATCH}-frame batch "
          + ", ".join(f"{w:.3f}" for w in walls) + f" s (finalize in the last); "
          f"total {wall:.3f} s for {signal_s:.3f} s of signal, real-time factor "
          f"{signal_s / wall:.2f}")

    busy, traced = host_device_busy(dev, soft)
    print(f"host path device busy [{card}]: {busy:.3f} s of a traced rerun's "
          f"{traced:.3f} s wall (busy share {busy / traced:.4f}; "
          f"{busy / wall:.4f} of the untraced wall)")

    t0 = time.perf_counter()
    rx_cpu, acc_cpu, _, _ = decode_host("cpu", soft)
    if host_result(rx_cpu, acc_cpu) != res:
        raise AssertionError("the CPU Receiver's outputs differ from the CUDA Receiver's")
    print(f"host path: the CPU Receiver (plain twins) gives identical outputs "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches, signal_s / wall


def host_device_busy(dev, soft):
    """Device busy seconds of a traced rerun of the host path (device
    activity only, summed over kernels and copies), and its wall seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = decode_host(dev, soft)
        torch.cuda.synchronize()
    rows = [(k.key, k.self_device_time_total / 1e6, k.count) for k in prof.key_averages()
            if k.device_type == DeviceType.CUDA and k.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    for name, sec, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {1e3 * sec:10.3f} ms  x{n:<6d} {name[:90]}")
    return busy, wall


def timed_once(fn):
    """(fn(), device ms of that one call): for the plain twins, thousands of
    small launches each."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_tool_forward(dev, rng, card):
    """Phase 8, Viterbi forward variants (X1, X2, X3, X6) and the traceback
    modes (X2 tbonly, X5, X6 tb_t) at the tools' shapes: each against its
    plain twin on the first TWIN_B codewords, the exact variants against
    full on the whole batch, full + shuffle against the fused K1+K2."""
    signs = signs_on(dev)
    soft = torch.from_numpy(rng.standard_normal((EXP_B, EXP_BITS + 6, 4), dtype=np.float32))
    soft_t = mother_to_t(soft.to(dev), 8 * EXP_CHUNK)
    t2p = soft_t.shape[0]
    full = {}
    res = {}

    def one(label, x, variant, rebase, compare_to=None):
        d, pm = fwd_variant_cuda(x, signs, variant, rebase)
        torch.cuda.synchronize()
        (td, tpm), plain = timed_once(
            lambda: fwd_variant_ref(x[:, :, :TWIN_B].contiguous(), signs, variant, rebase))
        require(torch.equal(d[:TWIN_B], td) and torch.equal(pm[:TWIN_B], tpm),
                f"forward {label}: kernel differs from its plain twin")
        if compare_to is not None:
            require(torch.equal(d, compare_to[0]) and torch.equal(pm, compare_to[1]),
                    f"forward {label}: decisions differ from full's")
        ms = cuda_ms(lambda: fwd_variant_cuda(x, signs, variant, rebase), 10)
        bnd = bound(x.numel() * x.element_size() + d.numel() + pm.numel() * 4,
                    x.shape[2] * x.shape[0] * FWD_OPS[variant])
        print(f"X forward {label} {tuple(x.shape)} {str(x.dtype)[6:]} rebase {rebase}: equal to "
              f"its twin ({TWIN_B} codewords){' and to full' if compare_to else ''}; kernel "
              f"{ms:.3f} ms, plain {plain:.3f} ms ({TWIN_B} codewords), bound {bnd[0]:.3f} ms "
              f"({bnd[1]})  [{card}]")
        res[label] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                      "shape": list(x.shape), "dtype": str(x.dtype)[6:], "rebase": rebase}
        return d, pm

    for dt in (torch.float32, torch.bfloat16):
        x = soft_t.to(dt)
        full[dt] = one("full" if dt == torch.float32 else "full_bf16", x, "full", EXP_CHUNK)
    for name in ("prefetch", "dbuf", "gmm4"):
        one(name, soft_t, name, EXP_CHUNK, full[torch.float32])
    one("dbuf_bf16", soft_t.to(torch.bfloat16), "dbuf", EXP_CHUNK, full[torch.bfloat16])
    d, pm = one("nodec", soft_t, "nodec", EXP_CHUNK)
    require(torch.equal(pm, full[torch.float32][1]) and not d.any(),
            "forward nodec: metrics differ from full's or decisions are not zero")
    one("noacs", soft_t, "noacs", EXP_CHUNK)

    # X3: int16 on integer soft bits, equal to f32's full from the second group on
    soft_i = torch.from_numpy(rng.integers(-127, 128, (EXP_B, EXP_BITS + 6, 4)).astype(np.int16))
    d32 = fwd_variant_cuda(mother_to_t(soft_i.to(dev, torch.float32), 8 * EXP_CHUNK), signs, "full",
                           EXP_CHUNK)[0]
    d16, _ = one("int16", mother_to_t(soft_i.to(dev), 8 * EXP_CHUNK, value=1), "full", 4)
    require(torch.equal(d16[:, 1:], d32[:, 1:]), "forward int16 differs from f32 past group 0")
    print(f"X forward int16: equal to f32 full from the second group on; in the first, "
          f"{int((d16[:, 0] != d32[:, 0]).any(1).sum())} of {EXP_B} codewords differ "
          f"(f32's -1e9 start rounds the branch metrics of unreachable states)")

    # X6: fwd_t on depuncture_t's bf16 layout (EEP 3-A, 108 CU), rebase 16;
    # with the shuffle traceback it gives the fused K1+K2's bytes
    prof = eep_profile(108, 3, 0)
    punct = torch.from_numpy(rng.standard_normal((EXP_B, prof.punctured_bits), dtype=np.float32))
    x6 = depuncture_t(punct.to(dev, torch.bfloat16),
                      torch.as_tensor(depuncture_index(prof), device=dev))
    d6, _ = one("fwd_t", x6, "full", 16)
    n = prof.data_bits
    fused = viterbi_decode_bytes_t_cuda(x6, signs, n)
    require(torch.equal(traceback_bytes_cuda(d6, "shuffle")[:, : n // 8], fused),
            "fwd_t + shuffle traceback differ from the fused K1+K2 bytes")
    print("X fwd_t + tb_t: bytes equal to the fused K1+K2 (viterbi_decode_bytes_t)")

    # tracebacks on full's decisions: the three modes agree, each = its twin
    decs = full[torch.float32][0]
    want = traceback_bytes_cuda(decs, "shuffle")
    tb = {}
    for mode in ("shuffle", "masked", "tree"):
        got = traceback_bytes_cuda(decs, mode)
        torch.cuda.synchronize()
        twin, plain = timed_once(lambda: traceback_bytes_ref(decs[:TWIN_B], mode))
        require(torch.equal(got, want) and torch.equal(got[:TWIN_B], twin)
                and torch.equal(twin[:16], traceback_maps_ref(decs[:16], mode)),
                f"traceback {mode}: differs from shuffle, from its twin or from the maps' twin")
        call = lambda: traceback_bytes_cuda(decs, mode)
        ms = cuda_ms(call, 10)
        dev_ms = device_ms(call, 10)
        # the path reads one byte of each group's 64: one sector per group;
        # the maps read both sectors of every row (the design's own floor)
        bnd = bound(EXP_B * decs.shape[1] * SECTOR + got.numel(), EXP_B * t2p * TB_OPS)
        floor = bound(decs.numel() + got.numel(), 0)[0]
        old_chain = t2p * TB_SERIAL_STEP_S * 1e3
        print(f"X traceback {mode} {tuple(decs.shape)}: equal to shuffle, to its twin and to the "
              f"group-map twin; kernel {ms:.4f} ms (device alone {dev_ms:.4f} ms), plain "
              f"{plain:.3f} ms ({TWIN_B} codewords), bound {bnd[0]:.4f} ms ({bnd[1]}), the maps' "
              f"read of every row {floor:.4f} ms; the old per-super-step chain {old_chain:.4f} ms"
              f" (not a bound of the maps)  [{card}]")
        tb[mode] = {"ms": ms, "kernel_ms": dev_ms, "plain_ms": plain, "bound_ms": bnd[0],
                    "bound_by": bnd[1], "all_rows_ms": floor, "old_chain_ms": old_chain}
    return res, tb


def check_tool_probe_carve(dev, rng, card):
    """Phase 8, the int16 probe (X4) on every op and the carve ablations
    (X7) at exp_carve's 256 frames: each against its twin on the card,
    bit for bit, the ones that roll and rotate also against K5, no-rotate
    also against its library yardstick; each timed by its device time
    (device_ms) beside a call's."""
    x, y = exp_i16_probe.inputs(dev)
    # a ragged (12, 13) and views 2 bytes past a 16-byte boundary: the
    # kernel's element-wise tail and unaligned paths
    rng_i = np.random.default_rng(SEED + 4)
    odd = [torch.from_numpy(rng_i.integers(-32768, 32768, (12, 13)).astype(np.int16)).to(dev)
           for _ in range(2)]
    shifted = [torch.empty(1 + 64 * 256, dtype=torch.int16, device=dev)[1:].view(64, 256)
               .copy_(t) for t in (x, y)]
    probe = {}
    for op in I16_OPS:
        for a, b in ((x, y), odd, shifted):
            require(torch.equal(i16_probe_cuda(a, b, op), i16_probe_ref(a, b, op)),
                    f"int16 probe {op} differs at {tuple(a.shape)}, offset {a.data_ptr() % 16}")
        bnd = bound(3 * x.numel() * 2, x.numel())
        call = lambda: i16_probe_cuda(x, y, op)
        probe[op] = {"ms": cuda_ms(call, 20), "kernel_ms": device_ms(call, 20),
                     "plain_ms": cuda_ms(lambda: i16_probe_ref(x, y, op), 20),
                     "bound_ms": bnd[0], "bound_by": bnd[1]}
    library = cuda_ms(lambda: torch.add(x, y), 20)
    for v in probe.values():
        v["library_ms"] = library       # torch.add in the same run: the yardstick of every op
    probe["add"]["library_ms"] = library
    slower = [op for op, v in probe.items() if v["ms"] > library]
    print(f"X int16 probe {tuple(x.shape)}: all {len(I16_OPS)} ops equal to the twin (also at "
          f"(12, 13) and on unaligned views); a call (20, CUDA events) "
          + ", ".join(f"{op} {v['ms']:.4f}" for op, v in probe.items())
          + " ms; device alone " + ", ".join(f"{op} {v['kernel_ms']:.5f}" for op, v in probe.items())
          + f" ms; torch.add a call {library:.4f} ms; slower than torch.add: {slower or 'none'}; "
          f"add: plain {probe['add']['plain_ms']:.4f} ms, bound {probe['add']['bound_ms']:.6f} ms"
          f"  [{card}]")
    probe_launch = launch_breakdown(x, y, card)

    rows = get_ofdm_params(1).nb_frame_length // 128
    fr = torch.from_numpy(rng.standard_normal((EXP_FRAMES, rows, 128), dtype=np.float32)).to(dev)
    fi = torch.from_numpy(rng.standard_normal((EXP_FRAMES, rows, 128), dtype=np.float32)).to(dev)
    freq = torch.from_numpy(rng.uniform(-2000.0, 2000.0, EXP_FRAMES).astype(np.float32)).to(dev)
    k5 = carve_rotate_cuda(fr, fi, freq)
    # the no-rotate variant's library yardstick: torch's .to(bfloat16) of
    # the windows' strided view, one call a plane, both timed together
    flat = [t.reshape(EXP_FRAMES, -1) for t in (fr, fi)]
    yardstick = lambda: [_windows(t, 1, 12).to(torch.bfloat16) for t in flat]
    lib_out = [t.reshape(k5[0].shape) for t in yardstick()]
    library = {"ms": cuda_ms(yardstick, 10), "kernel_ms": device_ms(yardstick, 10)}
    tables_ms = device_ms(lambda: rotator_tables(freq, 1, 12), 10)
    carve = {}
    for label, fb, roll, rotate in CARVE_VARIANTS:
        xr, xi = carve_variant_cuda(fr, fi, freq, fb, roll, rotate)
        torch.cuda.synchronize()
        (rr, ri), plain = timed_once(lambda: carve_variant_ref(fr, fi, freq, fb, roll, rotate))
        require(same_bits(xr, rr) and same_bits(xi, ri), f"carve {label} differs from its twin")
        if roll and rotate:
            require(same_bits(xr, k5[0]) and same_bits(xi, k5[1]), f"carve {label} differs from K5")
        if label == "norotate":
            require(same_bits(xr, lib_out[0]) and same_bits(xi, lib_out[1]),
                    "carve norotate differs from torch's .to(bfloat16) of the windows")
        call = lambda: carve_variant_cuda(fr, fi, freq, fb, roll, rotate)
        ms, dev_ms = cuda_ms(call, 10), device_ms(call, 10)
        bnd = carve_bound(fr, xr, rotate)
        lib = library if label == "norotate" else None
        print(f"X carve {label} (fb={fb}, roll={roll}, rotate={rotate}) {tuple(fr.shape)} f32: "
              f"bit-equal to its twin" + (", and to K5" if roll and rotate else "")
              + (", and to the yardstick" if lib else "")
              + f"; device {dev_ms:.4f} ms ({100 * bnd[0] / dev_ms:.0f}% of the bound), a call "
              f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
              + (f"; .to(bfloat16) x2 device {lib['kernel_ms']:.4f} ms, a call {lib['ms']:.4f} ms"
                 if lib else "") + f"  [{card}]")
        carve[label] = {"ms": ms, "kernel_ms": dev_ms, "plain_ms": plain, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "bound_share": bnd[0] / dev_ms,
                        "k5_bit_equal": True if roll and rotate else None,
                        "library_ms": lib["ms"] if lib else None,
                        "library_kernel_ms": lib["kernel_ms"] if lib else None,
                        "tables_kernel_ms": tables_ms if rotate else None, "max_abs_err": 0.0}
    print(f"X carve: the rotator tables alone (part of each rotating call) device "
          f"{tables_ms:.4f} ms  [{card}]")
    return probe, carve, probe_launch


def launch_breakdown(x, y, card: str) -> dict:
    """Host microseconds of each part of a ctypes launch of the int16 probe
    (host clock, 2,000 calls each, no device work unless said): torch's
    current stream as a torch.cuda.Stream object and as the raw handle; the
    current device; a device guard; a ctypes.c_void_p; the C call alone
    (op 99, which returns an error before launching); torch.empty_like; the
    wrapper, the wrapper as it stood before the lean path (guard, stream
    object, c_void_p pointers), and torch.add, each launching."""
    import ctypes
    lib = _build.load_library()
    reps, out = 2000, torch.empty_like(x)
    px, py, po = x.data_ptr(), y.data_ptr(), out.data_ptr()
    rows, cols = x.shape

    def old_path():
        o = torch.empty_like(x)
        with torch.cuda.device(x.device):
            err = lib.tpudab_i16_probe(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                                       ctypes.c_void_p(o.data_ptr()), rows, cols, 0,
                                       ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(err, "int16 probe add")
        return o

    def guard():
        with torch.cuda.device(x.device):
            pass

    parts = {
        "stream_object": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_device": lambda: torch._C._cuda_getDevice(),
        "device_guard": guard,
        "c_void_p": lambda: ctypes.c_void_p(px),
        "c_call_no_launch": lambda: lib.tpudab_i16_probe(px, py, po, rows, cols, 99, 0),
        "empty_like": lambda: torch.empty_like(x),
        "wrapper": lambda: i16_probe_cuda(x, y, "add"),
        "old_wrapper": old_path,
        "torch_add": lambda: torch.add(x, y),
    }
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        res[name] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    require(torch.equal(old_path(), x + y), "the old launch path's add differs")
    print(f"X4 launch path, host us a call ({reps} calls each) [{card}]: "
          + ", ".join(f"{k} {v:.2f}" for k, v in res.items()))
    return res


def run_tools(card, tools=TOOLS, kernels=TOOL_KERNELS):
    """Phase 8, the slice's main path (and phase 14 with the step's tools
    and kernels): each tool's entry point as `python -m
    tpudab_torch.tools.<name>` runs it, at its own shapes, with the launch
    counts set to 0 just before and read just after; every kernel must be
    launched and every check hold."""
    torch.cuda.synchronize()
    for name in kernels:
        KERNELS[name][2].launches = 0
    checks = {}
    results = {}
    for mod in tools:
        name = mod.__name__.rsplit(".", 1)[1]
        print(f"--- python -m {mod.__name__}")
        out = mod.main([])
        results[name], checks[name] = out["ms"], out["checks"]
    torch.cuda.synchronize()
    launches = {name: KERNELS[name][2].launches for name in kernels}
    print(f"tools: launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched by the tools")
    for name, c in checks.items():
        require(all(c.values()), f"tool {name}: a check failed: {c}")
    print(f"tools: every check held [{card}]")
    return launches, results


def run_step_tools(card):
    """Phase 14: run_tools on the step's measurement tools and K5, K4 mode
    (b) and K1+K2; every step shape must run."""
    t_phase = time.perf_counter()
    launches, results = run_tools(card, STEP_TOOLS, STEP_KERNELS)
    shapes = [f"e{e}_f{f}" for e, f in exp_step_shapes.SHAPES]
    require(sorted(results["exp_step_shapes"]) == sorted(shapes),
            f"step shapes run: {sorted(results['exp_step_shapes'])}, want {shapes}")
    best = max(shapes, key=lambda k: results["exp_step_shapes"][k]["rtf"])
    print(f"step tools: every check held, all {len(shapes)} step shapes ran, the best RTF "
          f"at {best} ({results['exp_step_shapes'][best]['rtf']:.0f}x) [{card}]")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s in all [{card}]")
    return launches, results


def tool_stdout(module: str, timeout: float, env=None) -> str:
    """`python -m <module>` from the checkout's root; its standard output.
    A non-zero exit fails with the ends of its output."""
    proc = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env, timeout=timeout,
                          capture_output=True, text=True)
    require(proc.returncode == 0, f"python -m {module}: exit code {proc.returncode}\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def run_bench_tools(dev, card, step_ms: float) -> dict:
    """Phase 15: (a) `python -m tpudab_torch.tools.bench` at its defaults
    (E = 32 x F = 16, bf16; bench.py's gate, host-clock method and Viterbi
    microbench): rc 0, bench.py's keys, RTF and Mbit/s above 0, printed
    beside phase 5's CUDA-event step; then tools.bench.run once in this
    process with the launch counts set to 0 before and read after: K5, K4
    mode (b) and K1+K2 must be launched. (b) `python -m
    tpudab_torch.tools.bench_scaling` with one trial: rc 0, the rows of
    SCALING_SIZES and the summary; each size over NCCL where its ranks have
    a card each, else over gloo and oversubscribed (on one card, sizes
    2-8 share cuda:0: a check of the protocol and its overhead, not of
    scaling)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    line = json.loads(tool_stdout("tpudab_torch.tools.bench", BENCH_TIMEOUT_S).splitlines()[-1])
    missing = [k for k in bench_tool.KEYS if k not in line]
    require(not missing and "error" not in line, f"bench: keys {missing} missing, or an error: "
            f"{line}")
    require(line["value"] > 0 and line["viterbi_mbit_s"] > 0, f"bench: {line}")
    rtf5 = N_ENS * N_FRAMES * get_ofdm_params(1).nb_frame_length / SAMPLING_RATE / (step_ms / 1e3)
    print(f"bench (a): python -m tpudab_torch.tools.bench: {json.dumps(line)}")
    print(f"bench (a) [{card}]: RTF {line['value']} by bench.py's method (host clock, "
          f"{N_ENS} x {N_FRAMES}, the checksum as the barrier) beside phase 5's {step_ms:.3f} ms "
          f"a step by CUDA events (RTF {rtf5:.1f}) in this call; Viterbi "
          f"{line['viterbi_mbit_s']} Mbit/s, spread {line['viterbi_mbit_s_spread']}")

    torch.cuda.synchronize()
    for name in STEP_KERNELS:
        KERNELS[name][2].launches = 0
    in_process, _ = bench_tool.run(dev, N_ENS, N_FRAMES)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name][2].launches for name in STEP_KERNELS}
    require(all(launches.values()), f"bench in process: launches {launches}")
    print(f"bench (a) in process: {json.dumps(in_process)}; launches {launches}")
    torch.cuda.empty_cache()

    env = dict(os.environ, TPUDAB_SCALING_TRIALS="1")
    summary = json.loads(tool_stdout("tpudab_torch.tools.bench_scaling", SCALING_TIMEOUT_S,
                                     env).splitlines()[-1])
    rows = summary["results"]
    require([r["n_devices"] for r in rows] == SCALING_SIZES, f"bench_scaling: sizes "
            f"{[r['n_devices'] for r in rows]}, want {SCALING_SIZES}")
    cards = torch.cuda.device_count()
    for r in rows:
        n = r["n_devices"]
        require(r["backend"] == ("nccl" if n <= cards else "gloo")
                and (n <= cards or r["oversubscribed"]) and r["collective_ms"] >= 0,
                f"bench_scaling: size {n} on {cards} card(s): {r}")
    gloo = summary["two_process_gloo"]
    require(gloo["backend"] == "gloo" and gloo["step_ms"] > 0, f"bench_scaling: {gloo}")
    print(f"bench_scaling (b) [{card}]: python -m tpudab_torch.tools.bench_scaling, one trial, "
          f"{summary['host_cores']} cores, pinned {summary['pinned']}; on {cards} card(s) the "
          f"sizes beyond it share cuda:0 over gloo: a protocol and overhead check, not scaling")
    for r in rows:
        print(f"  {r['n_devices']} rank(s), mesh {tuple(r['mesh'])}, {r['backend']}, "
              f"{r['cards']} card(s), oversubscribed {r['oversubscribed']}: step "
              f"{r['step_ms']} ms, {r['realtime_x_per_device']}x real time a rank, halo "
              f"{r['collective_ms']} ms an exchange ({r['collective_fraction']} of the step)")
    print(f"  two processes over gloo: step {gloo['step_ms']} ms, halo {gloo['collective_ms']} "
          f"ms; summary: " + json.dumps({k: v for k, v in summary.items()
                                          if k not in ("results", "two_process_gloo")}))
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s in all [{card}]")
    return {"bench_launches": launches, "bench": line, "bench_in_process": in_process,
            "scaling": summary}


def decode_capture(n_frames: int):
    """Phase 9's input: the bench multiplex (bench_capture: six 108-CU EEP
    3-A subchannels, the bench's spec and seeds) with a DAB+ stream on each
    subchannel (superframes of seeded random AUs, subchannel 1's led by PAD
    with a label and a slide), so that the decode's AU files carry a known
    payload; then DECODE_IMP: CFO 3,400 Hz (3 carrier bins and 400 Hz),
    7,777 samples of delay, 15 dB SNR, one echo inside the guard interval.
    Returns (complex64 IQ, {subch id: the AUs in order})."""
    streams, aus = {}, {}
    for c in bench_subchannels():
        streams[c.subch_id], aus[c.subch_id] = dabplus_stream(
            c.data_bits // 24, 4 * n_frames, seed=20 + c.subch_id, with_pad=c.subch_id == 1)
    frames, _ = bench_capture(n_frames, streams)
    return apply_impairments(frames.reshape(-1), Impairments(**DECODE_IMP)), aus


def write_iq(iq: np.ndarray, path: str) -> None:
    """Interleaved f32 I/Q, the decode's --format f32."""
    np.stack([iq.real, iq.imag], axis=-1).astype(np.float32).tofile(path)


def read_aus(data: bytes) -> list:
    """A subch<N>.aac.raw file's AUs (each behind its 4-byte LE length)."""
    aus, pos = [], 0
    while pos < len(data):
        n = int.from_bytes(data[pos: pos + 4], "little")
        aus.append(data[pos + 4: pos + 4 + n])
        pos += 4 + n
    return aus


def cli_run(argv, traced: bool = False):
    """One `python -m tpudab_torch.host.cli` command in this process, its
    printed lines captured, with the decode path's launch counts set to 0
    just before and read just after. traced: under torch.profiler (CUPTI,
    device activity only), for the device busy time; an untraced run gives
    the wall. Returns (lines, wall s, launches, device busy s or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for name in DECODE_KERNELS:
        KERNELS[name][2].launches = 0
    out = io.StringIO()
    prof = profile(activities=[ProfilerActivity.CUDA]) if traced else contextlib.nullcontext()
    with prof, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(rc == 0, f"{argv}: exit code {rc}")
    launches = {name: KERNELS[name][2].launches for name in DECODE_KERNELS}
    busy = sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type == DeviceType.CUDA) / 1e6 if traced else None
    return out.getvalue().splitlines(), wall, launches, busy


def decode_files(lines, out_dir: str, n_frames: int, label: str):
    """Gate of one decode run: every FIB CRC passes. Returns its payload
    files (no .wav is written: PCM is not ported)."""
    fic = [ln for ln in lines if ln.startswith("FIC:")]
    require(fic == [f"FIC: {12 * n_frames} FIBs, 0 CRC errors"],
            f"{label}: FIB CRC not 1.0: {fic}")
    return {f.name: f.read_bytes() for f in sorted(Path(out_dir).iterdir())}


def card_acquisition(dev, iq, label: str):
    """acquire_host on the capture's first four frames (one copy to the
    card, one read back; a warm-up call first builds the cuFFT plans),
    held to the port's numpy oracle acquire_np on the same samples: frame
    start and coarse bins equal, net frequency within ORACLE_HZ; and to
    the capture as made (DECODE_IMP's delay and carrier bins). Returns
    (acquire_host's dict, its host ms, acquire_np's dict, its host ms)."""
    n = 4 * get_ofdm_params(1).nb_frame_length
    delay = DECODE_IMP["delay_samples"]
    acquire_host(iq[:n], device=dev)
    t0 = time.perf_counter()
    res = acquire_host(iq[:n], device=dev)
    host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = acquire_np(iq[:n])
    np_ms = (time.perf_counter() - t0) * 1e3
    require(res["frame_start"] == ref["frame_start"] and res["coarse_bins"] == ref["coarse_bins"]
            and abs(res["net_freq_hz"] - ref["net_freq_hz"]) < ORACLE_HZ,
            f"{label} acquisition: the card's frame_start {res['frame_start']}, coarse_bins "
            f"{res['coarse_bins']}, net {res['net_freq_hz']} Hz against acquire_np's "
            f"{ref['frame_start']}, {ref['coarse_bins']}, {ref['net_freq_hz']} Hz")
    bins = int(DECODE_IMP["freq_offset_hz"] // (SAMPLING_RATE / get_ofdm_params(1).nb_fft))
    require(res["frame_start"] == delay and res["coarse_bins"] == bins,
            f"{label} acquisition: frame_start {res['frame_start']} (want {delay}), coarse_bins "
            f"{res['coarse_bins']} (want {bins})")
    return res, host_ms, ref, np_ms


def check_acquisition(dev, iq, card):
    """Phase 9, acquisition: card_acquisition on the capture's first four
    frames, then acquire_device on ACQ_BATCH buffers cut from the capture
    ACQ_STRIDE samples apart (the 32-ensemble layout of the step), each
    with its own frame start."""
    fl = get_ofdm_params(1).nb_frame_length
    n, delay = 4 * fl, DECODE_IMP["delay_samples"]
    res, host_ms, ref, np_ms = card_acquisition(dev, iq, "decode path")
    bins = res["coarse_bins"]
    x = torch.from_numpy(np.stack([iq[k * ACQ_STRIDE: k * ACQ_STRIDE + n]
                                   for k in range(ACQ_BATCH)])).to(dev)
    re, im = x.real.contiguous(), x.imag.contiguous()
    out = acquire_device(re, im)
    want = [(delay - k * ACQ_STRIDE) % fl for k in range(ACQ_BATCH)]
    require(out["frame_start"].tolist() == want and (out["coarse_bins"] == bins).all().item(),
            f"batched acquisition: frame_start {out['frame_start'].tolist()} (want {want}), "
            f"coarse_bins {out['coarse_bins'].tolist()}")
    ms1 = cuda_ms(lambda: acquire_device(re[:1], im[:1]), 5)
    ms32 = cuda_ms(lambda: acquire_device(re, im), 5)
    print(f"decode path acquisition [{card}]: frame_start {res['frame_start']}, coarse_bins "
          f"{res['coarse_bins']}, net {res['net_freq_hz']:.3f} Hz (CFO "
          f"{DECODE_IMP['freq_offset_hz']} Hz), time quality {res['time_quality']:.1f}; "
          f"acquire_host {host_ms:.2f} ms host wall (copy and read-back included); the "
          f"numpy oracle acquire_np: net {ref['net_freq_hz']:.3f} Hz ("
          f"{res['net_freq_hz'] - ref['net_freq_hz']:+.4f} Hz from the card's, bound "
          f"{ORACLE_HZ} Hz), same frame start and coarse bins, {np_ms:.1f} ms host; "
          f"acquire_device B=1 {ms1:.3f} ms, B={ACQ_BATCH} {ms32:.3f} ms "
          f"({ms32 / ACQ_BATCH:.3f} ms a buffer; {n} samples each; CUDA events); the "
          f"{ACQ_BATCH} frame starts and coarse bins as cut")
    return {"acquire_host_ms": host_ms, "acquire_np_ms": np_ms,
            "acquire_np_net_freq_hz": ref["net_freq_hz"], "acquire_device_ms_b1": ms1,
            f"acquire_device_ms_b{ACQ_BATCH}": ms32}, res


def check_step_leg(dev, iq, acq, card, nf: int = DECODE_BATCH, label: str = "decode") -> None:
    """Phases 9 and 10, the step's kernels at the shapes the step gives them
    at E = 1 and F = nf (DECODE_BATCH in `decode`, STREAM_BATCH in the live
    loop), f32 frames, each wrapper beside its twin on the same inputs: a
    step batch of the capture cut as the pipeline cuts it (from the
    acquired frame start, at the acquired frequency), with the carry that
    the batch before it leaves. K5 with the sum, bit-equal to the tables
    twin and within 1 bf16 ulp of carve_rotate_ref; K4 mode (b) for the FIC
    and each subchannel of the MSC group, Viterbi input and new carries
    bit-equal; K1+K2 on the FIC (B = 4 nf) and the group (B = 24 nf),
    bytes equal."""
    fl = get_ofdm_params(1).nb_frame_length
    dab = get_dab_params(1)
    t0 = time.perf_counter()
    step = ReceiveStep(1, bench_subchannels()).to(dev)   # as StepDriver.new_step builds it
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def frames(k):
        pos = acq["frame_start"] + k * nf * fl
        x = torch.from_numpy(np.ascontiguousarray(iq[pos: pos + nf * fl])).to(dev)
        return (x.real.reshape(nf, fl // 128, 128).contiguous(),
                x.imag.reshape(nf, fl // 128, 128).contiguous())
    freq = torch.tensor(acq["net_freq_hz"], dtype=torch.float32, device=dev)
    carry, _ = step(step.init_carry(dev), *frames(0), freq)
    re, im = frames(1)

    xr, xi, xs = carve_rotate_cuda(re, im, freq, with_sum=True)
    tr, ti, ts = carve_rotate_tables_ref(re, im, freq, with_sum=True)
    rr, ri = carve_rotate_ref(re, im, freq)
    where = f"{label} step leg (F={nf})"
    require(same_bits(xr, tr) and same_bits(xi, ti) and same_bits(xs, ts),
            f"{where}: K5 on f32 frames differs from carve_rotate_tables_ref")
    ulps = bf16_ulp_err(xr, xi, rr, ri)
    require(ulps <= 1.0, f"{where}: K5 is {ulps} bf16 ulp from carve_rotate_ref")

    soft, _ = demod_frames_split(re, im, freq, (step.dft_re, step.dft_sum, step.dft_diff),
                                 out_dtype=step.soft_dtype)
    signs = signs_on(dev)

    def chain_and_decode(part, profile, n_codewords, calls):
        """calls: (rows, carry, col0) of each K4 launch into one Viterbi input."""
        index, n_punct, _ = step._viterbi_input(soft, profile, n_codewords)
        outs = [soft.new_zeros((index.shape[0] // 8, 8, n_codewords)) for _ in range(2)]
        for rows, c0, col0 in calls:
            got = deinterleave_depuncture_t_cuda(soft, rows, c0, index, n_punct, outs[0], col0)
            want = deinterleave_depuncture_t_ref(soft, rows, c0, index, n_punct, outs[1], col0)
            require(c0 is None or same_bits(got, want),
                    f"{where}: K4 mode (b) {part}: the new carry differs from the twin")
        require(same_bits(outs[0], outs[1]),
                f"{where}: K4 mode (b) {part}: the Viterbi input differs from the twin")
        got = viterbi_decode_bytes_t_cuda(outs[0], signs, profile.data_bits)
        want = viterbi_decode_bytes_t_ref(outs[0], signs, profile.data_bits)
        require(torch.equal(got, want), f"{where}: K1+K2 {part}: "
                f"{(got != want).sum().item()} bytes differ from the plain decoder")
        return tuple(outs[0].shape)

    g = dab.nb_fib_groups
    shapes = [chain_and_decode("FIC", step.fic_profile, nf * g, [
        (SoftRows.fib_groups(g, dab.nb_fic_bits_per_group), None, 0)])]
    c = nf * dab.nb_cifs
    for (profile, slice_bits, _), cfgs in step.groups.items():
        shapes.append(chain_and_decode(f"MSC group of {len(cfgs)}", profile, len(cfgs) * c, [
            (SoftRows.cif_slices(dab.nb_fic_bits, dab.nb_cifs, cfg.start_cu * CU_BITS,
                                 slice_bits), carry[f"deint_{cfg.subch_id}"], i * c)
            for i, cfg in enumerate(cfgs)]))
    print(f"{label} path step leg (E=1, F={nf}) [{card}]: ReceiveStep built in {build_s:.3f} s; "
          f"K5 on f32 frames {tuple(re.shape)} with xs bit-equal to the tables twin, max "
          f"{ulps:.0f} bf16 ulp from carve_rotate_ref; K4 mode (b) and K1+K2 on the Viterbi "
          f"inputs {shapes} (FIC, then each MSC group): inputs, carries and bytes equal")


def run_decode_path(dev, card, n_frames: int = DECODE_FRAMES):
    """Phase 9: `python -m tpudab_torch.host.cli decode` on the impaired
    bench multiplex, with and without --device-step, then split into a
    --checkpoint and a --resume run, and `info`. The walls come from
    untraced runs in the order step, host, host, step (so neither leg alone
    pays the first call's costs); the device busy time from one traced run
    of each leg."""
    t_phase = time.perf_counter()
    fl = get_ofdm_params(1).nb_frame_length
    signal_s = n_frames * fl / SAMPLING_RATE
    t0 = time.perf_counter()
    iq, aus = decode_capture(n_frames)
    print(f"decode path synth: {n_frames} frames, impaired, in {time.perf_counter() - t0:.1f} s")
    numbers, acq = check_acquisition(dev, iq, card)
    check_step_leg(dev, iq, acq, card)
    batch = torch.from_numpy(np.ascontiguousarray(iq[:DECODE_BATCH * fl]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch.to(dev)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    print(f"decode path [{card}]: one {DECODE_BATCH}-frame batch to the card, "
          f"{batch.numel() * 8 / 1e6:.1f} MB complex64 from pageable memory "
          f"(torch.from_numpy(...).to), {copy_ms:.2f} ms "
          f"({batch.numel() * 8 / copy_ms / 1e6:.2f} GB/s)")
    numbers["h2d_batch_ms"] = copy_ms
    # the first complete superframes, from logical frame 0 on
    n_aus = 6 * ((4 * n_frames - 15) // 5)
    legs = {"step": ["--device-step"], "host": []}
    runs = {"step": [], "host": []}
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "capture.f32")
        write_iq(iq, cap)
        lines, *_ = cli_run(["info", cap])
        print("info: " + "; ".join(lines))
        order = [("step", False), ("host", False), ("host", False), ("step", False),
                 ("step", True), ("host", True)]
        for k, (label, traced) in enumerate(order):
            out = os.path.join(tmp, f"run{k}")
            lines, wall, launches, busy = cli_run(
                ["decode", cap, *legs[label], "--batch-frames", str(DECODE_BATCH),
                 "--out-dir", out], traced)
            files = decode_files(lines, out, n_frames, f"{label} run {k}")
            got = read_aus(files["subch1.aac.raw"])
            require(got[:n_aus] == aus[1][:n_aus] and len(got) == n_aus,
                    f"decode {label} run {k}: {len(got)} AUs of subchannel 1, want the first "
                    f"{n_aus} of the payload")
            runs[label].append({"files": files, "wall": wall, "launches": launches,
                                "busy": busy, "lines": lines})
        one = runs["step"][0]["files"]
        require(all(r["files"] == one for rs in runs.values() for r in rs),
                "decode runs with and without --device-step wrote different payload files")
        for label, rs in runs.items():
            walls = [r["wall"] for r in rs if r["busy"] is None]
            tr = next(r for r in rs if r["busy"] is not None)
            wall = sum(walls) / len(walls)
            require(all(r["launches"] == tr["launches"] for r in rs),
                    f"decode {label}: launches differ between runs")
            print(f"decode {' '.join(legs[label]) or '(host leg only)'} [{card}]: wall "
                  + ", ".join(f"{w:.3f}" for w in walls) + f" s untraced (mean {wall:.3f}) "
                  f"for {signal_s:.3f} s of signal, real-time factor {signal_s / wall:.2f}; "
                  f"traced run: wall {tr['wall']:.3f} s, device busy {tr['busy']:.3f} s "
                  f"(share {tr['busy'] / tr['wall']:.4f}); launches {tr['launches']}; FIB CRC "
                  f"1.0; subchannel 1's {n_aus} AUs byte-equal")
            numbers[f"decode_{label}_wall_s"] = walls
            for ln in tr["lines"]:
                if ln.startswith(("Sync:", "Ensemble:")):
                    print(f"  {ln}")
        step_l, host_l = runs["step"][0]["launches"], runs["host"][0]["launches"]
        require(all(step_l.values()), f"decode --device-step left a kernel unlaunched: {step_l}")
        require(host_l["deinterleave_depuncture_t"] == host_l["viterbi_fwd_traceback"] == 0
                and host_l["viterbi_bits"] and host_l["deinterleave"] and host_l["carve_rotate"],
                f"the host leg's launches: {host_l}")
        print(f"decode: {len(one)} payload files identical in all "
              f"{sum(map(len, runs.values()))} runs with and without --device-step: "
              f"{sorted(one)}")

        split = DECODE_IMP["delay_samples"] + DECODE_SPLIT * fl
        parts = [os.path.join(tmp, name) for name in ("a.f32", "b.f32")]
        write_iq(iq[:split], parts[0])
        write_iq(iq[split:], parts[1])
        ck = os.path.join(tmp, "state")
        outs = [os.path.join(tmp, name) for name in ("out_a", "out_b")]
        common = ["--device-step", "--batch-frames", str(DECODE_BATCH)]
        la, wa, *_ = cli_run(["decode", parts[0], *common, "--checkpoint", ck,
                              "--out-dir", outs[0]])
        require(f"Checkpoint -> {ck} (next_pos={split})" in la,
                f"checkpoint: {[ln for ln in la if 'Checkpoint' in ln]} (want next_pos {split})")
        lb, wb, *_ = cli_run(["decode", parts[1], *common, "--resume", ck, "--out-dir", outs[1]])
        fa = decode_files(la, outs[0], DECODE_SPLIT, "checkpoint")
        fb = decode_files(lb, outs[1], n_frames - DECODE_SPLIT, "resume")
        for name, data in one.items():
            if name.endswith(".aac.raw"):
                require(read_aus(fa.get(name, b"")) + read_aus(fb.get(name, b""))
                        == read_aus(data), f"checkpoint + resume: {name} differs from one run")
        print(f"decode --checkpoint ({DECODE_SPLIT} frames, {wa:.3f} s) then --resume "
              f"({n_frames - DECODE_SPLIT} frames, {wb:.3f} s): FIB CRC 1.0 in both; every "
              f"subchannel's AUs, concatenated, equal the one-shot run's")
    numbers["decode_launches"] = {"step": step_l, "host": host_l}
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s in all")
    return numbers, iq, aus, acq

def stream_run(path: str, traced: bool = False, **kw):
    """Phase 10: one StreamingRadio on the card over a capture file, read by
    the port's native IQReader (its ring, as `stream` reads it), with the
    decode path's launch counts set to 0 just before and read just after.
    traced: under torch.profiler (CUDA activity), for the device busy time.
    Returns (radio, {subch id: (raw frames, AUs)}, wall s, launches, busy s
    or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpudab_torch.host.native_lib import IQReader
    from tpudab_torch.host.streaming import StreamingRadio

    torch.cuda.synchronize()
    for name in DECODE_KERNELS:
        KERNELS[name][2].launches = 0
    outs = collections.defaultdict(lambda: ([], []))

    def collect(outputs):
        for sid, o in outputs.items():
            if o.raw_frames is not None and len(o.raw_frames):
                outs[sid][0].append(np.asarray(o.raw_frames))
            outs[sid][1].extend(bytes(au) for sf in o.superframes for au in sf.access_units)

    prof = profile(activities=[ProfilerActivity.CUDA]) if traced else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        reader = IQReader(path)
        radio = StreamingRadio(reader.ring.read_complex64, batch_frames=STREAM_BATCH,
                               device="cuda", **kw)
        radio.run(on_outputs=collect)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reader.close()
    launches = {name: KERNELS[name][2].launches for name in DECODE_KERNELS}
    busy = sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type == DeviceType.CUDA) / 1e6 if traced else None
    got = {sid: (np.concatenate(f) if f else np.zeros((0, 0), np.uint8), a)
           for sid, (f, a) in outs.items()}
    return radio, got, wall, launches, busy


def tap_ms(dev, iq, freq_hz: float, reps: int = 20) -> dict:
    """Host ms of one call of each tracking tap of ofdm/sync_device.py (its
    launches and its one read back) on the segments of one frame of the
    capture that the live loop hands it, at the acquired frequency. Run
    before the stream runs, it also builds the taps' cuFFT plans."""
    from tpudab_torch.ofdm.sync_device import (coarse_freq_device, fine_freq_device,
                                               fine_time_sync_device)

    p = get_ofdm_params(1)
    pos = DECODE_IMP["delay_samples"] + 10 * p.nb_frame_length
    x = torch.from_numpy(np.ascontiguousarray(iq[pos: pos + p.nb_frame_length])).to(dev)
    re, im = x.real.contiguous()[None], x.imag.contiguous()[None]
    prs = p.nb_null_period + p.nb_cyclic_prefix
    body, seg = slice(prs, prs + p.nb_fft), slice(prs - 64, prs + 64 + p.nb_fft)
    taps = {
        "fine_freq": lambda: (fine_freq_device(re, im, freq_hz),),
        "coarse": lambda: coarse_freq_device(re[:, body], im[:, body], freq_hz),
        "timing": lambda: fine_time_sync_device(re[:, seg], im[:, seg], freq_hz),
    }
    out = {}
    for name, tap in taps.items():
        for k in range(reps + 1):
            if k == 1:
                t0 = time.perf_counter()
            torch.cat([t.reshape(-1).double() for t in tap()]).tolist()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


@contextlib.contextmanager
def first_inputs(module, name: str, store: dict, key=None):
    """While open, module.name (a dispatcher as a caller's module sees it,
    never a wrapper: a wrapper counts its launches on its own name) keeps a
    copy of its positional arguments (tensors cloned) at the first call of
    each key, by default the first argument's shape and dtype and the other
    non-tensor arguments, then runs as it did: the inputs the path gave
    that kernel, held against its twin afterwards."""
    fn = getattr(module, name)
    key = key or (lambda x, *args: (tuple(x.shape), x.dtype,
                                    *(a for a in args if not torch.is_tensor(a))))

    def recorded(*args, **kw):
        k = key(*args)
        if k not in store:
            store[k] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        return fn(*args, **kw)
    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, fn)


def check_host_leg_inputs(k3: dict, k4: dict, card: str) -> None:
    """Phase 10, the host path's kernels at the live loop's shapes: K1+K3
    and K4 mode (a) on the inputs the stream's host run gave them (the first
    of each shape), bit-equal to viterbi_decode_ref and deinterleave_ref."""
    require(k3 and k4 and all(v[0].is_cuda for v in (*k3.values(), *k4.values())),
            f"stream host run: no K1+K3 ({len(k3)}) or K4 (a) ({len(k4)}) input on the card kept")
    for x, n in k3.values():
        x, signs = x.contiguous(), signs_on(x.device)
        got, want = viterbi_decode_bits_cuda(x, signs, n), viterbi_decode_ref(x, signs, n)
        require(torch.equal(got, want), f"stream host leg: K1+K3 {tuple(x.shape)}: "
                f"{(got != want).sum().item()} bits differ from viterbi_decode_ref")
    for buf, c in k4.values():
        require(torch.equal(deinterleave_cuda(buf, c), deinterleave_ref(buf, c)),
                f"stream host leg: K4 mode (a) {tuple(buf.shape)} differs from deinterleave_ref")
    print(f"stream path host leg [{card}]: K1+K3 on its inputs "
          + ", ".join(f"{tuple(x.shape)} {str(x.dtype)[6:]}" for x, *_ in k3.values())
          + " bits equal to viterbi_decode_ref; K4 mode (a) on "
          + ", ".join(f"{tuple(b.shape)} {str(b.dtype)[6:]}" for b, _ in k4.values())
          + " equal to deinterleave_ref (the first input of each shape in the host run)")


def read_wav(path: str):
    import wave
    with wave.open(path) as w:
        return w.getnchannels(), w.getframerate(), np.frombuffer(
            w.readframes(w.getnframes()), np.int16)


def codec_capture(n_frames: int):
    """A one-service multiplex whose DAB+ subchannel (96 kbps EEP 3-A, 72
    CU) carries AAC of a tone swept about 550 Hz from the port's encoder,
    without PAD (synth/payload.py::demo_dabplus_stream); CFO 1,500 Hz,
    2,000 samples of delay, 20 dB."""
    from tpudab_torch.synth.payload import demo_dabplus_stream
    spec = EnsembleSpec(0xA0AC, "AAC Mux", [ServiceSpec(0xC2A1, "Tone+", [(0, ASCTY_DAB_PLUS, 1)])],
                        [SubchannelSpec(1, start_cu=0, size_cu=72, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=4)
    stream, _ = demo_dabplus_stream(96, 4 * n_frames + 20, with_pad=False)
    synth.payload_fn[1] = lambda m: stream[m].tobytes()
    iq = np.concatenate([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)])
    return apply_impairments(iq, Impairments(freq_offset_hz=1500.0, delay_samples=2000,
                                             snr_db=20, seed=5))


def run_stream_path(dev, card, iq, aus, acq):
    """Phase 10: the live loop (tpudab_torch.host.streaming.StreamingRadio)
    on phase 9's capture, read from an f32 file by the native IQReader, on
    the card: on the device step (the default) and on the host path
    (use_device_step=False). First each tracking tap alone (which also
    builds its cuFFT plans) and the step's kernels against their twins at
    F = STREAM_BATCH; then untraced runs in the order step, host, host, step
    for the walls (so neither path alone pays the first run's costs), and
    one traced run of each for the device busy time; the first host run
    keeps the first input of each shape that K1+K3 and K4 (a) get, held
    against their twins afterwards. Gates, on every run: every FIB CRC
    passes and no reacquisition; each subchannel's AUs are the payload's,
    in order, from the first that decodes on; the step built on the step
    path only; each path launched its kernels, the same in each of its
    runs; all runs' frames and AUs byte-equal. Then `python -m
    tpudab_torch.host.cli stream CAP --no-dashboard --wav` must exit 0 with
    a WAV of one mix block a batch; and the codec line: where the codec
    probe finds FFmpeg, `stream` of a capture whose DAB+ service carries AAC
    of a tone, on each path, must write equal WAVs with an RMS above
    CODEC_RMS_FLOOR; where it does not, the WAV above must be silent."""
    from tpudab_torch.fic import fib
    from tpudab_torch.host.native_lib import ffmpeg_probe
    from tpudab_torch.msc import subchannel

    t_phase = time.perf_counter()
    fl = get_ofdm_params(1).nb_frame_length
    n_frames = DECODE_FRAMES
    signal_s = n_frames * fl / SAMPLING_RATE
    n_aus = 6 * ((4 * n_frames - 15) // 5)
    taps = tap_ms(dev, iq, acq["net_freq_hz"])
    print(f"stream tracking taps [{card}]: alone, " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in taps.items()) + " a call (host clock, its launches and "
        "its one read back, on one frame's segments)")
    check_step_leg(dev, iq, acq, card, STREAM_BATCH, "stream")
    runs = {"step": [], "host": []}
    k3, k4 = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "capture.f32")
        write_iq(iq, cap)
        for label, traced in (("step", False), ("host", False), ("host", False),
                              ("step", False), ("step", True), ("host", True)):
            with contextlib.ExitStack() as keep:
                if label == "host" and not runs["host"]:
                    keep.enter_context(first_inputs(fib, "viterbi_decode_best", k3))
                    keep.enter_context(first_inputs(subchannel, "viterbi_decode_best", k3))
                    keep.enter_context(first_inputs(subchannel, "deinterleave_batch", k4))
                runs[label].append(stream_run(cap, traced, **STREAM_PATHS[label][0]))
        check_host_leg_inputs(k3, k4, card)
        first = runs["step"][0][1]
        for label, rs in runs.items():
            for radio, got, wall, launches, _ in rs:
                rx = radio.receiver.stats
                require(rx["fibs"] == 12 * n_frames and rx["fib_crc_errors"] == 0
                        and radio.stats.total_frames == n_frames
                        and radio.stats.reacquisitions == 0,
                        f"stream {label}: FIB CRC not 1.0 or a lost lock: {rx}, {radio.stats}")
                for sid, want in aus.items():
                    a = got[sid][1]
                    k0 = want.index(a[0]) if a and a[0] in want else -1
                    require(k0 >= 0 and a == want[k0: k0 + len(a)] and len(a) >= n_aus,
                            f"stream {label}: subchannel {sid}: {len(a)} AUs from payload AU "
                            f"{k0}, want at least {n_aus} in order")
                require((radio._driver.step is not None) == (label == "step"),
                        f"stream {label}: the receive step was {'not ' * (label == 'step')}built")
                require(launches == rs[0][3], f"stream {label}: launches differ between runs: "
                        f"{launches}, {rs[0][3]}")
                require(got.keys() == first.keys() and all(
                    np.array_equal(got[k][0], first[k][0]) and got[k][1] == first[k][1]
                    for k in got), f"stream {label}: a run decoded other bytes than the first")
            launches = rs[0][3]
            require(all(launches[k] for k in STREAM_KERNELS[label])
                    and (label == "step" or not any(launches[k] for k in STREAM_KERNELS["step"]
                                                    if k != "carve_rotate")),
                    f"stream {label}: launches {launches}")
            walls = [r[2] for r in rs if r[4] is None]
            tr = next(r for r in rs if r[4] is not None)
            summs = [r[0].timers.summary() for r in rs if r[4] is None]
            track = [v["track"]["seconds"] / v["track"]["calls"] * 1e3 for v in summs]
            print(f"stream {label} path [{card}]: wall " + ", ".join(f"{w:.3f}" for w in walls)
                  + f" s untraced for {signal_s:.3f} s of signal, real-time factor "
                  + ", ".join(f"{signal_s / w:.2f}" for w in walls) + f"; traced rerun: wall "
                  f"{tr[2]:.3f} s, device busy {tr[4]:.3f} s (share {tr[4] / tr[2]:.4f}); "
                  f"launches {launches}; FIB CRC 1.0 over {12 * n_frames} FIBs; "
                  f"{min(len(g[1]) for g in rs[0][1].values())} AUs or more a subchannel, "
                  f"in order")
            for summ in summs:
                print(f"  stages [{card}]: " + "; ".join(
                    f"{k} {v['seconds']:.3f} s x{v['calls']} ({1e3 * v['seconds'] / v['calls']:.2f} "
                    f"ms a call)" for k, v in sorted(summ.items(), key=lambda kv: -kv[1]["seconds"])))
            print(f"  track stage [{card}]: " + ", ".join(f"{t:.2f}" for t in track)
                  + " ms a batch (StageTimer, each untraced run in order)")
            runs[label] = {"wall": walls, "rtf": [signal_s / w for w in walls],
                           "traced_wall": tr[2], "busy": tr[4], "launches": launches,
                           "stages": summs, "track_ms": track}
        print(f"stream: all {len(runs) * 3} runs byte-equal over {len(first)} subchannels "
              f"({sum(len(g[0]) for g in first.values())} frames, "
              f"{sum(len(g[1]) for g in first.values())} AUs)")
        runs["taps_ms"] = taps

        # the command line, as a user runs it
        mix = os.path.join(tmp, "mix.wav")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tpudab_torch.host.cli", "stream", cap,
                               "--no-dashboard", "--wav", mix], capture_output=True, text=True,
                              timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"stream CLI: exit {proc.returncode}\n{proc.stderr[-2000:]}")
        block = int(48_000 * 0.096 * STREAM_BATCH)
        batches = -(-n_frames // STREAM_BATCH)
        ch, rate, pcm = read_wav(mix)
        require((ch, rate, pcm.size) == (2, 48_000, 2 * batches * block),
                f"stream CLI: WAV of {ch} channels at {rate} Hz, {pcm.size // 2} frames "
                f"(want {batches * block})")
        print(f"stream CLI [{card}]: `python -m tpudab_torch.host.cli stream CAP --no-dashboard "
              f"--wav mix.wav` exit 0 in {cli_s:.1f} s (process start, imports and the build "
              f"check included); WAV {batches} x {block} stereo frames; "
              f"{proc.stdout.strip().splitlines()[-1]}")

        found, what = ffmpeg_probe()
        if found:
            n = CODEC_FRAMES
            codec_cap = os.path.join(tmp, "aac.f32")
            write_iq(codec_capture(n), codec_cap)
            wavs = {}
            for label, (_, flags) in STREAM_PATHS.items():
                wavs[label] = os.path.join(tmp, f"aac_{label}.wav")
                lines, wall, _, _ = cli_run(["stream", codec_cap, "--no-dashboard", "--wav",
                                             wavs[label], *flags])
                require(f"stopped: {n} frames, 0 reacquisitions" in lines,
                        f"codec stream {label}: {lines[-1:]}")
            pcm = {label: read_wav(w)[2] for label, w in wavs.items()}
            rms = float(np.sqrt(np.mean(pcm["step"].astype(np.float64) ** 2)))
            require(np.array_equal(pcm["step"], pcm["host"]) and rms > CODEC_RMS_FLOOR
                    and pcm["step"].size == 2 * -(-n // STREAM_BATCH) * block,
                    f"codec stream: WAVs equal {np.array_equal(pcm['step'], pcm['host'])}, "
                    f"RMS {rms:.1f} (floor {CODEC_RMS_FLOOR}), {pcm['step'].size // 2} frames")
            print(f"codec probe: FFmpeg found ({what}); `stream` of a {n}-frame capture whose "
                  f"DAB+ service carries AAC of a 550 Hz tone: WAVs of the step and host paths "
                  f"equal, {pcm['step'].size // 2} stereo frames, RMS {rms:.1f} "
                  f"(floor {CODEC_RMS_FLOOR}), peak {int(np.abs(pcm['step']).max())}")
        else:
            require(not pcm.any(), "stream CLI: no FFmpeg, yet the WAV is not silent")
            print(f"codec probe: no FFmpeg ({what}): no PCM is decoded; the CLI's WAV is "
                  f"{pcm.size // 2} stereo frames of silence, as it must be")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s in all")
    return {"stream_launches": {k: runs[k]["launches"] for k in STREAM_PATHS}, "stream": runs}


def shard_kernel_checks(k5: dict, k4: dict, k12: dict) -> list:
    """Phase 11 (b), on rank 1, the rank that takes a halo: K5, K4 mode (b)
    and K1+K2 on the first inputs the sharded step gave them (K5: the edge
    and the interior demod; K4: the FIC and the first subchannel, whose
    carry is the halo; K1+K2: the FIC and the MSC group), each bit-equal to
    its plain version. Returns what was checked."""
    require(len(k5) == 2 and len(k4) == 2 and len(k12) == 2,
            f"sharded rank 1 kept {len(k5)} K5, {len(k4)} K4 (b), {len(k12)} K1+K2 inputs")
    done = []
    for re, im, freq, mode, offset in k5.values():
        got = carve_rotate_cuda(re, im, freq, mode, offset, with_sum=True)
        want = carve_rotate_tables_ref(re, im, freq, mode, offset, with_sum=True)
        require(all(same_bits(a, b) for a, b in zip(got, want)),
                f"sharded rank 1: K5 {tuple(re.shape)} differs from carve_rotate_tables_ref")
        done.append(f"K5 {tuple(re.shape)} {str(re.dtype)[6:]} with xs")
    for soft, rows, carry, index, n_punct, out, *col0 in k4.values():
        outs = [torch.zeros_like(out) for _ in range(2)]
        got = deinterleave_depuncture_t_cuda(soft, rows, carry, index, n_punct, outs[0], *col0)
        want = deinterleave_depuncture_t_ref(soft, rows, carry, index, n_punct, outs[1], *col0)
        part = "FIC" if carry is None else f"MSC {tuple(carry.shape)} carry (the halo)"
        require(same_bits(outs[0], outs[1]) and (carry is None or same_bits(got, want)),
                f"sharded rank 1: K4 mode (b) {part} differs from its twin")
        done.append(f"K4 (b) {part} -> {tuple(out.shape)}")
    for soft_t, signs, n_bits in k12.values():
        got = viterbi_decode_bytes_t_cuda(soft_t, signs, n_bits)
        want = viterbi_decode_bytes_t_ref(soft_t, signs, n_bits)
        require(torch.equal(got, want), f"sharded rank 1: K1+K2 {tuple(soft_t.shape)}: "
                f"{(got != want).sum().item()} bytes differ from the plain decoder")
        done.append(f"K1+K2 {tuple(soft_t.shape)} {str(soft_t.dtype)[6:]}")
    return done


def sharded_rank(rank: int, world: int, port: int, frames: np.ndarray, out_dir: str,
                 device: str) -> None:
    """Phase 11 (b), one rank (a spawned process) of a gloo world on
    `device` (cuda:0 for every rank): mesh (1, world), E = N_ENS (each ensemble the same capture),
    SHARD_FRAMES frames a rank, SHARD_CALLS chained calls, the halo staged
    through host memory. The launch counts are set to 0 just before the
    calls and read just after; rank 1 keeps the first inputs of K5, K4 (b)
    and K1+K2 and holds each kernel against its twin on them afterwards.
    Rank 0 saves the gathered outputs of each call, every rank its
    launches, walls and exchanges."""
    import datetime

    import torch.distributed as dist

    from tpudab_torch.models import step as step_mod
    from tpudab_torch.ofdm import demod as demod_mod
    from tpudab_torch.parallel import ShardedReceiveStep, make_mesh

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False   # as identify()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        step = ShardedReceiveStep(make_mesh((1, world)), 1, bench_subchannels(), device=device)
        t_call = world * SHARD_FRAMES
        inputs = [step.shard_inputs(np.broadcast_to(
            frames[None, k * t_call:(k + 1) * t_call], (N_ENS, t_call, frames.shape[-1])),
            np.zeros(N_ENS)) for k in range(SHARD_CALLS)]
        carry = step.init_carry(N_ENS)
        k5, k4, k12 = {}, {}, {}
        walls, exchanges, outs = [], [], []
        with contextlib.ExitStack() as keep:
            if rank == 1:
                keep.enter_context(first_inputs(demod_mod, "carve_rotate", k5,
                                                key=lambda *a: min(len(k5), 1)))
                keep.enter_context(first_inputs(step_mod, "deinterleave_depuncture_t", k4,
                                                key=lambda soft, rows, c, *a: c is None))
                keep.enter_context(first_inputs(step_mod, "viterbi_decode_bytes_t", k12))
            torch.cuda.synchronize()
            for w in KERNELS.values():
                w[2].launches = 0
            for k in range(SHARD_CALLS):
                t0 = time.perf_counter()
                carry, out = step(carry, *inputs[k])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                exchanges.append(dict(step.last_exchange))
                outs.append(out)
            launches = {name: KERNELS[name][2].launches for name in STEP_KERNELS}
        for k, out in enumerate(outs):
            got = step.gather_outputs(out)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"call{k}.npz"),
                         fic=got["fic_bytes"].cpu().numpy(),
                         **{f"subch{sid}": v.cpu().numpy() for sid, v in got["subch"].items()})
        checks = shard_kernel_checks(k5, k4, k12) if rank == 1 else []
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"launches": launches, "walls_ms": walls, "exchange": exchanges,
                       "checks": checks}, f)
    finally:
        dist.destroy_process_group()


def run_sharded_path(dev, card, frames: np.ndarray, payload: np.ndarray):
    """Phase 11: the sharded step (tpudab_torch.parallel) on the card at the
    bench multiplex's full width (bench_subchannels(), the bench's frames).
    (a) In this process, a world of 1 on NCCL, mesh (1, 1), E = N_ENS x F =
    N_FRAMES f32 frames: every FIB CRC, subchannel 1's payload from row 15,
    and fic_bytes and every subchannel byte-equal to a ReceiveStep on the
    same frames; both timed with CUDA events in turns (ReceiveStep,
    sharded, sharded, ReceiveStep). (b) SHARD_RANKS spawned processes on
    cuda:0 (sharded_rank): the gathered outputs of SHARD_CALLS chained
    calls byte-equal to a ReceiveStep run over the same frames in the same
    chained calls, the seam rows included; rank 1's kernels equal to their
    twins on its own inputs. A check of the exchange protocol, not a
    measure of scaling."""
    import datetime

    import torch.distributed as dist

    from tpudab_torch.parallel import ShardedReceiveStep, make_mesh

    t_phase = time.perf_counter()
    subch = bench_subchannels()
    fl = get_ofdm_params(1).nb_frame_length
    rows = fl // 128

    def ref_inputs(part):
        """(E, F, rows, 128) f32 re/im on the card: each ensemble the same frames."""
        return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                     .reshape(1, -1, rows, 128).expand(N_ENS, -1, -1, -1).contiguous()
                     for x in (part.real, part.imag))

    def same_outputs(got, want):
        return (np.array_equal(got["fic"], want["fic_bytes"].cpu().numpy())
                and all(np.array_equal(got[f"subch{c.subch_id}"],
                                       want["subch"][c.subch_id].cpu().numpy()) for c in subch))

    def as_out(got):
        return {"fic_bytes": torch.from_numpy(got["fic"]),
                "subch": {c.subch_id: torch.from_numpy(got[f"subch{c.subch_id}"]) for c in subch}}

    # (a) a world of one on NCCL
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1))
        require(mesh.backend == "nccl", f"the mesh's backend is {mesh.backend}, not nccl")
        sharded = ShardedReceiveStep(mesh, 1, subch, device=dev)
        part = frames[:N_FRAMES]
        re, im, fq = sharded.shard_inputs(np.broadcast_to(part[None], (N_ENS,) + part.shape),
                                          np.zeros(N_ENS))
        step = ReceiveStep(1, subch, n_ensembles=N_ENS).to(dev)
        torch.cuda.synchronize()
        for w in KERNELS.values():
            w[2].launches = 0
        _, out = sharded(sharded.init_carry(N_ENS), re, im, fq)
        torch.cuda.synchronize()
        launches = {name: KERNELS[name][2].launches for name in STEP_KERNELS}
        got = sharded.gather_outputs(out)
        got = {"fic": got["fic_bytes"].cpu().numpy(),
               **{f"subch{k}": v.cpu().numpy() for k, v in got["subch"].items()}}
        for w in KERNELS.values():
            w[2].launches = 0
        _, want = step(step.init_carry(dev), re, im, fq)
        torch.cuda.synchronize()
        step_launches = {name: KERNELS[name][2].launches for name in STEP_KERNELS}
        check_outputs(as_out(got), payload, 0, subch[0].subch_id)
        require(same_outputs(got, want), "sharded (1, 1): outputs differ from ReceiveStep's")
        require(all(launches.values()), f"sharded (1, 1): launches {launches}")
        carries = {"sharded": sharded.init_carry(N_ENS), "step": step.init_carry(dev)}

        def run_step():
            carries["step"], _ = step(carries["step"], re, im, fq)

        def run_sharded():
            carries["sharded"], _ = sharded(carries["sharded"], re, im, fq)
        ms = {"step": [], "sharded": []}
        for label, fn in (("step", run_step), ("sharded", run_sharded), ("sharded", run_sharded),
                          ("step", run_step)):
            ms[label].append(cuda_ms(fn, 5))
        signal_s = N_ENS * N_FRAMES * fl / SAMPLING_RATE
        print(f"sharded (a) [{card}]: NCCL {torch.cuda.nccl.version()}, a world of 1, mesh "
              f"(1, 1), E={N_ENS} x F={N_FRAMES} f32 frames: FIB CRC 1.0, subchannel 1 payload "
              f"byte-equal from row 15, fic_bytes and all {len(subch)} subchannels byte-equal "
              f"to ReceiveStep on the same frames; launches {launches} against ReceiveStep's "
              f"{step_launches} (the extra: "
              f"{ {k: launches[k] - step_launches[k] for k in launches} }, the demod split in "
              f"two); ms a step (CUDA events, in turns): sharded "
              + ", ".join(f"{v:.3f}" for v in ms["sharded"]) + ", ReceiveStep "
              + ", ".join(f"{v:.3f}" for v in ms["step"]) + "; real-time factor sharded "
              + ", ".join(f"{signal_s / (v / 1e3):.1f}" for v in ms["sharded"]) + ", ReceiveStep "
              + ", ".join(f"{signal_s / (v / 1e3):.1f}" for v in ms["step"]))
    finally:
        dist.destroy_process_group()
    del re, im, out, want, step, sharded, carries
    torch.cuda.empty_cache()

    # (b) SHARD_RANKS processes on cuda:0, gloo, the halo through host memory
    n_used = SHARD_RANKS * SHARD_FRAMES * SHARD_CALLS
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            sharded_rank, args=(SHARD_RANKS, free_port(), np.ascontiguousarray(frames[:n_used]),
                                tmp, str(dev)), nprocs=SHARD_RANKS, join=False,
            start_method="spawn")
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                require(time.monotonic() < deadline,
                        f"sharded (b): the {SHARD_RANKS}-rank world outlived {SHARD_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        calls = []
        for k in range(SHARD_CALLS):
            with np.load(os.path.join(tmp, f"call{k}.npz")) as f:
                calls.append(dict(f))
    step = ReceiveStep(1, subch, n_ensembles=N_ENS).to(dev)
    carry = step.init_carry(dev)
    t_call = SHARD_RANKS * SHARD_FRAMES
    c_rank = SHARD_FRAMES * get_dab_params(1).nb_cifs
    for k, got in enumerate(calls):
        carry, want = step(carry, *ref_inputs(frames[k * t_call:(k + 1) * t_call]),
                           torch.zeros(N_ENS, device=dev))
        check_outputs(as_out(got), payload, k, subch[0].subch_id)
        require(same_outputs(got, want), f"sharded (b): call {k}'s gathered outputs differ "
                f"from ReceiveStep's over the same frames")
    for r, rk in enumerate(ranks):
        require(all(rk["launches"].values()), f"sharded (b) rank {r}: launches {rk['launches']}")
    halo = ranks[1]["exchange"][0]["halo_bytes"]
    print(f"sharded (b) [{card}]: {SHARD_RANKS} processes on cuda:0, gloo, mesh (1, "
          f"{SHARD_RANKS}), E={N_ENS}, {SHARD_FRAMES} frames a rank, {SHARD_CALLS} chained "
          f"calls: the gathered fic_bytes and subchannels byte-equal to ReceiveStep over the "
          f"same {t_call} frames a call, chained, every row (the seam rows "
          f"{c_rank}-{c_rank + 14} of each call and call 1's rows 0-14, from the ring's carry, "
          f"among them); FIB CRC 1.0 and the payload from row 15; halo {halo} bytes a call "
          f"({halo / N_ENS / 1e6:.3f} MB an ensemble, bf16); world {world_s:.1f} s with "
          f"process start")
    for r, rk in enumerate(ranks):
        print(f"  rank {r}: launches {rk['launches']}; call walls "
              + ", ".join(f"{v:.1f}" for v in rk["walls_ms"]) + " ms (host clock, synchronised); "
              "exchange " + "; ".join(f"staging {e['stage_ms']:.2f} ms, wait {e['wait_ms']:.2f} ms"
                                      for e in rk["exchange"]))
    print(f"  rank 1 kernels on its own inputs, bit-equal to their twins: "
          + "; ".join(ranks[1]["checks"]))
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s in all")
    return {"sharded_launches": {"world1_nccl": launches,
                                 **{f"rank{r}": rk["launches"] for r, rk in enumerate(ranks)}},
            "sharded_ms": ms, "halo_bytes": halo}


def second_ensemble(n_frames: int):
    """Phase 12's 12D: a second ensemble (its own ID and label), one 96 kbps
    EEP 3-A DAB+ service (72 CU) of seeded random AUs, n_frames whole
    frames, unimpaired, so it loops seamlessly frame by frame. Returns
    (complex64 IQ, its AUs in order)."""
    spec = EnsembleSpec(TCP_EID_D, "Delta Mux", [ServiceSpec(0xC2D1, "Delta+",
                                                             [(0, ASCTY_DAB_PLUS, 1)])],
                        [SubchannelSpec(1, start_cu=0, size_cu=72, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=12)
    stream, aus = dabplus_stream(96, 4 * n_frames, seed=41)
    synth.payload_fn[1] = lambda m: stream[m].tobytes()
    iq = np.concatenate([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)])
    return iq.astype(np.complex64), aus


class RealTime:
    """A server's source callback paced as a dongle streams: no sample is
    handed over before its air time (at TCP_PACE times the sample rate)
    from the first call. (RtlTcpServer alone streams as fast as TCP's
    backpressure lets it, and the client's socket buffers then hold more
    of the old channel than a retune's drain reads: ROADMAP Queue 3.)"""

    def __init__(self, source):
        self.source, self.sent, self.t0 = source, 0, None

    def __call__(self, freq_hz, n):
        now = time.perf_counter()
        self.t0 = now if self.t0 is None else self.t0
        wait = self.t0 + self.sent / (SAMPLING_RATE * TCP_PACE) - now
        if wait > 0:
            time.sleep(wait)
        self.sent += n
        return self.source(freq_hz, n)


def tcp_stream_run(caps: dict, flags):
    """Phase 12, one `python -m tpudab_torch.host.cli stream --tcp HOST:PORT
    --channel 12C --no-dashboard` (cli_run: in this process, the launch
    counts set to 0 before and read after) against a fresh RtlTcpServer of
    the port serving caps {channel: IQ} in real time (RealTime; 12C also on
    the server's power-on frequency, so the stream a client reads does not
    depend on when its SET_FREQ lands). Its key controller is scripted: after
    TCP_RETUNE_FRAMES frames of 12C it presses '>' (StreamingRadio.retune to
    12D, the key's own call), and it quits after TCP_D_BATCHES batches with
    the second ensemble in the database. Returns (per-poll records, {channel:
    {subch id: (frames, AUs)}}, {channel: (FIBs, CRC errors, frames,
    reacquisitions)} at the last poll on it, wall s, launches, the printed
    lines)."""
    from tpudab_torch.host import controls, streaming
    from tpudab_torch.host.rtl_tcp import LoopingCaptureSource, RtlTcpServer

    f12c = channel_freq_hz("12C")
    src = LoopingCaptureSource({channel_freq_hz(ch): iq for ch, iq in caps.items()})
    server = RtlTcpServer(RealTime(lambda f, n: src(f12c if f == 0.0 else f, n))).start()
    polls, decoded, stats = [], {}, {}
    t_start = time.perf_counter()

    class Scripted(controls.KeyController):
        def __init__(self, *a, **kw):
            kw["read_key"] = lambda: None
            super().__init__(*a, **kw)

        def poll(self):
            radio, rx = self.radio, self.receiver
            polls.append((time.perf_counter() - t_start, radio.channel,
                          rx.db.ensemble.ensemble_id, rx.stats["fibs"],
                          rx.stats["fib_crc_errors"], radio.stats.total_frames,
                          radio.tuner.ring.fill / 8 / SAMPLING_RATE))
            stats[radio.channel] = (rx.stats["fibs"], rx.stats["fib_crc_errors"],
                                    radio.stats.total_frames, radio.stats.reacquisitions)
            if radio.channel == "12C" and radio.stats.total_frames >= TCP_RETUNE_FRAMES:
                self.handle(">")
            on_d = sum(p[1] == "12D" and p[2] == TCP_EID_D for p in polls)
            return on_d < TCP_D_BATCHES and len(polls) < TCP_MAX_POLLS

    class Recorded(streaming.StreamingRadio):
        def run(self, max_batches=None, on_outputs=None):
            def both(outputs):
                got = decoded.setdefault(self.channel, collections.defaultdict(lambda: ([], [])))
                for sid, o in outputs.items():
                    if o.raw_frames is not None and len(o.raw_frames):
                        got[sid][0].append(np.asarray(o.raw_frames))
                    got[sid][1].extend(bytes(au) for sf in o.superframes
                                       for au in sf.access_units)
                on_outputs(outputs)
            return super().run(max_batches, both)

    orig = (controls.KeyController, streaming.StreamingRadio)
    controls.KeyController, streaming.StreamingRadio = Scripted, Recorded
    try:
        lines, wall, launches, _ = cli_run(["stream", "--tcp", f"{server.host}:{server.port}",
                                            "--channel", "12C", "--no-dashboard", *flags])
    finally:
        controls.KeyController, streaming.StreamingRadio = orig
        server.stop()
    decoded = {ch: {sid: (np.concatenate(f) if f else np.zeros((0, 0), np.uint8), a)
                    for sid, (f, a) in got.items()} for ch, got in decoded.items()}
    return polls, decoded, stats, wall, launches, lines


def in_order(got: list, want: list) -> int:
    """How many AUs of got run in order through want from where got's first
    one is; -1 if its first is not there."""
    if not got or got[0] not in want:
        return -1
    k0 = want.index(got[0])
    return len(got) if got == want[k0: k0 + len(got)] else -1


def run_tcp_path(dev, card, iq, aus):
    """Phase 12: `stream --tcp` on the card (tcp_stream_run) on each path,
    step (the default) and host (--no-device-step): phase 9's full-width
    capture served on 12C, second_ensemble on 12D, the retune by the
    dashboard's '>' call. Gates, on each path: FIB CRC 1.0 on each channel
    and no reacquisition on 12C; every subchannel's AUs the payload's, in
    order, on each channel; the database on the second ensemble after the
    retune, 12C's before; the path's kernels launched; 12C's frames and AUs
    byte-equal between the paths (the same stream, the same batches), and
    12D's AUs each path's run of the same payload. Then `synth` where the
    codec probe finds FFmpeg."""
    from tpudab_torch.host.native_lib import ffmpeg_probe

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    iq_d, aus_d = second_ensemble(TCP_FRAMES_D)
    print(f"tcp path synth: {TCP_FRAMES_D} frames of the second ensemble in "
          f"{time.perf_counter() - t0:.1f} s")
    caps = {"12C": iq.astype(np.complex64), "12D": iq_d}
    runs = {}
    for label, (_, flags) in STREAM_PATHS.items():
        polls, decoded, stats, wall, launches, lines = tcp_stream_run(caps, flags)
        require(set(decoded) == {"12C", "12D"}, f"tcp {label}: decoded on {sorted(decoded)}")
        c_fibs, c_err, c_frames, c_reacq = stats["12C"]
        d_fibs, d_err, d_frames, _ = stats["12D"]
        require(c_err == 0 and d_err == 0 and c_fibs == 12 * c_frames and d_fibs > 0
                and c_reacq == 0 and c_frames >= TCP_RETUNE_FRAMES,
                f"tcp {label}: FIB CRC not 1.0 or a lost lock: 12C {stats['12C']}, "
                f"12D {stats['12D']}")
        eids = [(p[1], p[2]) for p in polls if p[2]]
        require(all(e == (0xBE9C if ch == "12C" else TCP_EID_D) for ch, e in eids)
                and eids[-1] == ("12D", TCP_EID_D),
                f"tcp {label}: the database did not switch ensembles with the retune: {eids}")
        for ch, want_aus in (("12C", aus), ("12D", {1: aus_d})):
            for sid, want in want_aus.items():
                n = in_order(decoded[ch].get(sid, ([], []))[1], want)
                require(n > 0, f"tcp {label}: {ch} subchannel {sid}: AUs not the payload's "
                        f"in order")
        require(all(launches[k] for k in STREAM_KERNELS[label]),
                f"tcp {label}: launches {launches}")
        t_retune = next(p[0] for p in polls if p[1] == "12D")
        t_prev = max(p[0] for p in polls if p[1] == "12C")
        t_locked = next(p[0] for p in polls if p[1] == "12D" and p[2] == TCP_EID_D)
        signal_c = c_frames * get_ofdm_params(1).nb_frame_length / SAMPLING_RATE
        lag = max(p[6] for p in polls if p[1] == "12C")
        runs[label] = {"decoded": decoded, "wall": wall, "launches": launches,
                       "rtf_12c": signal_c / t_prev, "max_lag_s_12c": lag,
                       "retune_s": t_locked - t_prev, "first_batch_after_s": t_retune - t_prev,
                       "stats": stats}
        print(f"stream --tcp {label} path [{card}]: 12C {c_frames} frames, FIB CRC 1.0 over "
              f"{c_fibs} FIBs, real-time factor {signal_c / t_prev:.2f} ({signal_c:.3f} s of "
              f"signal in {t_prev:.3f} s from the command's start, the connection and "
              f"acquisition included; served at {TCP_PACE} x real time, so at most that), "
              f"the client's ring at most {lag:.3f} s behind at a poll; '>' to 12D: first "
              f"batch after {t_retune - t_prev:.3f} s, "
              f"the second ensemble in the database after {t_locked - t_prev:.3f} s (the drain, "
              f"reacquisition and FIC); 12D {d_frames} frames, FIB CRC 1.0 over {d_fibs} FIBs; "
              f"AUs in order on every subchannel of both; launches {launches}; command "
              f"{wall:.3f} s; {lines[-1]}")
    step_c, host_c = runs["step"]["decoded"]["12C"], runs["host"]["decoded"]["12C"]
    require(step_c.keys() == host_c.keys() and all(
        np.array_equal(step_c[k][0], host_c[k][0]) and step_c[k][1] == host_c[k][1]
        for k in step_c), "tcp: the step and host paths decoded other bytes on 12C")
    print(f"stream --tcp: 12C's frames and AUs byte-equal on both paths "
          f"({sum(len(g[0]) for g in step_c.values())} frames, "
          f"{sum(len(g[1]) for g in step_c.values())} AUs over {len(step_c)} subchannels); "
          f"12D's AUs on each path a run of the second ensemble's payload, in order")

    found, what = ffmpeg_probe()
    if found:
        with tempfile.TemporaryDirectory() as tmp:
            cap = os.path.join(tmp, "synth.f32")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "tpudab_torch.host.cli", "synth", cap,
                                   "--seconds", "0.5"], capture_output=True, text=True,
                                  timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
            require(proc.returncode == 0 and os.path.getsize(cap) == 5 * 196608 * 8,
                    f"synth: exit {proc.returncode}\n{proc.stderr[-2000:]}")
            print(f"synth: FFmpeg found ({what}); `python -m tpudab_torch.host.cli synth CAP "
                  f"--seconds 0.5` exit 0 in {time.perf_counter() - t0:.1f} s, "
                  f"{os.path.getsize(cap)} bytes")
    else:
        print(f"synth: not run; the codec probe found no FFmpeg ({what}), and synth needs "
              f"its encoders")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s in all")
    return {"tcp_launches": {k: v["launches"] for k, v in runs.items()},
            "tcp": {k: {kk: vv for kk, vv in v.items() if kk != "decoded"}
                    for k, v in runs.items()}}


def packet_mux_spec() -> EnsembleSpec:
    """Phase 13's multiplex: the bench layout (bench_subchannels: six
    108-CU EEP 3-A subchannels, 648 CU), DAB+ services on subchannels 1-5,
    a packet-mode data service (TMId 3, DSCTy PACKET_DSCTY; SCId 6) on
    subchannel 6, FM_LINK and DRM_LINK (FIG 0/6 + FIG 0/21)."""
    subchannels = bench_subchannels()
    services = [ServiceSpec(0xC200 + c.subch_id, f"Bench {c.subch_id}",
                            [(0, ASCTY_DAB_PLUS, c.subch_id)]) for c in subchannels[:-1]]
    services.append(ServiceSpec(0xC200 + PACKET_SUBCH, "Bench Slides",
                                [(TMID_PACKET_DATA, PACKET_DSCTY, PACKET_SUBCH)]))
    return EnsembleSpec(
        ensemble_id=0xBE9D, label="Packet Ensemble", services=services,
        subchannels=[SubchannelSpec(c.subch_id, start_cu=c.start_cu, size_cu=c.size_cu,
                                    protection=("eep", 3, 0)) for c in subchannels],
        fm_links=[FMLinkSpec(*FM_LINK)], drm_links=[DRMLinkSpec(*DRM_LINK)])


def slide_carousel(n_logical: int):
    """Phase 13's packet stream: one MOT slideshow object (SLIDE_BYTES: a
    PNG head, TINY_PNG, then seeded random bytes) as MOT data groups of
    SLIDE_SEGMENT-byte segments in PACKET_LEN-byte packets at PACKET_ADDR,
    sent round and round, PACKETS_PER_FRAME packets a logical frame and
    24-byte padding packets (address 0) after them. Returns (the body,
    (n_logical, frame bytes) uint8, data groups a turn)."""
    from tpudab_torch.data.packet import build_packets
    from tpudab_torch.mot.imagemeta import TINY_PNG
    from tpudab_torch.mot.mot import ContentType, MOTObject, build_mot_object_groups

    rng = np.random.default_rng(13)
    body = TINY_PNG + rng.integers(0, 256, SLIDE_BYTES - len(TINY_PNG)).astype(np.uint8).tobytes()
    obj = MOTObject(transport_id=613, content_type=ContentType.IMAGE, content_subtype=3,
                    body=body, content_name=SLIDE_NAME)
    groups = build_mot_object_groups(obj, segment_size=SLIDE_SEGMENT)
    packets = [pk for g in groups for pk in build_packets(PACKET_ADDR, g, PACKET_LEN)]
    frame_bytes = bench_subchannels()[PACKET_SUBCH - 1].data_bits // 8
    pad = build_packets(0, b"", 24)[0] * ((frame_bytes - PACKETS_PER_FRAME * PACKET_LEN) // 24)
    frames = b"".join(b"".join(packets[(m * PACKETS_PER_FRAME + k) % len(packets)]
                               for k in range(PACKETS_PER_FRAME)) + pad
                      for m in range(n_logical))
    return body, np.frombuffer(frames, np.uint8).reshape(n_logical, frame_bytes), len(groups)


def packet_capture(n_frames: int):
    """Phase 13's input, synthesised by the port alone: packet_mux_spec()
    with phase 9's DAB+ streams on subchannels 1-5 (decode_capture's seeds)
    and slide_carousel on subchannel 6, through DECODE_IMP. Returns
    (complex64 IQ, {subch id: the AUs in order}, slide body, data groups a
    turn)."""
    synth = EnsembleSynthesizer(packet_mux_spec(), seed=1)
    aus = {}
    for c in bench_subchannels()[:-1]:
        stream, aus[c.subch_id] = dabplus_stream(
            c.data_bits // 24, 4 * n_frames, seed=20 + c.subch_id, with_pad=c.subch_id == 1)
        synth.payload_fn[c.subch_id] = lambda m, st=stream: st[m].tobytes()
    body, carousel, groups = slide_carousel(4 * n_frames)
    synth.payload_fn[PACKET_SUBCH] = lambda m: carousel[m].tobytes()
    frames = np.stack([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)])
    return apply_impairments(frames.reshape(-1), Impairments(**DECODE_IMP)), aus, body, groups


def check_packet_database(dev, iq, groups: int, card: str) -> dict:
    """Phase 13, database and dashboard: an in-process OfflinePipeline
    (the --device-step leg) on the capture. The packet component's SCId
    on subchannel 6 with its DSCTy and packet address, the FM and DRM
    links with their frequencies, the dashboard's link lines, and the
    carousel's data groups (the turns that came through)."""
    from tpudab_torch.host.dashboard import render_text
    from tpudab_torch.models.pipeline import OfflinePipeline

    pipe = OfflinePipeline(batch_frames=DECODE_BATCH, use_device_step=True, device=dev)
    t0 = time.perf_counter()
    pipe.run(iq)
    wall = time.perf_counter() - t0
    rx = pipe.receiver
    db = rx.db
    sid = 0xC200 + PACKET_SUBCH
    comps = [(c.scid, c.subch_id, c.data_type, c.packet_address)
             for c in db.service_components.values() if c.service_id == sid]
    require(comps == [(PACKET_SUBCH, PACKET_SUBCH, PACKET_DSCTY, PACKET_ADDR)],
            f"packet path: service 0x{sid:04X}'s components (SCId, subchannel, DSCTy, "
            f"packet address) are {comps}")
    fm, drm = db.fm_services.get(FM_LINK[1]), db.drm_services.get(DRM_LINK[1])
    require(fm is not None and fm.frequencies == FM_LINK[2],
            f"packet path: FM service {FM_LINK[1]:#06x}: {fm}")
    require(drm is not None and drm.frequencies == DRM_LINK[2],
            f"packet path: DRM service {DRM_LINK[1]:#06x}: {drm}")
    text = render_text(rx)
    lines = [ln.strip() for ln in text.splitlines()
             if ln.strip().startswith(("FM  RDS PI", "DRM id"))]
    require(len(lines) == 2 and lines[0].startswith(f"FM  RDS PI 0x{FM_LINK[1]:04X}")
            and lines[1].startswith(f"DRM id 0x{DRM_LINK[1]:04X}"),
            f"packet path: the dashboard's link lines: {lines}")
    data_groups = rx.channels[PACKET_SUBCH].stats["data_groups"]
    require(data_groups >= 2 * groups and rx.stats["fib_crc_errors"] == 0,
            f"packet path: {data_groups} data groups ({groups} a turn), "
            f"{rx.stats['fib_crc_errors']} FIB CRC errors")
    print(f"packet path database [{card}]: OfflinePipeline --device-step leg in {wall:.3f} s; "
          f"SCId {PACKET_SUBCH} -> subchannel {PACKET_SUBCH}, DSCTy {PACKET_DSCTY}, packet "
          f"address {PACKET_ADDR}; FM {fm.rds_pi:#06x} {fm.frequencies}, DRM "
          f"{drm.drm_id:#06x} {drm.frequencies}; dashboard: {lines}; {data_groups} MOT data "
          f"groups ({data_groups / groups:.1f} turns of {groups})")
    return {"pipeline_wall_s": wall, "data_groups": data_groups}


def run_packet_path(dev, card, n_frames: int = DECODE_FRAMES):
    """Phase 13: `python -m tpudab_torch.host.cli decode` on packet_capture
    (a packet-mode slideshow and FM/DRM links, synthesised by the port),
    with and without --device-step, one untraced run each. Gate, on each
    leg: the acquisition held to acquire_np and to the capture as made,
    FIB CRC 1.0, the slide file byte-equal to the MOT body, subchannel 1's
    AUs the payload's, the legs' payload files identical, the legs'
    launches as in phase 9; then check_packet_database."""
    t_phase = time.perf_counter()
    signal_s = n_frames * get_ofdm_params(1).nb_frame_length / SAMPLING_RATE
    t0 = time.perf_counter()
    iq, aus, body, groups = packet_capture(n_frames)
    print(f"packet path synth: {n_frames} frames, impaired, in {time.perf_counter() - t0:.1f} s")
    res, host_ms, ref, np_ms = card_acquisition(dev, iq, "packet path")
    print(f"packet path acquisition [{card}]: frame_start {res['frame_start']}, coarse_bins "
          f"{res['coarse_bins']}, net {res['net_freq_hz']:.3f} Hz, acquire_host "
          f"{host_ms:.2f} ms host wall; acquire_np net {ref['net_freq_hz']:.3f} Hz "
          f"({res['net_freq_hz'] - ref['net_freq_hz']:+.4f} Hz, bound {ORACLE_HZ} Hz), same "
          f"frame start and coarse bins, {np_ms:.1f} ms host")
    n_aus = 6 * ((4 * n_frames - 15) // 5)
    slide = f"subch{PACKET_SUBCH}_{SLIDE_NAME}"
    legs = {"step": ["--device-step"], "host": []}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "packet.f32")
        write_iq(iq, cap)
        for label, flags in legs.items():
            out = os.path.join(tmp, label)
            lines, wall, launches, _ = cli_run(["decode", cap, *flags, "--batch-frames",
                                                str(DECODE_BATCH), "--out-dir", out])
            files = decode_files(lines, out, n_frames, f"packet {label} leg")
            require(files.get(slide) == body,
                    f"packet {label} leg: {slide} is not the MOT body ({sorted(files)})")
            got = read_aus(files["subch1.aac.raw"])
            require(got == aus[1][:n_aus], f"packet {label} leg: {len(got)} AUs of subchannel "
                    f"1, want the first {n_aus} of the payload")
            runs[label] = {"files": files, "wall": wall, "launches": launches}
            print(f"packet decode {' '.join(flags) or '(host leg only)'} [{card}]: wall "
                  f"{wall:.3f} s for {signal_s:.3f} s of signal, real-time factor "
                  f"{signal_s / wall:.2f}; launches {launches}; FIB CRC 1.0; {slide} byte-equal "
                  f"to the {len(body)}-byte MOT body; subchannel 1's {n_aus} AUs byte-equal")
    require(runs["step"]["files"] == runs["host"]["files"],
            "packet decode: the legs with and without --device-step wrote different files")
    step_l, host_l = runs["step"]["launches"], runs["host"]["launches"]
    require(all(step_l.values()), f"packet decode --device-step left a kernel unlaunched: {step_l}")
    require(host_l["deinterleave_depuncture_t"] == host_l["viterbi_fwd_traceback"] == 0
            and host_l["viterbi_bits"] and host_l["deinterleave"] and host_l["carve_rotate"],
            f"packet decode: the host leg's launches: {host_l}")
    print(f"packet decode: {len(runs['step']['files'])} payload files identical on both legs: "
          f"{sorted(runs['step']['files'])}")
    numbers = check_packet_database(dev, iq, groups, card)
    numbers.update({"packet_launches": {"step": step_l, "host": host_l},
                    "decode_wall_s": {k: r["wall"] for k, r in runs.items()},
                    "acquire_np_net_freq_hz": ref["net_freq_hz"], "acquire_np_ms": np_ms})
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all [{card}]")
    return numbers


def main() -> None:
    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(phases: str) -> None:
        marks.append((phases, time.perf_counter()))
    card = identify()
    dev = torch.device("cuda", 0)
    resources, sass = build()
    mark("1-2")
    rng = np.random.default_rng(SEED)
    res = check_kernels(dev, rng, card)
    res.update(check_demod_tail(dev, card))
    res.update(check_u8(dev, card))
    ddc = check_channelise(dev, card)
    chain = check_chain(dev, card)
    mark("3")
    launches, step_ms, bench_frames, bench_payload, k12_layouts = run_main_path(dev, card)
    mark("4-6")
    host_launches, _ = run_host_path(dev, card)
    mark("7")
    launches["viterbi_bits"] = host_launches["viterbi_bits"]   # K3 runs on the host path only
    launches["deinterleave"] = host_launches["deinterleave"]   # mode (a): the host path only
    host_k4 = [(cu, *res[f"deinterleave_host_{cu}cu"][1:]) for cu in (108, 96)]
    print(f"K4 deinterleave on the host path: {host_launches['deinterleave']} launches; "
          + ", ".join(f"f32 ({4 * HOST_BATCH + 15}, {cu * 64}) kernel {ms:.3f} ms, "
                      f"plain {plain:.3f} ms" for cu, ms, plain in host_k4) + f"  [{card}]")
    msc, fic = res["viterbi_msc"], res["viterbi_fic"]
    shares = {
        "viterbi_fwd_traceback": msc[1] + fic[1],
        "deinterleave_depuncture_t": chain["group_ms"] + chain["fic_ms"],
        "carve_rotate": res["carve_rotate"][1],
    }
    print(f"kernel shares of the step [{card}]: " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / step_ms:.1f}%)" for k, v in shares.items()))

    # phase 8: the kernel-experiment tools
    rng8 = np.random.default_rng(SEED + 8)
    fwd, tb = check_tool_forward(dev, rng8, card)
    probe, carve, probe_launch = check_tool_probe_carve(dev, rng8, card)
    tool_launches, _ = run_tools(card)
    launches.update(tool_launches)
    mark("8")

    # phase 9: the decode path, through the command line
    decode, iq, aus, acq = run_decode_path(dev, card)
    mark("9")

    # phase 10: the live loop, in process and through the command line
    stream = run_stream_path(dev, card, iq, aus, acq)
    mark("10")

    # phase 11: the sharded step, a world of one on NCCL and two processes on gloo
    sharded = run_sharded_path(dev, card, bench_frames, bench_payload)
    mark("11")

    # phase 12: `stream --tcp` with a live retune, and `synth`
    tcp = run_tcp_path(dev, card, iq, aus)
    mark("12")

    # phase 13: a packet-mode slideshow multiplex with FM/DRM links, through `decode`
    packet = run_packet_path(dev, card)
    mark("13")

    # phase 14: the step's measurement tools
    step_tool_launches, _ = run_step_tools(card)
    mark("14")

    # phase 15: the port's bench.py and bench_scaling.py
    bench = run_bench_tools(dev, card, step_ms)
    mark("15")
    print("phase seconds: " + ", ".join(f"{name} {t - t0:.1f}" for (_, t0), (name, t)
                                         in zip(marks, marks[1:])))

    def old(key, bound_key, library=None):
        err, ms, plain = res[key]
        bnd = res[bound_key]
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library}

    def new(row, err=0.0):
        return {"max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    measured = {
        "viterbi_fwd_traceback": old("viterbi_msc", "bound_viterbi_msc"),
        "viterbi_bits": old("viterbi_bits_msc", "bound_viterbi_bits_msc"),
        "deinterleave": old("deinterleave", "bound_deinterleave", res["library_deinterleave"]),
        "deinterleave_depuncture_t": chain,
        "carve_rotate": {**old("carve_rotate", "bound_carve_rotate"),
                         **res["carve_rotate_extra"], "u8": res["carve_rotate_u8"]},
        "viterbi_fwd_variant": new(fwd["full"]),
        "viterbi_traceback": new(tb["shuffle"]),
        "i16_probe": new(probe["add"]),
        "carve_variant": {**new(carve["fb8"]), "kernel_ms": carve["fb8"]["kernel_ms"],
                          "library_ms": carve["norotate"]["library_ms"]},
    }
    kernels = []
    for name, (src, replaces, _) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches[name], **measured[name]}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name in FUSES:
            entry["also_fuses"] = FUSES[name]
        if name == "viterbi_fwd_traceback":
            entry["kernel_ms_host_us"] = {k: res[f"viterbi_{k}_device"] for k in ("msc", "fic")}
            entry["fic_ms"] = res["viterbi_fic"][1]
            entry["layout"] = {k: res[f"viterbi_{k}_layout"] for k in ("msc", "fic")}
            entry["by_layout_ms"] = {k: res[f"viterbi_{k}_by_layout"] for k in ("msc", "fic")}
            entry["layout_launches"] = k12_layouts
            entry["sass_per_superstep"] = sass
        if name == "viterbi_bits":
            entry["ms_by_shape"] = {k: res[f"viterbi_bits_{k}"][1:]
                                    for k in ("fic", "msc", "calibration")}
            entry["kernel_ms_host_us_by_shape"] = {k: res[f"viterbi_bits_{k}_device"]
                                                   for k in ("fic", "msc", "calibration")}
            entry["serial_bound_ms"] = res["bound_viterbi_bits_msc"][2]
        if name == "deinterleave":
            entry["call_ms"] = res["deinterleave_call_ms"]
            entry["host_path_ms_by_shape"] = {k: res[f"deinterleave_host_{k}"][1:]
                                              for k in ("108cu", "96cu")}
        if name == "viterbi_fwd_variant":
            entry["shape"] = fwd["full"]["shape"]
            entry["dtype"] = fwd["full"]["dtype"]
            entry["plain_codewords"] = TWIN_B
            entry["by_variant"] = fwd
        if name == "viterbi_traceback":
            entry["old_chain_ms"] = tb["shuffle"]["old_chain_ms"]
            entry["plain_codewords"] = TWIN_B
            entry["by_mode"] = tb
        if name == "i16_probe":
            entry["library_call"] = "torch.add"
            entry["by_op"] = probe
            entry["launch_host_us"] = probe_launch
        if name == "carve_variant":
            entry["library_call"] = ("torch .to(bfloat16) of ops/carve.py::_windows' view of re "
                                     "and of im: the norotate variant's function")
            entry["by_variant"] = carve
        if name in PTXAS_OF:
            entry["ptxas"] = {k: dict(zip(("registers", "spill_stores", "smem"), v))
                              for k, v in resources.items() if k.startswith(PTXAS_OF[name])}
        if name in DECODE_KERNELS:
            entry["decode_launches"] = {k: v[name] for k, v in decode["decode_launches"].items()}
            entry["stream_launches"] = {k: v[name] for k, v in stream["stream_launches"].items()}
            entry["tcp_stream_launches"] = {k: v[name] for k, v in tcp["tcp_launches"].items()}
            entry["packet_decode_launches"] = {k: v[name]
                                               for k, v in packet["packet_launches"].items()}
        if name in STEP_KERNELS:
            entry["sharded_launches"] = {k: v[name]
                                         for k, v in sharded["sharded_launches"].items()}
            entry["step_tools_launches"] = step_tool_launches[name]
            entry["bench_launches"] = bench["bench_launches"][name]
        kernels.append(entry)
    kernels.append(ddc)          # port only: no TPU kernel does this work
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included")
    tail = {name: dict(zip(("ms", "bound_ms", "bound_by"), v))
            for name, v in res["demod_tail"].items()}
    tail["stats_kernel_u8"] = res["stats_kernel_u8"]
    print(json.dumps({"kernels": kernels, "demod_tail": tail}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

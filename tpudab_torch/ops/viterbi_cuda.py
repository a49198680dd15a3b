"""Viterbi decode entries, kernels K1 + K2 and K1 + K3.

Counterparts of tpudab.ops.viterbi_pallas:
- viterbi_decode_bytes_t: transposed soft bits (T2p, 8, B) -> packed bytes
  (viterbi_decode_bytes_best_t / viterbi_decode_pallas_bytes_t), the
  receive step's entry;
- viterbi_decode_best: mother soft bits (B, T, 4) -> bits (B, n)
  (viterbi_decode_best / viterbi_decode_pallas), the host per-stage path's
  entry;
- viterbi_decode_bytes_best: mother soft bits (B, T, 4) -> packed bytes
  (viterbi_decode_bytes_best / viterbi_decode_pallas_bytes).

Each dispatches on the soft bits' device: a CPU tensor takes the plain
torch decoder (tpudab_torch/ops/viterbi.py), a CUDA tensor the fused
forward + traceback kernels in csrc/viterbi.cu, which match the plain
decoder bit for bit. There is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import functools

import torch

from tpudab_torch.ops import _build
from tpudab_torch.ops.viterbi import (N_STATES, RADIX, REBASE_STEPS, branch_metric_table,
                                      mother_to_t, radix_tables,
                                      viterbi_decode_bytes_t_ref, viterbi_decode_ref)

__all__ = ["viterbi_decode_bytes_t", "viterbi_decode_bytes_t_cuda", "k12_layout", "K12_LAYOUTS",
           "k12_resident_blocks",
           "viterbi_decode_bytes_t_ref", "viterbi_decode_best",
           "viterbi_decode_bytes_best", "viterbi_decode_bits_cuda",
           "viterbi_decode_ref", "signs_on", "kernel_table", "kernel_table_on"]


@functools.lru_cache(maxsize=None)
def signs_on(device: torch.device) -> torch.Tensor:
    """The radix-2 sign table (8, 256) f32 on device, made once per device."""
    return torch.tensor(radix_tables()[0], device=device)


def kernel_table(signs: torch.Tensor) -> torch.Tensor:
    """branch_metric_table(signs) packed for csrc/viterbi.cu (LaneTable):
    (2, 32) int32. Row 0, lane l: bit i set where sign i of magnitude l is
    -1. Row 1, lane l: bits [5j, 5j+5) the magnitude of super-transition
    (j << 6) | 2l, bit 20 + j its negation, bit 24 + j the negation of
    (j << 6) | (2l + 1). Raises unless state 2l + 1 takes the magnitudes
    of state 2l with j ^ 2 (true of DAB's mother code): the kernel
    shuffles 4 magnitudes per lane, not 8."""
    msigns, index, negate = branch_metric_table(signs)
    lo, hi = index[:, 0::2], index[:, 1::2]
    if not torch.equal(hi, lo[[2, 3, 0, 1]]):
        raise ValueError("the sign table does not pair states 2l and 2l + 1 by j ^ 2")
    table = torch.zeros((2, 32), dtype=torch.int64)
    table[0, : msigns.shape[0]] = ((msigns < 0).to(torch.int64) << torch.arange(8)).sum(1)
    j = torch.arange(4)[:, None]
    table[1] = ((lo << (5 * j)) | (negate[:, 0::2].to(torch.int64) << (20 + j))
                | (negate[:, 1::2].to(torch.int64) << (24 + j))).sum(0)
    return table.to(torch.int32)


@functools.lru_cache(maxsize=None)
def kernel_table_on(device: torch.device) -> torch.Tensor:
    """kernel_table of the radix-2 sign table on device, made once per device."""
    return kernel_table(torch.from_numpy(radix_tables()[0])).to(device)


def _kernel_table_for(signs: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The kernels' branch-metric table for signs, after checking them:
    the table is made once per device from DAB's sign table, so signs
    other than signs_on(device) are compared with it on the device (a
    sync) and raise if they differ."""
    if signs.device != device or signs.dtype != torch.float32 \
            or signs.shape != (4 * RADIX, N_STATES << RADIX) \
            or not signs.is_contiguous():
        raise ValueError("signs must be the contiguous (8, 256) f32 radix-2 "
                         "sign table on the soft bits' device")
    if signs is not signs_on(device) and not torch.equal(signs, signs_on(device)):
        raise ValueError("the CUDA Viterbi kernels decode DAB's mother code only: "
                         "signs must equal radix_tables()[0]")
    return kernel_table_on(device)


# viterbi_kernel's thread layouts, id (csrc/viterbi.cu::kWarpLayout,
# kBflyLayout, kBfly4Layout: a butterfly layout's id is its butterflies a
# thread) -> name
WARP_LAYOUT, BFLY_LAYOUT, BFLY4_LAYOUT = 0, 2, 4
K12_LAYOUTS = {WARP_LAYOUT: "warp", BFLY_LAYOUT: "bfly", BFLY4_LAYOUT: "bfly4"}
# codewords an SM up to which k12_layout keeps WARP_LAYOUT, then BFLY_LAYOUT
WARP_LAYOUT_CODEWORDS_PER_SM = 32
BFLY_LAYOUT_CODEWORDS_PER_SM = 48


def k12_layout(b: int, sm_count: int) -> int:
    """The thread layout of K1+K2 (csrc/viterbi.cu::viterbi_kernel) for b
    codewords on a card of sm_count SMs: one warp a codeword up to
    WARP_LAYOUT_CODEWORDS_PER_SM codewords an SM, two butterflies a thread
    up to BFLY_LAYOUT_CODEWORDS_PER_SM, four past them. Each edge is a
    crossover measured on an H100 of 132 SMs (PERF.md section 6).
    - warp / bfly at T2p 1744, the MSC's length (device ms): 2048
      codewords 0.440 / 0.695, 4224 0.763 / 0.793, 5120 1.138 / 0.913; at
      T2p 400 within 7% of each other from 3072 to 4224. Measured before
      the butterflies staged their soft values by raw loads; since then
      bfly reads 0.311 / 0.074 ms at 2048 codewords and T2p 1744 / 400,
      against warp's 0.443 / 0.098, so this edge waits on a measurement
      of the FIC's launch in the step.
    - bfly / bfly4 (both 16 codewords a block, so k blocks an SM; device
      ms at T2p 1744 and 400): 4608 codewords (k 3) 0.678 / 0.751 and
      0.160 / 0.177; 6656 (k 4) 0.880 / 0.780 and 0.207 / 0.185; 12288
      (k 6) 1.274 / 1.124 and 0.296 / 0.265. A bfly4 block is 2 warps, so
      an odd k leaves half the schedulers a warp short: at k 5 (8449 to
      10560 codewords) bfly is 0.7-2% faster, which this rule gives up."""
    if b <= WARP_LAYOUT_CODEWORDS_PER_SM * sm_count:
        return WARP_LAYOUT
    return BFLY_LAYOUT if b <= BFLY_LAYOUT_CODEWORDS_PER_SM * sm_count else BFLY4_LAYOUT


@functools.lru_cache(maxsize=None)
def sm_count_of(index: int) -> int:
    """The SMs of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def k12_resident_blocks(layout: int, bf16: bool) -> int:
    """Blocks of viterbi_kernel in `layout` (bf16 or f32 soft) resident an
    SM of the current CUDA device, by the occupancy calculator; each block
    holds csrc/viterbi.cu::k12_codewords codewords."""
    return _build.load_library().tpudab_viterbi_resident_blocks(layout, int(bf16))


def viterbi_decode_bytes_t_cuda(soft_t: torch.Tensor, signs: torch.Tensor,
                                n_data_bits: int) -> torch.Tensor:
    """Kernels K1 + K2 on a CUDA tensor: soft_t (T2p, 8, B) bf16 or f32,
    contiguous, T2p % 16 == 0; signs (8, 256) f32 -> (B, n_data_bits // 8)
    uint8. The thread layout is k12_layout(B, the card's SMs); .launches
    counts the launches and .layout_launches[layout] those of each layout."""
    t2p, eight, b = soft_t.shape
    if not soft_t.is_cuda or soft_t.dtype not in (torch.bfloat16, torch.float32) \
            or not soft_t.is_contiguous() or eight != 4 * RADIX \
            or t2p % REBASE_STEPS or n_data_bits % 8 \
            or n_data_bits > RADIX * t2p:
        raise ValueError(f"viterbi_decode_bytes_t_cuda takes contiguous CUDA "
                         f"bf16/f32 (T2p % {REBASE_STEPS} == 0, 8, B), got "
                         f"{soft_t.device} {soft_t.dtype} "
                         f"{tuple(soft_t.shape)}, n_data_bits={n_data_bits}")
    table = _kernel_table_for(signs, soft_t.device)
    layout = k12_layout(b, sm_count_of(soft_t.get_device()))
    dec = torch.empty((b, t2p // 4, N_STATES), dtype=torch.uint8,
                      device=soft_t.device)
    out = torch.empty((b, n_data_bits // 8), dtype=torch.uint8,
                      device=soft_t.device)
    _build.launch(_build.load_library().tpudab_viterbi_decode_bytes_t, soft_t.get_device(),
                  "viterbi", soft_t.data_ptr(), int(soft_t.dtype == torch.bfloat16),
                  table.data_ptr(), dec.data_ptr(), out.data_ptr(), t2p, b, n_data_bits // 8,
                  layout)
    viterbi_decode_bytes_t_cuda.launches += 1
    viterbi_decode_bytes_t_cuda.layout_launches[layout] += 1
    return out


viterbi_decode_bytes_t_cuda.launches = 0
viterbi_decode_bytes_t_cuda.layout_launches = collections.Counter()


def viterbi_decode_bytes_t(soft_t: torch.Tensor, signs: torch.Tensor,
                           n_data_bits: int) -> torch.Tensor:
    """(T2p, 8, B) soft -> (B, n_data_bits // 8) packed bytes; dispatches on
    the soft bits' device."""
    if soft_t.device.type == "cpu":
        return viterbi_decode_bytes_t_ref(soft_t, signs, n_data_bits)
    return viterbi_decode_bytes_t_cuda(soft_t, signs, n_data_bits)


def viterbi_decode_bits_cuda(mother_soft: torch.Tensor, signs: torch.Tensor,
                             n_data_bits: int) -> torch.Tensor:
    """Kernels K1 + K3 on a CUDA tensor: mother soft bits (B, T, 4) bf16 or
    f32, contiguous; signs (8, 256) f32 -> bits (B, n_data_bits) uint8.
    The kernel reads +1.0 (the flush) past T up to T2p = 16 * ceil(T / 32)
    super-steps, so nothing is padded or transposed here."""
    if not mother_soft.is_cuda or mother_soft.dtype not in (torch.bfloat16, torch.float32) \
            or not mother_soft.is_contiguous() or mother_soft.dim() != 3 \
            or mother_soft.shape[-1] != 4 or n_data_bits > mother_soft.shape[1]:
        raise ValueError(f"viterbi_decode_bits_cuda takes contiguous CUDA bf16/f32 "
                         f"(B, T >= n_data_bits, 4), got {mother_soft.device} "
                         f"{mother_soft.dtype} {tuple(mother_soft.shape)}, "
                         f"n_data_bits={n_data_bits}")
    table = _kernel_table_for(signs, mother_soft.device)
    b, t, _ = mother_soft.shape
    t2p = -(-t // (RADIX * REBASE_STEPS)) * REBASE_STEPS
    out = torch.empty((b, n_data_bits), dtype=torch.uint8, device=mother_soft.device)
    dec = torch.empty((b, t2p // 4, N_STATES), dtype=torch.uint8,
                      device=mother_soft.device)
    _build.launch(_build.load_library().tpudab_viterbi_decode_bits, mother_soft.get_device(),
                  "viterbi bits", mother_soft.data_ptr(), int(mother_soft.dtype == torch.bfloat16),
                  table.data_ptr(), dec.data_ptr(), out.data_ptr(), t, t2p, b, n_data_bits)
    viterbi_decode_bits_cuda.launches += 1
    return out


viterbi_decode_bits_cuda.launches = 0


def _as_soft(mother_soft) -> torch.Tensor:
    x = torch.as_tensor(mother_soft)
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.float32)
    return x


def viterbi_decode_best(mother_soft, n_data_bits: int) -> torch.Tensor:
    """(B, T, 4) mother soft bits (a tensor, or numpy for the CPU) ->
    (B, n_data_bits) uint8 bits on the same device; dispatches on it."""
    x = _as_soft(mother_soft)
    if x.device.type == "cpu":
        return viterbi_decode_ref(x, signs_on(x.device), n_data_bits)
    return viterbi_decode_bits_cuda(x.contiguous(), signs_on(x.device), n_data_bits)


def viterbi_decode_bytes_best(mother_soft, n_data_bits: int) -> torch.Tensor:
    """(B, T, 4) mother soft bits -> MSB-first packed bytes
    (B, n_data_bits // 8) uint8 on the same device: the flush-padded,
    transposed copy goes through viterbi_decode_bytes_t (K1 + K2 on CUDA)."""
    x = _as_soft(mother_soft)
    return viterbi_decode_bytes_t(mother_to_t(x), signs_on(x.device), n_data_bits)

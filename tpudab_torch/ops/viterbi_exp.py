"""The Viterbi kernel experiments: the forward pass alone in its variants,
and the traceback alone in three modes.

Counterparts of the forward and traceback kernels of tpudab's kernel-
experiment tools (X1, X2, X3, X5, X6; PERF.md section 6), each a part of
kernels K1 and K2 (tpudab/ops/viterbi_pallas.py:60,124) switched on or
off, run by tpudab_torch/tools/:

- fwd_variant(soft_t, signs, variant, rebase): transposed soft bits
  (T2p, 8, B), f32 or bf16 rebased every 16 or 32 super-steps, or int16
  rebased every 4 -> (decisions (B, T2p/4, 64) uint8, packed 4
  super-steps per byte as in K1, final path metrics (B, 64) f32; noacs:
  the running max that keeps its branch metrics of j = 2, 3).
  Variants: "full", "nodec", "noacs" (= "bmonly", which in tpudab's
  _variant_kernel is the same kernel), "prefetch", "dbuf", "gmm4" (also
  X1's wide kernel). int16 soft runs int16 path metrics (X3). tpudab's
  do_bm=False stand-in (a per-tile scalar times the row index) is not
  ported: no tool entry runs it.
- traceback_bytes(decs, mode, n_out): packed decisions (B, G, 64) -> MSB-
  first bytes (B, n_out), mode "shuffle" (the production traceback, X2's
  tbonly and X6's tb_t), "masked" (X5's pre-r5 masked reduction) or
  "tree" (X5's select tree; the kernel walks by one thread a codeword and
  picks by a load). The three give identical bytes.
- traceback_maps_ref(decs, mode, n_out, bits, compose): the same walk as
  csrc/viterbi.cu's traceback takes it (group_maps: each group's map of
  its 64 start states, built off the chain; then one pick a group, or one
  a pair of groups with compose=2), bytes out or, with bits, K3's one bit
  a byte. Held equal to traceback_bytes_ref and to tpudab's
  _tb_kernel_packed / _tb_kernel by tests/test_torch_traceback_maps.py.

Each dispatches on the tensor's device: a CPU tensor takes the plain torch
twin, a CUDA tensor the kernel in csrc/viterbi.cu, whose full variant is
the decode kernels' forward pass, and which matches the twin exactly.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from tpudab_torch.ops import _build
from tpudab_torch.ops.viterbi import N_STATES, RADIX, forward_ref, mother_to_t
from tpudab_torch.ops.viterbi_cuda import _kernel_table_for

# variant name -> the kernel's variant id (csrc/viterbi.cu::Variant)
VARIANTS = {"full": 0, "nodec": 1, "noacs": 2, "bmonly": 2, "prefetch": 3, "dbuf": 4,
            "gmm4": 5}
TB_MODES = {"shuffle": 0, "masked": 1, "tree": 2}
STAGE = 16      # super-steps the kernel stages at a time: T2p % STAGE == 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2}
# soft dtype -> the rebase intervals the kernel is built for (the tools' chunks)
REBASES = {torch.float32: (16, 32), torch.bfloat16: (16, 32), torch.int16: (4,)}


def _check_fwd(soft_t: torch.Tensor, variant: str, rebase: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown forward variant {variant!r}; one of {sorted(VARIANTS)}")
    t2p, eight, _ = soft_t.shape
    if eight != 4 * RADIX or t2p % STAGE or rebase not in REBASES.get(soft_t.dtype, ()) \
            or t2p % rebase:
        raise ValueError(f"forward variants take (T2p, 8, B) with T2p % {STAGE} == 0 and "
                         f"T2p % rebase == 0, rebase by dtype {REBASES}; got "
                         f"{soft_t.dtype} {tuple(soft_t.shape)}, rebase={rebase}")


def _pack(decs: torch.Tensor) -> torch.Tensor:
    """(T2p, 64, B) 2-bit decisions -> (B, T2p/4, 64), step 4g+q of group g
    in bits [6-2q, 8-2q) (K1's packing)."""
    t2p, n, b = decs.shape
    d = decs.view(t2p // 4, 4, n, b).to(torch.int32)
    by = (d[:, 0] << 6) | (d[:, 1] << 4) | (d[:, 2] << 2) | d[:, 3]
    return by.to(torch.uint8).permute(2, 0, 1).contiguous()


def fwd_variant_ref(soft_t: torch.Tensor, signs: torch.Tensor, variant: str = "full",
                    rebase: int = 32):
    """Plain twin of the forward variants: (decisions (B, T2p/4, 64) uint8,
    path metrics (B, 64) f32). prefetch, dbuf and gmm4 change only where the
    kernel computes the branch metrics, so their twin is full's."""
    _check_fwd(soft_t, variant, rebase)
    v = VARIANTS[variant]
    decs, pm = forward_ref(soft_t, signs, rebase, acs=v != VARIANTS["noacs"],
                           decisions=v != VARIANTS["nodec"])
    return _pack(decs), pm.t().to(torch.float32).contiguous()


def fwd_variant_cuda(soft_t: torch.Tensor, signs: torch.Tensor, variant: str = "full",
                     rebase: int = 32):
    """The forward variant kernel on a contiguous CUDA (T2p, 8, B) tensor."""
    _check_fwd(soft_t, variant, rebase)
    if not soft_t.is_cuda or not soft_t.is_contiguous():
        raise ValueError(f"fwd_variant_cuda takes a contiguous CUDA tensor, got "
                         f"{soft_t.device}, contiguous={soft_t.is_contiguous()}")
    table = _kernel_table_for(signs, soft_t.device)
    t2p, _, b = soft_t.shape
    decs = torch.empty((b, t2p // 4, N_STATES), dtype=torch.uint8, device=soft_t.device)
    pm = torch.empty((b, N_STATES), dtype=torch.float32, device=soft_t.device)
    _build.launch(_build.load_library().tpudab_viterbi_fwd_variant, soft_t.get_device(),
                  f"viterbi forward {variant}", soft_t.data_ptr(), _DTYPES[soft_t.dtype],
                  table.data_ptr(), decs.data_ptr(), pm.data_ptr(), t2p, b, VARIANTS[variant],
                  rebase)
    fwd_variant_cuda.launches += 1
    return decs, pm


fwd_variant_cuda.launches = 0


def fwd_variant(soft_t: torch.Tensor, signs: torch.Tensor, variant: str = "full",
                rebase: int = 32):
    """Dispatch on the soft bits' device: CPU -> twin, CUDA -> kernel."""
    if soft_t.device.type == "cpu":
        return fwd_variant_ref(soft_t, signs, variant, rebase)
    return fwd_variant_cuda(soft_t, signs, variant, rebase)


def _check_tb(decs: torch.Tensor, mode: str, n_out):
    if mode not in TB_MODES:
        raise ValueError(f"unknown traceback mode {mode!r}; one of {sorted(TB_MODES)}")
    if decs.dim() != 3 or decs.shape[2] != N_STATES or decs.dtype != torch.uint8:
        raise ValueError(f"decisions must be (B, G, 64) uint8, got {decs.dtype} "
                         f"{tuple(decs.shape)}")
    groups = decs.shape[1]
    n_out = groups if n_out is None else n_out
    if not 0 < n_out <= groups:
        raise ValueError(f"n_out={n_out} outside 1..{groups}")
    return n_out


def _pick(table: torch.Tensor, state: torch.Tensor, mode: str) -> torch.Tensor:
    """table (..., 64) int64, state (..., K) -> table[..., state] (..., K)
    by the mode's method: a gather, a masked sum over the 64 entries, or a
    6-level select."""
    if mode == "shuffle":
        return table.gather(-1, state)
    if mode == "masked":
        hit = torch.arange(N_STATES, device=table.device) == state[..., None]
        return torch.where(hit, table[..., None, :], 0).sum(-1)
    v = table[..., None, :].expand(*state.shape, N_STATES)
    for k in range(5, -1, -1):
        half = v.shape[-1] // 2
        bit = ((state >> k) & 1).bool()[..., None]
        v = torch.where(bit, v[..., half:], v[..., :half])
    return v[..., 0]


def traceback_bytes_ref(decs: torch.Tensor, mode: str = "shuffle", n_out=None) -> torch.Tensor:
    """Plain twin of the traceback kernel: packed decisions (B, G, 64) ->
    (B, n_out) MSB-first bytes, from state 0 at the last group."""
    n_out = _check_tb(decs, mode, n_out)
    b, groups, _ = decs.shape
    state = torch.zeros((b,), dtype=torch.long, device=decs.device)
    out = torch.empty((b, groups), dtype=torch.uint8, device=decs.device)
    for g in range(groups - 1, -1, -1):
        row = decs[:, g].to(torch.long)
        acc = torch.zeros_like(state)
        for q in range(3, -1, -1):
            j = (_pick(row, state[:, None], mode)[:, 0] >> (6 - 2 * q)) & 3
            acc = acc | ((state & 3) << (6 - 2 * q))
            state = (state >> RADIX) | (j << (6 - RADIX))
        out[:, g] = acc.to(torch.uint8)
    return out[:, :n_out].contiguous()


def group_maps(decs: torch.Tensor, mode: str = "shuffle") -> torch.Tensor:
    """Packed decisions (B, G, 64) -> the groups' maps (B, G, 64) int64.
    Entry s of group g: the state 4 super-steps back from start state s
    (bits 0-5) | j3 << 6, j3 = row_g[s] & 3 the walk's first decision. The
    group emits s | (entry & 0xc0): the walk's 2-bit shifts carry s itself
    into the byte's low 6 bits. Each entry needs the row alone, never the
    traceback's state."""
    _check_tb(decs, mode, None)
    row = decs.to(torch.long)
    j3 = row & 3
    t = (torch.arange(N_STATES, device=decs.device) >> RADIX) | (j3 << 4)
    for q in (2, 1, 0):
        t = (t >> RADIX) | (((_pick(row, t, mode) >> (6 - 2 * q)) & 3) << 4)
    return t | (j3 << 6)


def traceback_maps_ref(decs: torch.Tensor, mode: str = "shuffle", n_out=None,
                       bits: bool = False, compose: int = 1) -> torch.Tensor:
    """The traceback by group maps, from state 0 at the last group:
    packed decisions (B, G, 64) -> (B, n_out) MSB-first bytes, or with bits
    (B, n_out) one decoded bit a byte (n_out <= 8 G; K3's output). The
    chain picks one map entry a group (compose=1), or one a pair of groups
    (compose=2: group g's map composed with group g - 1's off the chain,
    from the last group down; an odd group 0 is picked alone)."""
    if compose not in (1, 2):
        raise ValueError(f"compose={compose}: 1 or 2 groups a pick")
    b, groups = decs.shape[:2]
    if bits:
        n_bits = 8 * groups if n_out is None else n_out
        if not 0 < n_bits <= 8 * groups:
            raise ValueError(f"n_out={n_bits} bits outside 1..{8 * groups}")
    else:
        n_out = _check_tb(decs, mode, n_out)
    maps = group_maps(decs, mode)
    state = torch.zeros((b, 1), dtype=torch.long, device=decs.device)
    out = torch.empty((b, groups), dtype=torch.long, device=decs.device)
    g = groups - 1
    if compose == 2 and groups > 1:
        # pair entries: group g's entry | group g-1's entry at its next state << 8
        hi, lo = maps[:, 1:], maps[:, :-1]
        pairs = hi | (_pick(lo, hi & 63, mode) << 8)           # (B, G - 1, 64)
        while g >= 1:
            e = _pick(pairs[:, g - 1], state, mode)
            out[:, g: g + 1] = state | (e & 0xc0)
            mid = e & 63
            out[:, g - 1: g] = mid | ((e >> 8) & 0xc0)
            state = (e >> 8) & 63
            g -= 2
    while g >= 0:
        e = _pick(maps[:, g], state, mode)
        out[:, g: g + 1] = state | (e & 0xc0)
        state = e & 63
        g -= 1
    if not bits:
        return out[:, :n_out].to(torch.uint8).contiguous()
    shifts = torch.arange(7, -1, -1, device=decs.device)
    unpacked = (out[:, :, None] >> shifts) & 1
    return unpacked.reshape(b, 8 * groups)[:, :n_bits].to(torch.uint8).contiguous()


def traceback_bytes_cuda(decs: torch.Tensor, mode: str = "shuffle", n_out=None) -> torch.Tensor:
    """The traceback kernel on a contiguous, 16-byte aligned CUDA tensor."""
    n_out = _check_tb(decs, mode, n_out)
    if not decs.is_cuda or not decs.is_contiguous() or decs.data_ptr() % 16:
        raise ValueError("traceback_bytes_cuda takes a contiguous, 16-byte aligned "
                         "CUDA tensor")
    b, groups, _ = decs.shape
    out = torch.empty((b, n_out), dtype=torch.uint8, device=decs.device)
    _build.launch(_build.load_library().tpudab_viterbi_traceback, decs.get_device(),
                  f"viterbi traceback {mode}", decs.data_ptr(), out.data_ptr(), groups, b,
                  n_out, TB_MODES[mode])
    traceback_bytes_cuda.launches += 1
    return out


traceback_bytes_cuda.launches = 0


def traceback_bytes(decs: torch.Tensor, mode: str = "shuffle", n_out=None) -> torch.Tensor:
    """Dispatch on the decisions' device: CPU -> twin, CUDA -> kernel."""
    if decs.device.type == "cpu":
        return traceback_bytes_ref(decs, mode, n_out)
    return traceback_bytes_cuda(decs, mode, n_out)


def forward_decisions(mother_soft: torch.Tensor, signs: torch.Tensor, chunk: int = 32,
                      variant: str = "full"):
    """The port of tpudab's _fwd_decisions (viterbi_pallas.py:189): the
    relayout flush-padded to whole chunks, then the forward pass rebased
    every chunk."""
    return fwd_variant(mother_to_t(mother_soft, 4 * RADIX * chunk), signs, variant, rebase=chunk)

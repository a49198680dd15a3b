"""Plain torch Viterbi decoder for the K=7 rate-1/4 DAB mother code.

Counterpart of tpudab.ops.viterbi, and the reference that the CUDA kernel
(tpudab_torch.ops.viterbi_cuda, csrc/viterbi.cu) is held to bit for bit.
It runs exactly the kernel's schedule, which is the one of tpudab's Pallas
forward kernel on its transposed path (tpudab/ops/viterbi_pallas.py:60):

- radix-2 trellis: one super-step consumes 8 mother soft bits (two input
  bits); super-transition reg = (j << 6) | s'' goes from predecessor
  pred_j(s'') = (s'' >> 2) | (j << 4) to destination state s'';
- branch metric of reg = sum over i = 0..7 of signs[i, reg] * soft[t, i],
  taken in f32 in index order (the signs are +-1, so each product is exact);
- 4-way compare-select as pairwise strict `>` selects (ties keep the lower
  predecessor index), f32 path metrics starting at 0 for state 0 and -1e9
  elsewhere, rebased by pm[0] after every 16 super-steps;
- traceback from state 0, emitting state & 3 = (u_2t << 1) | u_2t+1 per
  super-step; the bytes entry packs 4 super-steps (8 decoded bits) per
  MSB-first output byte (K2), the bits entry unpacks them (K3).

Two layouts go in: the transposed (T2p, 8, B) of the receive step, and
the (B, T, 4) mother soft bits of the host per-stage path, flush-padded
and transposed by mother_to_t. Both run the one forward pass below.

Soft-bit convention: +1 => bit 0, -1 => bit 1, 0 => erasure.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudab_torch.fec.conv import OUTPUT_SIGNS, N_STATES

NEG = -1e9
RADIX = 2            # trellis steps per super-step
REBASE_STEPS = 16    # super-steps between path-metric rebases


@functools.lru_cache(maxsize=None)
def radix_tables(k: int = RADIX):
    """(signs (4k, 64 << k) f32, preds (2^k, 64) i32) for a radix-2^k
    trellis; step i of super-transition reg is the single-step transition
    (reg >> (k-1-i)) & 127. Same tables as tpudab.ops.viterbi._radix_tables."""
    n_trans = N_STATES << k
    reg = np.arange(n_trans, dtype=np.int64)
    rows = [OUTPUT_SIGNS[(reg >> (k - 1 - i)) & 127, :].T for i in range(k)]
    signs = np.ascontiguousarray(np.concatenate(rows, axis=0))
    j = np.arange(1 << k, dtype=np.int32)[:, None]
    spp = np.arange(N_STATES, dtype=np.int32)[None, :]
    preds = (spp >> k) | (j << (6 - k))
    return signs, preds


def branch_metric_table(signs: torch.Tensor):
    """The super-transitions' branch metrics as signed copies of a few
    distinct sums, the map the CUDA forward pass computes them by.

    signs: the (8, 256) sign table (radix_tables()[0]). Returns
    (magnitude signs (M, 8) f32 +-1 with column 0 all +1, index (4, 64)
    int64, negate (4, 64) bool): super-transition (j << 6) | s has the
    sign pattern of magnitude index[j, s], negated where negate[j, s]
    (so that its first sign is +1). Magnitudes are in lexicographic order
    of their patterns. The 256 patterns of DAB's mother code come to 32
    magnitudes (generators 1 and 4 are both 0133). Raises if there are
    more than 32: the kernel computes one magnitude per lane of a warp.

    Round-to-nearest is sign-symmetric, so a pattern's index-order sum is
    exactly the negation of its complement's, up to the sign of an exact
    zero, which an add to a path metric cannot see (a path metric is never
    -0)."""
    s = torch.as_tensor(signs, dtype=torch.float32).cpu()
    pats = s.t() * s[0][:, None]                              # (256, 8), s0 = +1
    mags, inverse = torch.unique(pats, dim=0, return_inverse=True)
    if mags.shape[0] > 32:
        raise ValueError(f"the sign table has {mags.shape[0]} distinct branch-metric "
                         f"magnitudes; the kernel takes at most 32")
    return (mags.contiguous(), inverse.view(4, N_STATES).to(torch.int64),
            (s[0] < 0).view(4, N_STATES))


def shared_branch_metrics_ref(x: torch.Tensor, table) -> torch.Tensor:
    """One super-step's soft values x (8, B), bf16, f32 or int16 -> the
    (4, 64, B) branch metrics of super-transitions (j << 6) | s, from the
    table's magnitudes, each summed once in index order
    (m = s0*x0; m = m + s1*x1; ...) and negated where the table says: the
    arithmetic of the CUDA forward pass. f32 sums for bf16 and f32 soft,
    int16 with wrap-around for int16, as forward_ref."""
    msigns, index, negate = table
    mt = torch.int16 if x.dtype == torch.int16 else torch.float32
    xm = x.to(mt)
    sg = msigns.to(mt).to(x.device)[:, :, None]               # (M, 8, 1)
    m = sg[:, 0] * xm[0]
    for i in range(1, 4 * RADIX):
        m = m + sg[:, i] * xm[i]                              # (M, B)
    bm = m[index.to(x.device)]                                # (4, 64, B)
    return torch.where(negate.to(x.device)[:, :, None], -bm, bm)


def pad_mother_soft(mother_soft: torch.Tensor, target_steps: int,
                    amplitude: float = 1.0) -> torch.Tensor:
    """Right-pad (..., T, 4) mother soft bits to (..., target_steps, 4) with
    +amplitude: perfect evidence for a continued zero-input flush, exact
    with respect to the decoded prefix."""
    t = mother_soft.shape[-2]
    pad = mother_soft.new_full(mother_soft.shape[:-2] + (target_steps - t, 4),
                               amplitude)
    return torch.cat([mother_soft, pad], dim=-2)


def forward_ref(soft_t: torch.Tensor, signs: torch.Tensor, rebase: int = REBASE_STEPS,
                acs: bool = True, decisions: bool = True):
    """The forward pass with its parts switchable, for the kernel
    experiments (tpudab_torch/ops/viterbi_exp.py): transposed soft bits
    (T2p, 8, B) -> (decisions (T2p, 64, B) uint8, path metrics (64, B)).

    bf16 or f32 soft runs f32 metrics (start -1e9); int16 soft runs int16
    metrics with int16 wrap-around (start -16000, tools/exp_viterbi_i16.py).
    Metrics are rebased by state 0 after every `rebase` super-steps.
    acs=False runs no recursion: it takes the decision bm[j=0] > bm[j=1]
    from the branch metrics alone and returns, per state, the running max
    of the start value and bm[j=2], bm[j=3] over all steps (what keeps the
    kernel computing all four); decisions=False runs the ACS chain and
    leaves the decisions zero."""
    t2p, eight, b = soft_t.shape
    if eight != 4 * RADIX:
        raise ValueError(f"bad Viterbi soft layout {tuple(soft_t.shape)}")
    dev = soft_t.device
    i16 = soft_t.dtype == torch.int16
    mt = torch.int16 if i16 else torch.float32
    x = soft_t.to(mt)
    preds = torch.as_tensor(radix_tables()[1], dtype=torch.long, device=dev)
    sg = signs.to(mt)[:, :, None]                             # (8, 256, 1)
    pm = torch.full((N_STATES, b), -16000 if i16 else NEG, dtype=mt, device=dev)
    pm[0] = 0
    decs = torch.zeros((t2p, N_STATES, b), dtype=torch.uint8, device=dev)
    for t in range(t2p):
        xt = x[t]
        bm = sg[0] * xt[0]
        for i in range(1, 4 * RADIX):
            bm = bm + sg[i] * xt[i]
        bm = bm.view(4, N_STATES, b)
        if not acs:
            decs[t] = (bm[0] > bm[1]).to(torch.uint8)
            m23 = torch.where(bm[3] > bm[2], bm[3], bm[2])
            pm = torch.where(m23 > pm, m23, pm)
            continue
        c = pm[preds] + bm                                    # (4, 64, B)
        d01 = c[1] > c[0]
        m01 = torch.where(d01, c[1], c[0])
        d23 = c[3] > c[2]
        m23 = torch.where(d23, c[3], c[2])
        dh = m23 > m01
        pm = torch.where(dh, m23, m01)
        if decisions:
            decs[t] = torch.where(dh, d23.to(torch.uint8) | 2, d01.to(torch.uint8))
        if (t + 1) % rebase == 0:
            pm = pm - pm[0:1]
    return decs, pm


def viterbi_forward_ref(soft_t: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Forward pass (the plain twin of kernel K1): transposed soft bits
    (T2p, 8, B), bf16 or f32 -> decisions (T2p, 64, B) uint8, one 2-bit
    predecessor index j per super-step and destination state. signs is
    radix_tables()[0] as an f32 tensor (8, 256) on soft_t's device."""
    return forward_ref(soft_t.to(torch.float32), signs)[0]


def viterbi_traceback_ref(decs: torch.Tensor) -> torch.Tensor:
    """Traceback from state 0 over (T2p, 64, B) decisions -> (T2p, B) uint8,
    one value (u_2t << 1) | u_2t+1 per super-step t (kernel K3's output)."""
    t2p, _, b = decs.shape
    state = torch.zeros((1, b), dtype=torch.long, device=decs.device)
    pairs = torch.empty((t2p, b), dtype=torch.uint8, device=decs.device)
    for t in range(t2p - 1, -1, -1):
        j = decs[t].gather(0, state).to(torch.long)
        pairs[t] = (state[0] & 3).to(torch.uint8)
        state = (state >> RADIX) | (j << (6 - RADIX))
    return pairs


def viterbi_decode_bytes_t_ref(soft_t: torch.Tensor, signs: torch.Tensor,
                               n_data_bits: int) -> torch.Tensor:
    """Plain twin of kernels K1 + K2: transposed soft bits (T2p, 8, B),
    bf16 or f32 -> MSB-first packed bytes (B, n_data_bits // 8) uint8."""
    t2p, _, b = soft_t.shape
    if t2p % 4 or n_data_bits % 8 or n_data_bits > RADIX * t2p:
        raise ValueError(f"bad Viterbi geometry {tuple(soft_t.shape)}, "
                         f"n_data_bits={n_data_bits}")
    pairs = viterbi_traceback_ref(viterbi_forward_ref(soft_t, signs))
    q = pairs.view(t2p // 4, 4, b).to(torch.int32)
    by = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return by.to(torch.uint8).t()[:, : n_data_bits // 8].contiguous()


def mother_to_t(mother_soft: torch.Tensor, steps: int = RADIX * REBASE_STEPS,
                value: float = 1.0) -> torch.Tensor:
    """(B, T, 4) mother soft bits -> the transposed layout (T2p, 8, B) in
    the same dtype, T padded with `value` to a multiple of `steps` mother
    steps: by default the +1.0 flush to a multiple of 32 (T2p % 16 == 0),
    as tpudab's Pallas path pads (tpudab/ops/viterbi_pallas.py:201; chunk
    c pads to 8c there)."""
    b, t, four = mother_soft.shape
    if four != 4:
        raise ValueError(f"mother soft bits {tuple(mother_soft.shape)} are not (B, T, 4)")
    tp = -(-t // steps) * steps
    x = pad_mother_soft(mother_soft, tp, value) if tp != t else mother_soft
    return x.reshape(b, tp // RADIX, 4 * RADIX).permute(1, 2, 0).contiguous()


def viterbi_decode_ref(mother_soft: torch.Tensor, signs: torch.Tensor,
                       n_data_bits: int) -> torch.Tensor:
    """Plain twin of kernels K1 + K3: mother soft bits (B, T, 4), bf16 or
    f32 -> decoded bits (B, n_data_bits) uint8, the traceback's pairs
    unpacked as tpudab/ops/viterbi_pallas.py:308-311 does."""
    b, t, _ = mother_soft.shape
    if n_data_bits > t:
        raise ValueError(f"n_data_bits={n_data_bits} exceeds T={t}")
    pairs = viterbi_traceback_ref(viterbi_forward_ref(mother_to_t(mother_soft), signs))
    bits = torch.stack([(pairs >> 1) & 1, pairs & 1], dim=-1)     # (T2p, B, 2)
    return bits.permute(1, 0, 2).reshape(b, -1)[:, :n_data_bits].contiguous()

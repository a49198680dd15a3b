"""K1+K2's thread layouts (csrc/viterbi.cu::viterbi_kernel) on the CPU: the
rule that picks one from the batch (ops/viterbi_cuda.py::k12_layout), the
sign masks and the coset of offsets the butterfly layouts compile in, the
exchange buffer's banks, and a numpy twin of one butterfly thread's program
(forward_butterflies, with two or four butterflies a thread: the split of
the signs into the thread's own and compile-time ones, the prefix tree of
its 8 sums, the exchange in state order, the packed decision words) against
the plain forward pass, ties included.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudab_torch.ops.viterbi import N_STATES, RADIX, forward_ref, radix_tables
from tpudab_torch.ops.viterbi_cuda import (BFLY4_LAYOUT, BFLY_LAYOUT,
                                           BFLY_LAYOUT_CODEWORDS_PER_SM, WARP_LAYOUT,
                                           WARP_LAYOUT_CODEWORDS_PER_SM, k12_layout)

CSRC = Path(__file__).resolve().parent.parent / "tpudab_torch" / "csrc" / "viterbi.cu"
COSET = (0, 6, 11, 13)  # csrc/viterbi.cu::kCoset: a thread's butterflies k0 ^ v
# csrc/viterbi.cu::BflyMap by butterflies a thread: lane -> (codeword of the
# warp, thread r of it), base(r) = k0, and kPm (floats of a codeword's buffer)
LAYOUTS = {2: (lambda lane: (lane // 8, lane % 8), lambda r: r | ((r & 4) << 1), 72),
           4: (lambda lane: (lane % 8, lane // 8), lambda r: r, 68)}


def sign_masks(signs) -> int:
    """The radix-2 sign table (8, 256) as 8 masks, byte n: soft value n of
    super-transition reg is negated where the parity of mask n & reg is
    odd. Raises unless the table is that linear map."""
    neg = np.asarray(signs) < 0
    packed = 0
    for n in range(4 * RADIX):
        mask = sum(int(neg[n, 1 << k]) << k for k in range(8))
        parity = [bin(mask & reg).count("1") & 1 for reg in range(N_STATES << RADIX)]
        if not np.array_equal(parity, neg[n]):
            raise ValueError(f"sign row {n} is not a parity of the super-transition register")
        packed |= mask << (8 * n)
    return packed


GEN_MASKS = sign_masks(radix_tables()[0])   # the kernel's kGenMasks, if the test below holds


@pytest.mark.parametrize("b,want", [(1, WARP_LAYOUT), (300, WARP_LAYOUT), (2048, WARP_LAYOUT),
                                    (4224, WARP_LAYOUT), (4225, BFLY_LAYOUT),
                                    (6336, BFLY_LAYOUT), (6337, BFLY4_LAYOUT),
                                    (12288, BFLY4_LAYOUT)])
def test_k12_layout_at_132_sms(b, want):
    """An H100 SXM's 132 SMs: one warp a codeword up to 4224 codewords (the
    FIC's 2048, decode's and stream's few hundred), two butterflies a
    thread up to 6336, four past them (the MSC's 12288)."""
    assert k12_layout(b, 132) == want


@pytest.mark.parametrize("sm_count", [1, 66, 114, 132])
def test_k12_layout_monotone_in_b(sm_count):
    """Once a layout with more states a thread is picked it stays picked as
    B grows; the switches lie at WARP_LAYOUT_CODEWORDS_PER_SM and
    BFLY_LAYOUT_CODEWORDS_PER_SM codewords an SM."""
    picks = [k12_layout(b, sm_count) for b in range(1, 40 * WARP_LAYOUT_CODEWORDS_PER_SM
                                                    * sm_count, 7)]
    assert set(picks) == {WARP_LAYOUT, BFLY_LAYOUT, BFLY4_LAYOUT}
    assert picks == sorted(picks)


@pytest.mark.parametrize("sm_count", [66, 114, 132])
@pytest.mark.parametrize("per_sm,below,above", [
    (WARP_LAYOUT_CODEWORDS_PER_SM, WARP_LAYOUT, BFLY_LAYOUT),
    (BFLY_LAYOUT_CODEWORDS_PER_SM, BFLY_LAYOUT, BFLY4_LAYOUT)])
def test_k12_layout_at_each_edge(sm_count, per_sm, below, above):
    """At and around each edge on cards of 66, 114 and 132 SMs: the edge
    itself and one codeword under it keep the smaller layout, one over it
    takes the next; the edges are 32 and 48 codewords an SM."""
    edge = per_sm * sm_count
    assert [k12_layout(b, sm_count) for b in (edge - 1, edge, edge + 1)] == [below, below, above]
    assert (WARP_LAYOUT_CODEWORDS_PER_SM, BFLY_LAYOUT_CODEWORDS_PER_SM) == (32, 48)


def test_sign_masks_are_the_kernels():
    """The masks of DAB's sign table, as the butterfly layout compiles them
    in (kGenMasks), byte for byte."""
    m = re.search(r"kGenMasks = (0x[0-9a-f]+)ull;", CSRC.read_text())
    assert m and int(m.group(1), 16) == GEN_MASKS


def test_sign_masks_refuse_a_table_that_is_not_linear():
    signs = radix_tables()[0].copy()
    signs[3, 5] = -signs[3, 5]
    with pytest.raises(ValueError):
        sign_masks(signs)


def sign_bit(n: int, reg: int) -> int:
    return bin(((GEN_MASKS >> (8 * n)) & 0xFF) & reg).count("1") & 1


def bm_tree():
    """bm_tree() of csrc/viterbi.cu, rebuilt over the four offsets of V:
    (patterns, [(parent, neg)] per level, mag[w][i][j], flip[w][i][j])."""
    pats, mag, flip = [], np.zeros((4, 4, 4), int), np.zeros((4, 4, 4), int)
    for w, v in enumerate(COSET):
        for i in range(4):
            for j in range(4):
                reg = (j << 6) | (4 * v) | i
                s0 = sign_bit(0, reg)
                pat = sum((sign_bit(n, reg) ^ s0) << n for n in range(1, 8))
                if pat not in pats:
                    pats.append(pat)
                mag[w, i, j], flip[w, i, j] = pats.index(pat), s0
    levels, prev = [], [0]
    for n in range(1, 8):
        keep, cur, parent, neg = (2 << n) - 1, [], [], []
        for p in pats:
            pre = p & keep
            if pre not in cur:
                cur.append(pre)
                parent.append(prev.index(pre & (keep >> 1)))
                neg.append((pre >> n) & 1)
        levels.append((parent, neg))
        prev = cur
    return pats, levels, mag, flip


def test_bm_tree_has_8_sums_and_34_adds():
    """The four butterflies of a coset take 8 distinct sums (a prefix tree
    of 2 + 2 + 2 + 4 + 8 + 8 + 8 adds), and every (butterfly, i, j) of the
    four takes one of them."""
    pats, levels, mag, _ = bm_tree()
    assert len(pats) == 8
    assert [len(parent) for parent, _ in levels] == [2, 2, 2, 4, 8, 8, 8]
    assert sum(len(parent) for parent, _ in levels) == 34
    assert mag.shape == (4, 4, 4) and set(mag.ravel()) == set(range(8))


def test_each_offsets_sums_are_the_trees():
    """For every k0, the branch metric the kernel forms for (butterfly w,
    state i, predecessor j), (-1)^flip t_0 times sum mag of the tree over
    u_n = t_n t_0, has soft value n's sign of super-transition (j << 6) |
    4 (k0 ^ v_w) | i: sign flip ^ (bit n of the sum's pattern) ^ t_n."""
    pats, _, mag, flip = bm_tree()
    for k0 in range(16):
        for w, v in enumerate(COSET):
            for i in range(4):
                for j in range(4):
                    reg = (j << 6) | (4 * (k0 ^ v)) | i
                    got = [flip[w, i, j] ^ ((pats[mag[w, i, j]] >> n) & 1) ^ sign_bit(n, 4 * k0)
                           for n in range(8)]
                    assert got == [sign_bit(n, reg) for n in range(8)]


def test_coset_splits_the_16_butterflies():
    """V = {0, 6, 11, 13} is a subgroup under XOR, and the cosets r ^ V of
    the bases r = 0..3 (the four-butterfly layout's threads of a codeword)
    split the 16 butterflies evenly; the two-butterfly layout's pairs
    {base(r), base(r) ^ 6} do too."""
    assert {a ^ b for a in COSET for b in COSET} == set(COSET)
    cosets = [{r ^ v for v in COSET} for r in range(4)]
    assert sorted(k for c in cosets for k in c) == list(range(16))
    pairs = [{k0, k0 ^ COSET[1]} for k0 in (LAYOUTS[2][1](r) for r in range(8))]
    assert sorted(k for c in pairs for k in c) == list(range(16))
    m = re.search(r"kCoset = (0x[0-9a-f]+);", CSRC.read_text())
    assert m and [(int(m.group(1), 16) >> (4 * w)) & 15 for w in range(4)] == list(COSET)


@pytest.mark.parametrize("n_bfly", [2, 4])
def test_exchange_is_free_of_bank_conflicts(n_bfly):
    """The exchange buffer of csrc/viterbi.cu::BflyMap: a quarter warp's
    16-byte stores (one butterfly's 4 new metrics a thread) fall on 8
    distinct 16-byte bank groups, and a warp's scalar loads (predecessor j
    of one butterfly) on 32 distinct banks, at every offset w and j."""
    lane_of, base, pm = LAYOUTS[n_bfly]
    text = CSRC.read_text()
    assert re.search(r"kPm = kBfly == 2 \? 72 : 68;", text)
    for w in range(n_bfly):
        addr = {}
        for lane in range(32):
            c, r = lane_of(lane)
            addr[lane] = c * pm + 4 * (base(r) ^ COSET[w])            # floats
        for quarter in range(4):
            groups = {(addr[lane] // 4) % 8 for lane in range(8 * quarter, 8 * quarter + 8)}
            assert len(groups) == 8
        for j in range(4):
            banks = set()
            for lane in range(32):
                c, r = lane_of(lane)
                banks.add((c * pm + (base(r) ^ COSET[w]) + 16 * j) % 32)
            assert len(banks) == 32


def butterfly_twin(soft_t: torch.Tensor, n_bfly: int) -> np.ndarray:
    """forward_butterflies' arithmetic in numpy f32, thread by thread, with
    n_bfly butterflies a thread: (T2p, 8, B) soft -> packed decision rows
    (B, T2p / 4, 64) uint8."""
    x = soft_t.to(torch.float32).numpy()
    t2p, _, b = x.shape
    _, levels, mag, flip = bm_tree()
    _, base, _ = LAYOUTS[n_bfly]
    f32 = np.float32
    pm = np.full((64, b), -1e9, f32)
    pm[0] = 0.0
    rows = np.zeros((b, t2p // 4, 64), np.uint8)
    acc = {}
    for t in range(t2p):
        new = np.empty_like(pm)
        for r in range(16 // n_bfly):
            k0 = base(r)
            u = [f32(-1.0 if sign_bit(n, 4 * k0) ^ sign_bit(0, 4 * k0) else 1.0)
                 for n in range(8)]
            t0s = f32(-1.0 if sign_bit(0, 4 * k0) else 1.0)
            lvl = [x[t, 0]]
            for n, (parent, neg) in enumerate(levels, start=1):
                lvl = [(lvl[p] + (-u[n] if ng else u[n]) * x[t, n]).astype(f32)
                       for p, ng in zip(parent, neg)]
            for w in range(n_bfly):
                k = k0 ^ COSET[w]
                d = np.zeros(b, np.uint32)
                for i in range(4):
                    c = [(pm[k + 16 * j] + (-t0s if flip[w, i, j] else t0s)
                          * lvl[mag[w, i, j]]).astype(f32) for j in range(4)]
                    d01, d23 = c[1] > c[0], c[3] > c[2]
                    m01, m23 = np.maximum(c[0], c[1]), np.maximum(c[2], c[3])
                    dh = m23 > m01
                    new[4 * k + i] = np.maximum(m01, m23)
                    d |= np.where(dh, np.where(d23, 3, 2), np.where(d01, 1, 0)).astype(
                        np.uint32) << (8 * i)
                acc[k] = (acc.get(k, 0) if t % 4 else 0) * 4 + d
                if t % 4 == 3:
                    rows[:, t // 4, 4 * k: 4 * k + 4] = (
                        acc[k][:, None] >> (8 * np.arange(4, dtype=np.uint32))).astype(np.uint8)
        pm = new
        if t % 16 == 15:
            pm = (pm - pm[0:1]).astype(f32)
    return rows


@pytest.mark.parametrize("n_bfly", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t2p,b", [(16, 5), (48, 21)])
def test_butterfly_twin_equals_forward_ref(dtype, t2p, b, n_bfly):
    """The butterfly thread program's decision rows are the plain forward
    pass's, packed (step q in bits [6 - 2q, 8 - 2q) of state s's byte at
    offset s), bit for bit: a fifth of the codewords erased (every
    compare-select ties) and some soft values equal in magnitude."""
    rng = np.random.default_rng(t2p * 100 + b)
    soft = torch.from_numpy(rng.standard_normal((t2p, 8, b), dtype=np.float32))
    soft[:, :, : b // 5] = 0.0
    soft[:, :, b // 5: b // 5 + 3] = torch.round(soft[:, :, b // 5: b // 5 + 3])
    soft = soft.to(dtype)
    decs = forward_ref(soft.to(torch.float32), torch.from_numpy(radix_tables()[0]))[0].numpy()
    want = np.zeros((t2p // 4, 64, b), np.uint32)
    for q in range(4):
        want |= decs[q::4].astype(np.uint32) << (6 - 2 * q)
    assert np.array_equal(butterfly_twin(soft, n_bfly), want.transpose(2, 0, 1).astype(np.uint8))

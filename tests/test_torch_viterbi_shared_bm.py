"""The shared-branch-metric map of the CUDA forward pass
(tpudab_torch/ops/viterbi.py::branch_metric_table and
::shared_branch_metrics_ref), on the CPU.

The kernel computes each super-step's 32 distinct index-order sums once
and hands each state its branch metrics as signed copies. These tests hold
that arithmetic to the plain forward pass's own per-state sums
(forward_ref's `bm = sg[0] * xt[0]; bm = bm + sg[i] * xt[i]`) bit for bit.
"""

import numpy as np
import pytest
import torch

from tpudab_torch.ops.viterbi import (N_STATES, branch_metric_table, radix_tables,
                                      shared_branch_metrics_ref)
from tpudab_torch.ops.viterbi_cuda import kernel_table

SIGNS = torch.from_numpy(radix_tables()[0])


def forward_ref_sums(x: torch.Tensor) -> torch.Tensor:
    """forward_ref's branch metrics of one super-step, (8, B) -> (4, 64, B)."""
    mt = torch.int16 if x.dtype == torch.int16 else torch.float32
    xt, sg = x.to(mt), SIGNS.to(mt)[:, :, None]
    bm = sg[0] * xt[0]
    for i in range(1, 8):
        bm = bm + sg[i] * xt[i]
    return bm.view(4, N_STATES, -1)


def test_table_rebuilds_the_signs():
    msigns, index, negate = branch_metric_table(SIGNS)
    assert (msigns[:, 0] == 1).all() and set(msigns.unique().tolist()) == {-1.0, 1.0}
    rebuilt = msigns[index.view(-1)] * torch.where(negate.view(-1), -1.0, 1.0)[:, None]
    assert torch.equal(rebuilt.t(), SIGNS)


def test_table_has_32_magnitudes():
    msigns, index, _ = branch_metric_table(SIGNS)
    assert msigns.shape == (32, 8) and torch.equal(index.unique(), torch.arange(32))
    # the kernel's pairing: state 2l + 1 takes the magnitudes of state 2l, j ^ 2
    assert torch.equal(index[:, 1::2], index[[2, 3, 0, 1], 0::2])
    with pytest.raises(ValueError, match="at most 32"):
        branch_metric_table(torch.from_numpy(
            np.random.default_rng(0).choice([-1.0, 1.0], (8, 256)).astype(np.float32)))


def test_kernel_table_packs_the_map():
    """The (2, 32) int32 table the kernels read unpacks to the map."""
    msigns, index, negate = branch_metric_table(SIGNS)
    table = kernel_table(SIGNS).to(torch.int64)
    assert table.dtype == torch.int64 and table.shape == (2, 32)
    bits = (table[0][:, None] >> torch.arange(8)) & 1
    assert torch.equal(bits.bool(), msigns < 0)
    j = torch.arange(4)[:, None]
    assert torch.equal((table[1][None] >> (5 * j)) & 31, index[:, 0::2])
    assert torch.equal(((table[1][None] >> (20 + j)) & 1).bool(), negate[:, 0::2])
    assert torch.equal(((table[1][None] >> (24 + j)) & 1).bool(), negate[:, 1::2])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("kind", ["f32_wide", "f32_normal", "f32_erasures", "bf16", "int16"])
def test_shared_metrics_equal_forward_ref_sums(kind):
    rng = np.random.default_rng(7)
    b = 4096
    if kind == "f32_wide":     # magnitudes over 2^-20 .. 2^20: the order of the adds matters
        mag = np.exp2(rng.uniform(-20, 20, (8, b)))
        x = torch.from_numpy((rng.choice([-1.0, 1.0], (8, b)) * mag).astype(np.float32))
    elif kind == "int16":      # wraps around
        x = torch.from_numpy(rng.integers(-32768, 32768, (8, b)).astype(np.int16))
    else:
        x = torch.from_numpy(rng.standard_normal((8, b), dtype=np.float32))
        if kind == "f32_erasures":
            x[:, rng.random(b) < 0.5] = 0.0
            x[rng.random((8, b)) < 0.3] = 0.0
        elif kind == "bf16":
            x = x.to(torch.bfloat16)
    got = shared_branch_metrics_ref(x, branch_metric_table(SIGNS))
    want = forward_ref_sums(x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    # bit for bit; an exact zero may differ in its sign only (see branch_metric_table)
    nz = want != 0
    assert torch.equal(_bits(got)[nz], _bits(want)[nz])
    if kind == "f32_wide":
        assert nz.all()

"""The group-map traceback (tpudab_torch/ops/viterbi_exp.py::group_maps and
::traceback_maps_ref, the algorithm of csrc/viterbi.cu's traceback) against
the per-super-step traceback on the CPU.

The twin builds each group's map of its 64 start states off the chain and
then picks one entry a group (or a pair of groups, compose=2). It must give
the bytes of traceback_bytes_ref in every mode, and the bytes and bits of
tpudab's own traceback kernels, _tb_kernel_packed (K2) and _tb_kernel (K3,
tpudab/ops/viterbi_pallas.py:124,153), run as a pl.pallas_call in interpret
mode, as tpudab's tests run Pallas on the CPU. Inputs: packed decisions
(B, G, 64) made from a seed with numpy, random bytes or the forward pass's
decisions over soft bits with erased codewords (all-zero soft bits: ties)
and erased leading rows (a deinterleaver's warm-up); G of 1, 7, 33 and 448,
the tools' width. Tolerance: none, bytes and bits equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.ops.viterbi_pallas import _tb_kernel, _tb_kernel_packed
from tpudab_torch.ops.viterbi import viterbi_traceback_ref
from tpudab_torch.ops.viterbi_cuda import signs_on
from tpudab_torch.ops.viterbi_exp import (fwd_variant_ref, group_maps, traceback_bytes_ref,
                                          traceback_maps_ref)

B = 6
GROUPS = [1, 7, 33, 448]
KINDS = ["random", "erased"]
MODES = ["shuffle", "masked", "tree"]


@functools.cache
def forward_decisions(groups_max: int = 448) -> torch.Tensor:
    """The plain forward pass's packed decisions (B, 448, 64) over seeded
    Gaussian soft bits: codeword 0 erased whole, codeword 1 erased in its
    first 40 super-steps, the rest not."""
    rng = np.random.default_rng(70)
    soft = rng.standard_normal((4 * groups_max, 8, B)).astype(np.float32)
    soft[:, :, 0] = 0.0
    soft[:40, :, 1] = 0.0
    decs, _ = fwd_variant_ref(torch.from_numpy(soft), signs_on(torch.device("cpu")), "full", 16)
    return decs


def decisions(kind: str, groups: int) -> torch.Tensor:
    if kind == "random":
        rng = np.random.default_rng(groups)
        return torch.from_numpy(rng.integers(0, 256, (B, groups, 64)).astype(np.uint8))
    return forward_decisions()[:, :groups].contiguous()


def tpudab_traceback(decs: torch.Tensor, bits: bool) -> np.ndarray:
    """tpudab's _tb_kernel_packed (bytes (B, G)) or _tb_kernel (bits
    (B, 8 G), its per-super-step output unpacked as viterbi_pallas.py:308-311
    does) on the port's (B, G, 64) decisions, one block over the whole
    array, interpreted."""
    groups = decs.shape[1]
    x = jnp.asarray(decs.permute(1, 2, 0).numpy())          # tpudab's (G, 64, B)
    rows = 4 * groups if bits else groups
    out = pl.pallas_call(
        _tb_kernel if bits else _tb_kernel_packed, grid=(1, 1),
        in_specs=[pl.BlockSpec((groups, 64, B), lambda j, i: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rows, 1, B), lambda j, i: (0, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, 1, B), jnp.uint8),
        scratch_shapes=[pltpu.VMEM((1, B), jnp.int32)], interpret=True)(x)
    out = np.asarray(out)[:, 0, :].T                         # (B, rows)
    if not bits:
        return out
    return np.stack([(out >> 1) & 1, out & 1], axis=-1).reshape(B, -1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("groups", GROUPS)
def test_maps_equal_reference(groups, kind):
    """Every mode, one and two groups a pick, all of G and n_out < G:
    the bytes of traceback_bytes_ref in the same mode."""
    decs = decisions(kind, groups)
    n_short = max(1, groups - 5)
    for mode in MODES:
        want = traceback_bytes_ref(decs, mode)
        assert torch.equal(want, traceback_bytes_ref(decs, "shuffle"))
        for compose in (1, 2):
            assert torch.equal(traceback_maps_ref(decs, mode, compose=compose), want), mode
            assert torch.equal(traceback_maps_ref(decs, mode, n_short, compose=compose),
                               want[:, :n_short]), mode


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("groups", GROUPS)
def test_maps_equal_tpudab_packed(groups, kind):
    """Bytes out (K2): equal to tpudab's _tb_kernel_packed in every mode."""
    decs = decisions(kind, groups)
    want = tpudab_traceback(decs, bits=False)
    for mode in MODES:
        for compose in (1, 2):
            np.testing.assert_array_equal(traceback_maps_ref(decs, mode, compose=compose).numpy(),
                                          want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("groups", GROUPS)
def test_maps_bits_equal_tpudab_tb_kernel(groups, kind):
    """Bits out (K3): equal to tpudab's _tb_kernel and to the port's plain
    decoder's traceback (viterbi_traceback_ref on the unpacked decisions),
    all 8 G bits and a tail n_out not a multiple of 8."""
    decs = decisions(kind, groups)
    want = tpudab_traceback(decs, bits=True)
    shifts = torch.tensor([6, 4, 2, 0])
    unpacked = (decs.permute(1, 2, 0)[:, None].to(torch.long) >> shifts[None, :, None, None]) & 3
    pairs = viterbi_traceback_ref(unpacked.reshape(4 * groups, 64, B)).T.to(torch.long)
    plain = torch.stack([(pairs >> 1) & 1, pairs & 1], -1).reshape(B, -1).numpy()
    np.testing.assert_array_equal(plain, want)
    n_tail = 8 * groups - 3
    for mode in MODES:
        for compose in (1, 2):
            got = traceback_maps_ref(decs, mode, bits=True, compose=compose).numpy()
            np.testing.assert_array_equal(got, want)
            tail = traceback_maps_ref(decs, mode, n_tail, bits=True, compose=compose).numpy()
            np.testing.assert_array_equal(tail, want[:, :n_tail])


@pytest.mark.parametrize("mode", MODES)
def test_group_map_entries_walk_four_steps(mode):
    """Each map entry is the 4-super-step walk from its start state: the
    state it reaches (bits 0-5) and, with the start state, the byte it emits
    (s | entry & 0xc0), for every start state of every group."""
    decs = decisions("erased", 7)
    maps = group_maps(decs, mode)
    row = decs.to(torch.long)
    state = torch.arange(64).expand(B, 7, 64)
    byte = torch.zeros_like(state)
    for q in range(3, -1, -1):
        j = (row.gather(-1, state) >> (6 - 2 * q)) & 3
        byte |= (state & 3) << (6 - 2 * q)
        state = (state >> 2) | (j << 4)
    assert torch.equal(maps & 63, state)
    assert torch.equal(torch.arange(64) | (maps & 0xc0), byte)


def test_maps_refuse_bad_arguments():
    decs = decisions("random", 7)
    with pytest.raises(ValueError, match="compose"):
        traceback_maps_ref(decs, compose=3)
    with pytest.raises(ValueError, match="n_out"):
        traceback_maps_ref(decs, n_out=8)
    with pytest.raises(ValueError, match="bits"):
        traceback_maps_ref(decs, n_out=57, bits=True)

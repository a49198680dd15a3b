"""Parity of the port's deinterleave (the plain twin of kernel K4) and CIF
slicing with tpudab: exact, since both only select."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpudab.constants.puncture import eep_profile
from tpudab.msc.interleave import (deinterleave_np, deinterleave_pallas,
                                   interleave_delays)
from tpudab.msc.subchannel import SubchannelConfig as JaxConfig, subch_cif_slices as jax_slices
from tpudab_torch.msc.interleave import deinterleave_batch
from tpudab_torch.msc.subchannel import SubchannelConfig, subch_cif_slices

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["no_E", "E3"])
def test_deinterleave_matches_pallas_and_numpy(lead, dtype):
    rng = np.random.default_rng(5)
    c, s = 8, 256
    buf = rng.standard_normal(lead + (c + 15, s)).astype(np.float32)
    xt = torch.from_numpy(buf).to(TORCH_DT[dtype])
    got = deinterleave_batch(xt, c)
    assert got.dtype == xt.dtype and got.shape == lead + (c, s)
    xj = jnp.asarray(buf).astype(jnp.dtype(dtype))
    want = np.asarray(deinterleave_pallas(xj, c, interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    # numpy oracle on the same (bf16-rounded) values, one ensemble at a time
    vals = xt.float().numpy().reshape((-1, c + 15, s))
    for e in range(vals.shape[0]):
        np.testing.assert_array_equal(got.float().numpy().reshape(-1, c, s)[e],
                                      deinterleave_np(vals[e])[:c])


@pytest.mark.parametrize("shape", [(20, 48), (40, 256), (7, 16)])
def test_deinterleave_np_equals_tpudab(shape):
    """The port's numpy oracle: equal to tpudab's on seeded soft and hard
    bits, and the inverse of interleave_np from row 15 on. Tolerance: none."""
    from tpudab_torch.msc.interleave import deinterleave_np as port_deinterleave_np
    from tpudab_torch.msc.interleave import interleave_np
    rng = np.random.default_rng(shape[0])
    soft = rng.standard_normal(shape).astype(np.float32)
    hard = rng.integers(0, 2, shape).astype(np.uint8)
    for x in (soft, hard):
        got = port_deinterleave_np(x)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, deinterleave_np(x))
    np.testing.assert_array_equal(port_deinterleave_np(interleave_np(hard))[: shape[0] - 15],
                                  hard[: shape[0] - 15])


def test_delay_table():
    from tpudab_torch.msc import interleave as port
    np.testing.assert_array_equal(port.interleave_delays(48), interleave_delays(48))
    bitrev = [int(f"{i:04b}"[::-1], 2) for i in range(16)]
    np.testing.assert_array_equal(interleave_delays(16), bitrev)


@pytest.mark.parametrize("start,size", [(0, 24), (100, 36), (800, 60)])
def test_cif_slices(start, size):
    rng = np.random.default_rng(start)
    fic, n_cifs = 9216, 4
    soft = rng.standard_normal((3, fic + n_cifs * 55296)).astype(np.float32)
    jc = JaxConfig(1, start, size, eep_profile(size, 3, 0))
    tc = SubchannelConfig(1, start, size, eep_profile(size, 3, 0))
    want = np.asarray(jax_slices(jnp.asarray(soft), jc, fic, n_cifs))
    got = subch_cif_slices(torch.from_numpy(soft), tc, fic, n_cifs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tc.slice_bits == jc.slice_bits and tc.data_bits == jc.data_bits


def test_kernel_wrappers_refuse_cpu_tensors():
    """Dispatch is by device alone: the CUDA wrappers never fall back to
    the plain twins, they raise on a CPU tensor."""
    from tpudab_torch.constants.dab_params import get_dab_params
    from tpudab_torch.fec.depuncture import depuncture_index
    from tpudab_torch.msc.interleave import (SoftRows, deinterleave_cuda,
                                             deinterleave_depuncture_t_cuda)
    from tpudab_torch.ops.carve import carve_rotate_cuda
    from tpudab_torch.ops.viterbi import radix_tables
    from tpudab_torch.ops.viterbi_cuda import viterbi_decode_bytes_t_cuda
    with pytest.raises(ValueError):
        deinterleave_cuda(torch.zeros((23, 16)), 8)
    dab = get_dab_params(1)
    index = torch.from_numpy(depuncture_index(eep_profile(24, 3, 0)))
    rows = SoftRows.cif_slices(dab.nb_fic_bits, dab.nb_cifs, 0, 24 * 64)
    n0 = deinterleave_depuncture_t_cuda.launches
    with pytest.raises(ValueError):
        deinterleave_depuncture_t_cuda(torch.zeros((1, dab.nb_frame_bits)), rows,
                                       torch.zeros((15, 24 * 64)), index, 24 * 64,
                                       torch.zeros((index.shape[0] // 8, 8, 4)))
    assert deinterleave_depuncture_t_cuda.launches == n0
    frames = torch.zeros((1, 1536, 128))
    with pytest.raises(ValueError):
        carve_rotate_cuda(frames, frames, 0.0)
    with pytest.raises(ValueError):
        carve_rotate_cuda(frames, frames, 0.0, with_sum=True)
    with pytest.raises(ValueError):
        viterbi_decode_bytes_t_cuda(torch.zeros((16, 8, 4)),
                                    torch.from_numpy(radix_tables()[0]), 8)

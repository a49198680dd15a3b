"""Parity of the port's jax-free FEC and bit helpers, and of its static
tables, with their tpudab counterparts: exact equality throughout."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpudab.constants.puncture import FIC_PROFILE, FIC_PROFILE_MODE3, eep_profile
from tpudab.constants.puncture import get_uep_profile
import tpudab.fec.conv as jconv
import tpudab.fec.crc as jcrc
import tpudab.fec.prbs as jprbs
from tpudab.fec.depuncture import _block_runs, depuncture_t as jax_depuncture_t
from tpudab.fec.depuncture import puncture as jax_puncture
from tpudab.ops.viterbi import _radix_tables
import tpudab.utils.bits as jbits
import tpudab_torch.fec.conv as tconv
import tpudab_torch.fec.crc as tcrc
import tpudab_torch.fec.prbs as tprbs
from tpudab_torch.fec.depuncture import depuncture_index, depuncture_t, puncture
from tpudab_torch.ops.viterbi import radix_tables
import tpudab_torch.utils.bits as tbits

PROFILES = [eep_profile(8, 2, 0), eep_profile(24, 3, 0), eep_profile(108, 3, 0),
            eep_profile(54, 1, 1), FIC_PROFILE, FIC_PROFILE_MODE3,
            get_uep_profile(128, 5).to_profile()]


def test_conv_tables_and_encoder():
    np.testing.assert_array_equal(tconv.OUTPUT_SIGNS, jconv.OUTPUT_SIGNS)
    np.testing.assert_array_equal(tconv.OUTPUT_BITS, jconv.OUTPUT_BITS)
    bits = np.random.default_rng(0).integers(0, 2, 300).astype(np.uint8)
    np.testing.assert_array_equal(tconv.conv_encode(bits), jconv.conv_encode(bits))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_radix_tables(k):
    for a, b in zip(radix_tables(k), _radix_tables(k)):
        np.testing.assert_array_equal(a, b)


def test_prbs_and_crc():
    for n in (768, 3456, 1000):
        np.testing.assert_array_equal(tprbs.prbs_bits(n), jprbs.prbs_bits(n))
        np.testing.assert_array_equal(tprbs.prbs_bytes(n // 8), jprbs.prbs_bytes(n // 8))
    rng = np.random.default_rng(1)
    fibs = np.stack([jcrc.crc16_append(rng.integers(0, 256, 30).astype(np.uint8))
                     for _ in range(12)])
    fibs[3, 5] ^= 0x10
    np.testing.assert_array_equal(tcrc.check_fib_crc(fibs), jcrc.check_fib_crc(fibs))
    assert tcrc.check_fib_crc(fibs).sum() == 11
    np.testing.assert_array_equal(tcrc.crc16_append(fibs[0, :30]), jcrc.crc16_append(fibs[0, :30]))
    bits = rng.integers(0, 2, (3, 64)).astype(np.uint8)
    np.testing.assert_array_equal(tprbs.descramble_bits(bits), jprbs.descramble_bits(bits))


def test_descramble_bytes():
    """descramble_bytes on seeded bytes, 1-D and batched: equal to tpudab's."""
    data = np.random.default_rng(3).integers(0, 256, (4, 432)).astype(np.uint8)
    for x in (data[0], data, data[:, :31]):
        got = tprbs.descramble_bytes(x)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jprbs.descramble_bytes(x))
    np.testing.assert_array_equal(tprbs.descramble_bytes(tprbs.descramble_bytes(data)), data)


def test_hard_decision_and_bits_to_soft():
    """numpy in and out, equal to tpudab's: signs (zero counts as bit 0)
    and ideal soft values at amplitudes 1 and 2.5."""
    rng = np.random.default_rng(4)
    soft = rng.standard_normal((3, 100)).astype(np.float32)
    soft[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    got = tbits.hard_decision(soft)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jbits.hard_decision(soft))
    bits = rng.integers(0, 2, (2, 64)).astype(np.uint8)
    for amp in (1.0, 2.5):
        got = tbits.bits_to_soft(bits, amp)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jbits.bits_to_soft(bits, amp))
    np.testing.assert_array_equal(tbits.hard_decision(tbits.bits_to_soft(bits)), bits)


def test_bit_packing():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (4, 96)).astype(np.uint8)
    np.testing.assert_array_equal(tbits.pack_bits(bits), jbits.pack_bits(bits))
    by = jbits.pack_bits(bits)
    np.testing.assert_array_equal(tbits.unpack_bits(by), jbits.unpack_bits(by))
    np.testing.assert_array_equal(
        tbits.torch_pack_bits(torch.from_numpy(bits)).numpy(),
        np.asarray(jbits.jnp_pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        tbits.torch_unpack_bits(torch.from_numpy(by)).numpy(),
        np.asarray(jbits.jnp_unpack_bits(jnp.asarray(by))))


@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: str(p.runs))
def test_depuncture_index_from_block_runs(profile):
    """The port's gather map equals the one-hot runs of tpudab's
    _block_runs, with erasures at punctured slots and the flush tail."""
    n_mother, runs = _block_runs(profile)
    idx = depuncture_index(profile)
    n_punct = int(profile.mask().sum())
    expect = []
    off = moff = 0
    for n_blocks, kpb, one_hot in runs:
        for blk in range(n_blocks):
            col = np.full(128, n_punct, np.int64)
            kept = np.nonzero(one_hot.T)[0]                 # mother slots kept
            col[kept] = off + blk * kpb + np.arange(kpb)
            pos = moff + blk * 128 + np.arange(128)
            col[pos >= n_mother] = n_punct + 1
            expect.append(col)
        off += n_blocks * kpb
        moff += n_blocks * 128
    np.testing.assert_array_equal(idx, np.concatenate(expect))
    x = np.arange(2 * 4 * (profile.data_bits + 6)).reshape(2, -1)
    np.testing.assert_array_equal(puncture(x, profile), jax_puncture(x, profile))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("profile", PROFILES[:2] + [FIC_PROFILE], ids=lambda p: str(p.runs))
def test_depuncture_t_exact(profile, dtype):
    """Exact against tpudab's depuncture_t, +1.0 flush tail included."""
    rng = np.random.default_rng(11)
    n_punct = int(profile.mask().sum())
    x = rng.standard_normal((5, n_punct)).astype(np.float32)
    want = jax_depuncture_t(jnp.asarray(x).astype(jnp.dtype(dtype)), profile)
    want = np.asarray(want.astype(jnp.float32))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = depuncture_t(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(depuncture_index(profile)))
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    n_mother = profile.mask().shape[0]
    flat = got.float().numpy().transpose(2, 0, 1).reshape(5, -1)
    assert (flat[:, n_mother:] == 1.0).all()

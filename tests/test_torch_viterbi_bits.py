"""Parity of the port's (B, T, 4) Viterbi entries (the plain twins of
kernels K1 + K3 and K1 + K2 on the host per-stage path) with tpudab's:
viterbi_decode_best against viterbi_decode_pallas in interpret mode and
the XLA scan decoder; viterbi_decode_bytes_best against
viterbi_decode_pallas_bytes in interpret mode and the packed scan.
Tolerance: none, bits and bytes equal. bf16 cases quantize the soft bits
to bf16 first and hand the same values to every decoder."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.puncture import FIC_PROFILE, get_uep_profile
from tpudab.fec.conv import conv_encode
from tpudab.fec.depuncture import depuncture_np, puncture
from tpudab.ops.viterbi import viterbi_decode
from tpudab.ops.viterbi_pallas import viterbi_decode_pallas, viterbi_decode_pallas_bytes
from tpudab.utils.bits import pack_bits
from tpudab_torch.ops.viterbi_cuda import viterbi_decode_best, viterbi_decode_bytes_best

UEP = get_uep_profile(128, 3)   # a padded UEP row ('s', calibrated online)



def random_soft(seed=7):
    """B=8 codewords of n=256 bits of unit Gaussian soft bits, as
    tests/test_viterbi.py:42-77."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((8, 256 + 6, 4)).astype(np.float32), 256


def coded_soft(profile, b, sigma, seed):
    """AWGN-coded codewords through puncture and depuncture:
    (b, data_bits + 6, 4) mother soft bits with 0.0 erasures."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (b, profile.data_bits)).astype(np.uint8)
    tx = 1.0 - 2.0 * puncture(np.stack([conv_encode(r) for r in bits]), profile)
    rx = (tx + sigma * rng.standard_normal(tx.shape)).astype(np.float32)
    return depuncture_np(rx, profile).reshape(b, -1, 4), profile.data_bits


CASES = {
    "random": random_soft,
    "fic_awgn": lambda: coded_soft(FIC_PROFILE, 12, 0.9, 3),
    "uep_padded": lambda: coded_soft(UEP.to_profile(), 3, 0.8, 4),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_bits_and_bytes_match_tpudab(case, dtype):
    mother, n = CASES[case]()
    xj = jnp.asarray(mother).astype(jnp.dtype(dtype))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])

    got_bits = viterbi_decode_best(x, n)
    assert got_bits.dtype == torch.uint8 and got_bits.shape == (mother.shape[0], n)
    got_bits = got_bits.numpy()
    ref_scan = np.asarray(viterbi_decode(xj.astype(jnp.float32), n))
    ref_pallas = np.asarray(viterbi_decode_pallas(xj, n, interpret=True))
    np.testing.assert_array_equal(got_bits, ref_scan, err_msg="bits vs XLA scan")
    np.testing.assert_array_equal(got_bits, ref_pallas, err_msg="bits vs Pallas interpret")

    got_bytes = viterbi_decode_bytes_best(x, n).numpy()
    ref_bytes = np.asarray(viterbi_decode_pallas_bytes(xj, n, interpret=True))
    np.testing.assert_array_equal(got_bytes, ref_bytes, err_msg="bytes vs Pallas interpret")
    np.testing.assert_array_equal(got_bytes, pack_bits(ref_scan), err_msg="bytes vs scan")


def test_numpy_input_and_odd_lengths():
    """A numpy input decodes on the CPU; n that is not a multiple of 8 and
    an odd T (n + 6 with n odd) come out as tpudab's bits."""
    rng = np.random.default_rng(11)
    n = 101
    mother = rng.standard_normal((1, n + 6, 4)).astype(np.float32)
    got = viterbi_decode_best(mother, n)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(viterbi_decode(jnp.asarray(mother), n)))


@pytest.mark.parametrize("frac", [0.85, 0.97])
def test_erased_codewords_follow_pallas(frac):
    """Codewords with most mother steps erased, like the time
    deinterleaver's warm-up rows: many compare-selects tie, and tpudab's
    XLA scan (radix-4 argmax) breaks some of those ties otherwise than its
    Pallas kernel (radix-2 pairwise selects), so the two tpudab decoders
    disagree there. The port follows the Pallas kernel, bit for bit."""
    from tpudab.constants.puncture import eep_profile
    mother, n = coded_soft(eep_profile(72, 3, 0), 8, 0.5, 21)
    keep = np.random.default_rng(22).random(mother.shape[:2])[..., None] >= frac
    mother = (mother * keep).astype(np.float32)
    got = viterbi_decode_best(torch.from_numpy(mother), n).numpy()
    want = np.asarray(viterbi_decode_pallas(jnp.asarray(mother), n, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(viterbi_decode_bytes_best(torch.from_numpy(mother), n).numpy(),
                                  np.asarray(viterbi_decode_pallas_bytes(jnp.asarray(mother), n,
                                                                         interpret=True)))

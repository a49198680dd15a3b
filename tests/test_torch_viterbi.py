"""Parity of the port's plain torch Viterbi decoder (the twin of kernels
K1+K2) with tpudab's decoders: byte-exact against the XLA scan decoder,
the Pallas transposed-input decoder in interpret mode, and the numpy
oracle, on coded noisy data and on an all-erasure input where every
compare-select ties."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpudab.constants.puncture import FIC_PROFILE, eep_profile
from tpudab.fec.conv import conv_encode
from tpudab.fec.depuncture import depuncture, depuncture_t as jax_depuncture_t, puncture
from tpudab.ops.viterbi import pad_mother_soft as jax_pad_mother_soft
from tpudab.ops.viterbi import viterbi_decode, viterbi_decode_np
from tpudab.ops.viterbi_pallas import viterbi_decode_pallas_bytes_t
from tpudab.utils.bits import bits_to_soft, jnp_pack_bits, pack_bits
from tpudab_torch.fec.depuncture import depuncture_index, depuncture_t
from tpudab_torch.ops.viterbi import pad_mother_soft, radix_tables
from tpudab_torch.ops.viterbi_cuda import viterbi_decode_bytes_t

PROFILES = {"eep_8_2A": eep_profile(8, 2, 0), "fic": FIC_PROFILE}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def coded_soft(profile, b, case, seed=3):
    """Punctured soft bits (b, n_punct) f32: random payloads, conv encode,
    puncture, AWGN of std 1.2; or all zeros (erasures) for case 'erasure'."""
    rng = np.random.default_rng(seed)
    n_punct = int(profile.mask().sum())
    if case == "erasure":
        return np.zeros((b, n_punct), np.float32)
    bits = rng.integers(0, 2, (b, profile.data_bits)).astype(np.uint8)
    enc = np.stack([conv_encode(r) for r in bits])
    soft = bits_to_soft(puncture(enc, profile)).astype(np.float32)
    return soft + 1.2 * rng.standard_normal(soft.shape).astype(np.float32)


def port_decode(soft_np, profile, dtype):
    x = torch.from_numpy(soft_np).to(TORCH_DT[dtype])
    soft_t = depuncture_t(x, torch.from_numpy(depuncture_index(profile)))
    return viterbi_decode_bytes_t(soft_t, torch.from_numpy(radix_tables()[0]),
                                  profile.data_bits).numpy()


@pytest.mark.parametrize("case", ["noise", "erasure"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pname", list(PROFILES))
def test_plain_decoder_matches_tpudab(pname, dtype, case):
    """Tolerance: none, bytes equal. bf16 inputs are the same bf16 values
    on both sides; all decoders sum the branch metric in f32."""
    profile = PROFILES[pname]
    n = profile.data_bits
    soft = coded_soft(profile, 8, case)
    got = port_decode(soft, profile, dtype)

    xj = jnp.asarray(soft).astype(jnp.dtype(dtype))
    mother = depuncture(xj, profile).reshape(-1, n + 6, 4).astype(jnp.float32)
    ref_scan = np.asarray(jnp_pack_bits(viterbi_decode(mother, n)))
    ref_pallas = np.asarray(viterbi_decode_pallas_bytes_t(
        jax_depuncture_t(xj, profile), n, interpret=True))
    ref_np = pack_bits(viterbi_decode_np(np.asarray(mother), n))
    np.testing.assert_array_equal(got, ref_scan, err_msg="vs XLA scan decoder")
    np.testing.assert_array_equal(got, ref_pallas, err_msg="vs Pallas interpret")
    np.testing.assert_array_equal(got, ref_np, err_msg="vs numpy oracle")
    if case == "erasure":
        # every ACS ties: the lowest predecessor wins, i.e. all-zero bits
        assert not got.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flush_padded_mother_layout_decodes_same(dtype):
    """(B, T, 4) mother soft bits, flush-padded by the port's pad_mother_soft
    (equal to tpudab's) and transposed here, decode to the same bytes as the
    depuncture_t path (the +1.0 tail)."""
    profile = PROFILES["eep_8_2A"]
    n = profile.data_bits
    soft = coded_soft(profile, 4, "noise", seed=9)
    xj = jnp.asarray(soft).astype(jnp.dtype(dtype))
    mother = np.array(depuncture(xj, profile).astype(jnp.float32)).reshape(-1, n + 6, 4)
    t_pad = -(-(n + 6) // 32) * 32     # 16 super-steps of 2 trellis steps each
    padded = pad_mother_soft(torch.from_numpy(mother), t_pad)
    np.testing.assert_array_equal(padded.numpy(), jax_pad_mother_soft(mother, t_pad))
    soft_t = padded.to(TORCH_DT[dtype]).reshape(len(mother), -1, 8).permute(1, 2, 0).contiguous()
    got = viterbi_decode_bytes_t(soft_t, torch.from_numpy(radix_tables()[0]), n)
    np.testing.assert_array_equal(got.numpy(), port_decode(soft, profile, dtype))

"""Parity of the port's demod and DFT tables with tpudab's."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpudab.ofdm.demod import (_dense_demod_matrix, active_bin_indices as jax_bins,
                               demod_frames_split as jax_demod)
from tpudab.synth import EnsembleSpec, EnsembleSynthesizer, ServiceSpec, SubchannelSpec
from tpudab.synth.modulator import Impairments, apply_impairments, modulate_frame_bits
from tpudab_torch.ofdm.demod import (active_bin_indices, demod_frames_split,
                                     dense_demod_matrix, dft_operands)


@pytest.mark.parametrize("mode", [1, 3])
def test_dft_tables(mode):
    np.testing.assert_array_equal(active_bin_indices(mode), jax_bins(mode))
    for a, b in zip(dense_demod_matrix(mode), _dense_demod_matrix(mode)):
        np.testing.assert_array_equal(a, b)
    wre, wim = _dense_demod_matrix(mode)
    got = [o.float().numpy() for o in dft_operands(mode, "bfloat16")]
    for g, w in zip(got, (wre, wre + wim, wim - wre)):
        np.testing.assert_array_equal(g, np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)))


def _frame_and_bits(seed):
    spec = EnsembleSpec(ensemble_id=0x1000 + seed, label="Demod",
                        services=[ServiceSpec(0xC000, "S", [(0, 63, 1)])],
                        subchannels=[SubchannelSpec(1, 0, 24, ("eep", 3, 0))])
    bits = EnsembleSynthesizer(spec, seed=seed).frame_bits(0)
    return modulate_frame_bits(bits), bits


def _impaired(seed=23):
    frame, bits = _frame_and_bits(seed)
    iq = apply_impairments(frame, Impairments(freq_offset_hz=500.0, snr_db=18, seed=11))
    iq = iq[None, :196608]
    return iq.real.astype(np.float32), iq.imag.astype(np.float32), bits


def test_demod_f32_path_matches():
    """f32 DFT path against tpudab's f32 path: atol 1e-4 on unit-mean soft
    bits (f32 matmuls summed in another order)."""
    re, im, _ = _impaired()
    want, wstats = jax_demod(re, im, 500.0, dft_dtype="float32")
    got, stats = demod_frames_split(torch.from_numpy(re), torch.from_numpy(im), 500.0,
                                    dft_operands(1, "float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for k in ("mean_power", "const_re", "const_im"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(wstats[k]), atol=1e-4)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_demod_bf16_path_matches(out_dtype):
    """bf16 Karatsuba path against tpudab's: relative RMS error a small
    margin above the measured gap (f32 out: 1.77e-3, bound 2e-3; bf16 out:
    2.94e-3, bound 3.2e-3; the two round bf16 intermediates at different
    places), equal hard decisions, and no bit errors against the
    transmitted bits."""
    re, im, bits = _impaired()
    want, _ = jax_demod(re, im, 500.0, out_dtype=out_dtype)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[out_dtype]
    got, _ = demod_frames_split(torch.from_numpy(re), torch.from_numpy(im), 500.0,
                                dft_operands(1, "bfloat16"), out_dtype=tdt)
    assert got.dtype == tdt
    got = got.float().numpy()
    rel_rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
    assert rel_rms < {"float32": 2e-3, "bfloat16": 3.2e-3}[out_dtype], rel_rms
    np.testing.assert_array_equal(got < 0, want < 0)
    assert ((got[0] < 0).astype(np.uint8) != bits).sum() == 0


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_demod_frames_oracle_matches(mode):
    """The complex f32 oracle (demod_frames, complex torch.fft) against
    tpudab's demod_frames on two frames with a CFO and noise, a per-frame
    frequency: atol 1e-4 on unit-mean soft bits (FFTs summed in another
    order), the hard decisions equal, and no bit errors against the
    transmitted bits of frame 0."""
    from tpudab.constants.ofdm_params import get_ofdm_params
    from tpudab.ofdm.demod import demod_frames as jax_frames
    from tpudab_torch.ofdm.demod import demod_frames

    spec = EnsembleSpec(ensemble_id=0x1100 + mode, label="Oracle",
                        services=[ServiceSpec(0xC000, "S", [(0, 63, 1)])],
                        subchannels=[SubchannelSpec(1, 0, 24, ("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, mode=mode, seed=mode)
    bits = [synth.frame_bits(i) for i in range(2)]
    n = get_ofdm_params(mode).nb_frame_length
    iq = apply_impairments(np.concatenate([modulate_frame_bits(b, mode) for b in bits]),
                           Impairments(freq_offset_hz=700.0, snr_db=20, seed=mode))
    frames = iq[: 2 * n].reshape(2, n).astype(np.complex64)
    freq = np.array([700.0, 700.0], np.float32)
    want, wstats = jax_frames(frames, freq, mode)
    got, stats = demod_frames(torch.from_numpy(frames), torch.from_numpy(freq), mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got.numpy() < 0, np.asarray(want) < 0)
    np.testing.assert_allclose(stats["mean_power"].numpy(), np.asarray(wstats["mean_power"]),
                               rtol=1e-5)
    assert ((got[0].numpy() < 0).astype(np.uint8) != bits[0]).sum() == 0

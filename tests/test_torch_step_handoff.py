"""Carry handoff between tpudab's ReceiveStep and the port's, the carry
converters, and the mode III FIC profile. Tolerance: decoded bytes equal."""

import numpy as np
import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.puncture import eep_profile
from tpudab.models.step import ReceiveStep as JaxStep
from tpudab.msc.subchannel import SubchannelConfig as JaxConfig
from tpudab.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                          ServiceSpec, SubchannelSpec)
from tpudab.synth.modulator import modulate_frame_bits
from tpudab_torch.fec.crc import check_fib_crc
from tpudab_torch.models.convert import carry_from_jax, carry_to_numpy
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.msc.subchannel import SubchannelConfig


def capture(mode, n_frames, size_cu, seed):
    """One EEP 3-A subchannel with a known payload (tests/test_modes.py)."""
    spec = EnsembleSpec(
        ensemble_id=0x5000 + mode, label=f"Mode {mode} Mux",
        services=[ServiceSpec(0xC300, "SvcM", [(0, ASCTY_DAB_PLUS, 1)])],
        subchannels=[SubchannelSpec(1, start_cu=0, size_cu=size_cu, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, mode=mode, seed=seed)
    n_bytes = size_cu // 6 * 8 * 3
    nb_cifs = synth.dab.nb_cifs
    data = np.random.default_rng(1000 + seed).integers(
        0, 256, (n_frames * nb_cifs, n_bytes)).astype(np.uint8)
    synth.payload_fn[1] = lambda m: data[m].tobytes()
    frames = np.stack([modulate_frame_bits(synth.frame_bits(i), mode) for i in range(n_frames)])
    tiled = frames.reshape(n_frames, -1, 128)
    return (np.ascontiguousarray(tiled.real, np.float32),
            np.ascontiguousarray(tiled.imag, np.float32), data)


def steps(mode, size_cu, soft_dtype="bfloat16"):
    prof = eep_profile(size_cu, 3, 0)
    return (JaxStep(mode=mode, subchannels=(JaxConfig(1, 0, size_cu, prof),), soft_dtype=soft_dtype),
            ReceiveStep(mode, (SubchannelConfig(1, 0, size_cu, prof),), soft_dtype=soft_dtype))


@pytest.mark.parametrize("soft_dtype", ["bfloat16", "float32"])
def test_carry_handoff_jax_to_port(soft_dtype):
    """Step 1 in tpudab, carry_from_jax, step 2 in the port: step 2's
    output equals tpudab's step 2."""
    re, im, data = capture(1, 8, 24, seed=5)
    jstep, tstep = steps(1, 24, soft_dtype)
    jcarry, _ = jstep(jstep.init_carry(), re[:4], im[:4], np.float32(0.0))
    jcarry2, jout2 = jstep(jcarry, re[4:], im[4:], np.float32(0.0))
    carry = carry_from_jax({k: np.asarray(v) for k, v in jcarry.items()}, "cpu")
    assert carry["deint_1"].dtype == tstep.soft_dtype
    _, tout2 = tstep(carry, torch.from_numpy(re[4:]), torch.from_numpy(im[4:]), 0.0)
    np.testing.assert_array_equal(tout2["subch"][1].numpy(), np.asarray(jout2["subch"][1]))
    np.testing.assert_array_equal(tout2["fic_bytes"].numpy(), np.asarray(jout2["fic_bytes"]))
    # logical frames 1..16 complete in step 2 and carry the known payload
    np.testing.assert_array_equal(tout2["subch"][1].numpy(), data[1:17])
    # the converters are exact inverses
    back = carry_to_numpy(carry)
    want = np.asarray(jcarry["deint_1"])
    np.testing.assert_array_equal(
        back["deint_1"], want.view(np.uint16) if soft_dtype == "bfloat16" else want)


def test_mode3_fic_profile():
    """Mode III: 4-FIB groups through FIC_PROFILE_MODE3, 1 CIF per frame."""
    re, im, data = capture(3, 20, 36, seed=43)
    jstep, tstep = steps(3, 36)
    _, jout = jstep(jstep.init_carry(), re, im, np.float32(0.0))
    _, tout = tstep(tstep.init_carry("cpu"), torch.from_numpy(re), torch.from_numpy(im), 0.0)
    fic = tout["fic_bytes"].numpy()
    assert fic.shape == (20, 128)
    np.testing.assert_array_equal(fic, np.asarray(jout["fic_bytes"]))
    assert check_fib_crc(fic.reshape(-1, 4, 32)).all()
    got = tout["subch"][1].numpy()
    np.testing.assert_array_equal(got, np.asarray(jout["subch"][1]))
    np.testing.assert_array_equal(got[15:], data[: got.shape[0] - 15])

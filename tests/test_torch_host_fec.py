"""Parity of the port's host-path FEC with tpudab's, on the CPU:
depuncture / depuncture_np (EEP, UEP and FIC profiles), the FIC decode
(modes 1 and 3, noisy synthesised FIC bits) and the online UEP table
calibration (tests/test_uep_calibration.py's _logical_soft fixtures).
Tolerance: none, values, bytes, winners and scores equal."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.puncture import (FIC_PROFILE, FIC_PROFILE_MODE3, eep_profile,
                                       get_uep_profile)

PROFILES = {
    "eep_3A_108": eep_profile(108, 3, 0),
    "eep_2B_21": eep_profile(21, 2, 1),
    "uep_128_3": get_uep_profile(128, 3).to_profile(),
    "uep_320_5": get_uep_profile(320, 5).to_profile(),
    "fic": FIC_PROFILE,
    "fic_mode3": FIC_PROFILE_MODE3,
}



@pytest.mark.parametrize("pname", list(PROFILES))
def test_depuncture_matches(pname):
    from tpudab.fec.depuncture import depuncture as jax_dep, depuncture_np as jax_dep_np
    from tpudab_torch.fec.depuncture import depuncture, depuncture_np

    profile = PROFILES[pname]
    n_punct = int(profile.mask().sum())
    soft = np.random.default_rng(5).standard_normal((3, 2, n_punct)).astype(np.float32)
    want = np.asarray(jax_dep(jnp.asarray(soft), profile))
    got = depuncture(torch.from_numpy(soft), profile)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(depuncture_np(soft, profile), jax_dep_np(soft, profile))
    # bf16 in, bf16 out, the same values
    xb = jnp.asarray(soft).astype(jnp.bfloat16)
    got_b = depuncture(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16), profile)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_b.float().numpy(),
                                  np.asarray(jax_dep(xb, profile).astype(jnp.float32)))


@pytest.mark.parametrize("mode", [1, 3])
def test_decode_fic_frame_matches(mode):
    from tpudab.fic.fib import decode_fic_frame as jax_decode
    from tpudab.synth import ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer, \
        ServiceSpec, SubchannelSpec
    from tpudab_torch.fic.fib import decode_fic_frame

    spec = EnsembleSpec(0xF1C0 + mode, f"FIC mode {mode}",
                        [ServiceSpec(0xC300, "Svc", [(0, ASCTY_DAB_PLUS, 1)])],
                        [SubchannelSpec(1, 0, 36, ("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, mode=mode, seed=3)
    bits = np.stack([synth.build_fic_bits(i) for i in range(3)])
    rng = np.random.default_rng(mode)
    soft = (1.0 - 2.0 * bits + 0.5 * rng.standard_normal(bits.shape)).astype(np.float32)
    fibs, ok = decode_fic_frame(soft, mode, device="cpu")
    want_fibs, want_ok = jax_decode(soft, mode)
    np.testing.assert_array_equal(fibs, want_fibs)
    np.testing.assert_array_equal(ok, want_ok)
    assert ok.all()
    # a tensor input decodes the same, one frame as a 1-D row too
    f1, _ = decode_fic_frame(torch.from_numpy(soft[0]), mode)
    np.testing.assert_array_equal(f1, want_fibs[: f1.shape[0]])
    f2, _ = decode_fic_frame(soft[1:], mode, device="cpu")
    np.testing.assert_array_equal(f2, want_fibs[f1.shape[0]:])



def test_entry_points_default_to_the_card(monkeypatch):
    """Receiver, MSCDecoder, SubchannelDecoder and the FIC decode of a numpy
    input run on cuda unless told "cpu": with no card each refuses to run,
    and "cpu" (or a CPU tensor) still decodes."""
    from tpudab_torch.constants.dab_params import CIF_BITS, get_dab_params
    from tpudab_torch.constants.puncture import eep_profile
    from tpudab_torch.fic.fib import decode_fic_frame
    from tpudab_torch.models.receiver import Receiver
    from tpudab_torch.msc.subchannel import MSCDecoder, SubchannelConfig, SubchannelDecoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SubchannelConfig(1, 0, 24, eep_profile(24, 3, 0))
    soft = np.ones((1, get_dab_params(1).nb_fic_bits), np.float32)
    for make in (lambda: Receiver(1), lambda: SubchannelDecoder(cfg),
                 lambda: MSCDecoder([cfg], 4, CIF_BITS), lambda: decode_fic_frame(soft)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert Receiver(1, "cpu").device.type == "cpu"
    assert SubchannelDecoder(cfg, "cpu").device.type == "cpu"
    assert MSCDecoder([cfg], 4, CIF_BITS, "cpu").decoders[1].device.type == "cpu"
    assert decode_fic_frame(torch.from_numpy(soft))[0].shape == (12, 32)


KEY = (128, 2)


def _logical_soft(prof, n_frames, seed, snr_amp):
    """tests/test_uep_calibration.py::_logical_soft."""
    from tpudab.fec.conv import conv_encode
    from tpudab.fec.depuncture import puncture
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_frames):
        bits = rng.integers(0, 2, prof.data_bits).astype(np.uint8)
        p = puncture(conv_encode(bits), prof.to_profile())
        soft = (1.0 - 2.0 * p).astype(np.float32)
        if prof.padding_bits:
            soft = np.concatenate([soft, np.zeros(prof.padding_bits, np.float32)])
        rows.append(soft + snr_amp * rng.standard_normal(soft.shape[0]))
    return np.stack(rows)


def _fields(res):
    """The result's fields; the chosen profile as a tuple, since the port's
    UEPProfile is its own class (tpudab_torch.constants.puncture)."""
    return (res.bitrate_kbps, res.protection_level, dataclasses.astuple(res.chosen),
            res.swapped, res.locked, res.best_score, res.runner_up_score, res.n_candidates)


@pytest.mark.parametrize("case", ["shipped", "alt1", "alt5", "deep"])
def test_calibrate_matches(case):
    from tpudab.fec import uep_calibrate as juc
    from tpudab_torch.fec import uep_calibrate as puc

    cands = juc.candidate_profiles(*KEY)
    assert [dataclasses.astuple(c) for c in puc.candidate_profiles(*KEY)] == \
        [dataclasses.astuple(c) for c in cands]
    if case == "shipped":
        soft = _logical_soft(get_uep_profile(*KEY), 4, 0, 0.15)
    elif case == "deep":
        soft = _logical_soft(cands[len(cands) * 3 // 4], 4, 7, 0.45)
    else:
        k = int(case[3:])
        soft = _logical_soft(cands[k], 4, k, 0.15)
    want = juc.calibrate(soft, *KEY)
    got = puc.calibrate(soft, *KEY)
    assert _fields(got) == _fields(want)
    assert got.locked
    # the exact scores of the first candidates, one batched decode each
    sub = list(cands[:6])
    assert puc._score_all(soft, sub) == juc._score_all(soft, sub)
    assert puc._score_all(torch.from_numpy(soft.astype(np.float32)), sub) == \
        juc._score_all(soft, sub)

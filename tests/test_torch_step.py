"""The whole slice: the port's ReceiveStep against tpudab's ReceiveStep on
synthesised mode I captures. Two 24-CU EEP 3-A subchannels (one profile
group) and one 16-CU EEP 2-A subchannel (another), with a known payload
on subchannel 1. Modes II and IV on tests/test_modes.py's captures (mode
III: tests/test_torch_step_handoff.py).

Tolerances: decoded bytes (FIC and every subchannel) must be equal. The
carry after a full step holds demodulated soft bits, which the two
frameworks round differently in the bf16 DFT; it is held to equal signs
and a relative RMS bound per soft_dtype, a small margin above the
measured gap (bf16 carry: 2.67e-3 to 2.75e-3, bound 3e-3; f32 carry:
1.28e-3 to 1.29e-3, bound 1.5e-3). Fed tpudab's own soft bits, the port's
FEC half (decode_soft) must give tpudab's carry bit for bit.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.puncture import eep_profile
from tpudab.models.step import ReceiveStep as JaxStep
from tpudab.msc.subchannel import SubchannelConfig as JaxConfig
from tpudab.ofdm.demod import demod_frames_split as jax_demod
from tpudab.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                          ServiceSpec, SubchannelSpec)
from tpudab.synth.modulator import modulate_frame_bits
from tpudab_torch.fec.crc import check_fib_crc
from tpudab_torch.models.convert import carry_to_numpy
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.msc.subchannel import SubchannelConfig

LAYOUT = [(1, 0, 24, 3), (2, 24, 24, 3), (3, 48, 16, 2)]  # id, start, CU, EEP level (A)
N_FRAMES = 5
CARRY_REL_RMS = {"bfloat16": 3e-3, "float32": 1.5e-3}


def capture(n_frames, seed):
    """(n_frames, frame_len) complex64 frames and subchannel 1's payload."""
    spec = EnsembleSpec(
        ensemble_id=0x4100 + seed, label=f"Port {seed}",
        services=[ServiceSpec(0xC400 + sid, f"Svc {sid}", [(0, ASCTY_DAB_PLUS, sid)])
                  for sid, *_ in LAYOUT],
        subchannels=[SubchannelSpec(sid, start, size, ("eep", lvl, 0))
                     for sid, start, size, lvl in LAYOUT])
    synth = EnsembleSynthesizer(spec, seed=seed)
    data = np.random.default_rng(100 + seed).integers(
        0, 256, (n_frames * 4, 96)).astype(np.uint8)
    synth.payload_fn[1] = lambda m: data[m].tobytes()
    return np.stack([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)]), data


def configs():
    jc = tuple(JaxConfig(sid, s, z, eep_profile(z, lvl, 0)) for sid, s, z, lvl in LAYOUT)
    tc = tuple(SubchannelConfig(sid, s, z, eep_profile(z, lvl, 0)) for sid, s, z, lvl in LAYOUT)
    return jc, tc


def split_iq(frames):
    tiled = frames.reshape(frames.shape[:-1] + (-1, 128))
    return (np.ascontiguousarray(tiled.real, np.float32),
            np.ascontiguousarray(tiled.imag, np.float32))


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_same_outputs(jout, tout):
    np.testing.assert_array_equal(tout["fic_bytes"].numpy(), np.asarray(jout["fic_bytes"]))
    assert set(tout["subch"]) == set(jout["subch"])
    for sid, v in jout["subch"].items():
        np.testing.assert_array_equal(tout["subch"][sid].numpy(), np.asarray(v),
                                      err_msg=f"subchannel {sid}")
    for k in ("mean_power", "const_re", "const_im"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-3)


def assert_carry_close(tcarry, jcarry, soft_dtype):
    assert set(tcarry) == set(jcarry)
    for k, v in jcarry.items():
        want, got = as_f32(v), tcarry[k].float().numpy()
        assert got.shape == want.shape
        rel_rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
        assert rel_rms < CARRY_REL_RMS[soft_dtype], (k, rel_rms)
        np.testing.assert_array_equal(got < 0, want < 0, err_msg=k)


@pytest.mark.parametrize("n_ens", [1, 2])
@pytest.mark.parametrize("soft_dtype", ["bfloat16", "float32"])
def test_step_matches_tpudab(soft_dtype, n_ens):
    caps = [capture(N_FRAMES, 7 + e) for e in range(n_ens)]
    frames = np.stack([c[0] for c in caps]) if n_ens > 1 else caps[0][0]
    re, im = split_iq(frames)
    jc, tc = configs()
    jstep = JaxStep(mode=1, subchannels=jc, n_ensembles=n_ens, soft_dtype=soft_dtype)
    tstep = ReceiveStep(1, tc, n_ensembles=n_ens, soft_dtype=soft_dtype)
    jcarry, jout = jstep(jstep.init_carry(), re, im, np.float32(0.0))
    tcarry, tout = tstep(tstep.init_carry("cpu"), torch.from_numpy(re),
                         torch.from_numpy(im), 0.0)
    assert_same_outputs(jout, tout)
    assert_carry_close(tcarry, jcarry, soft_dtype)

    fic = tout["fic_bytes"].numpy()
    assert check_fib_crc(fic.reshape(-1, 3, 32)).all()
    got = tout["subch"][1].numpy().reshape(n_ens, -1, 96)
    for e in range(n_ens):
        np.testing.assert_array_equal(got[e, 15:], caps[e][1][: got.shape[1] - 15])

    # the FEC half, fed tpudab's own soft bits, gives tpudab's carry exactly
    flat_re = re.reshape((-1,) + re.shape[-2:])
    flat_im = im.reshape((-1,) + im.shape[-2:])
    soft, _ = jax_demod(flat_re, flat_im, np.float32(0.0), 1, 12, out_dtype=soft_dtype)
    soft = np.asarray(soft)
    st = torch.from_numpy(soft.view(np.int16).copy()).view(torch.bfloat16) \
        if soft_dtype == "bfloat16" else torch.from_numpy(soft.copy())
    carry2, fic2, subch2 = tstep.decode_soft(tstep.init_carry("cpu"), st)
    for k, v in carry_to_numpy(carry2).items():
        want = np.asarray(jcarry[k])
        np.testing.assert_array_equal(v, want.view(np.uint16) if soft_dtype == "bfloat16" else want)
    np.testing.assert_array_equal(fic2.numpy(), np.asarray(jout["fic_bytes"]))
    for sid, v in jout["subch"].items():
        np.testing.assert_array_equal(subch2[sid].numpy(), np.asarray(v))


@pytest.mark.parametrize("mode", [2, 4])
def test_step_other_modes_match_tpudab(mode):
    """Modes II (1 CIF a frame) and IV (2 CIFs): tests/test_modes.py:88-107's
    captures and subchannel (one 36-CU EEP 3-A), at least 20 logical frames.
    The FIC CRC-clean and equal to tpudab's bytes, the MSC bytes equal to
    tpudab's and to the payload; the carry as in test_step_matches_tpudab."""
    from test_modes import _payload_capture, _subch_cfg
    from tpudab.constants.dab_params import get_dab_params

    dab = get_dab_params(mode)
    n_frames = -(-20 // dab.nb_cifs)
    frames, payload = _payload_capture(mode, n_frames, seed=30 + mode)
    re, im = split_iq(frames)
    jstep = JaxStep(mode=mode, subchannels=(_subch_cfg(),))
    tstep = ReceiveStep(mode, (SubchannelConfig(1, 0, 36, eep_profile(36, 3, 0)),))
    jcarry, jout = jstep(jstep.init_carry(), re, im, np.float32(0.0))
    tcarry, tout = tstep(tstep.init_carry("cpu"), torch.from_numpy(re),
                         torch.from_numpy(im), 0.0)
    assert_same_outputs(jout, tout)
    assert_carry_close(tcarry, jcarry, "bfloat16")
    fibs = tout["fic_bytes"].numpy().reshape(-1, 32)
    assert fibs.shape[0] == n_frames * dab.nb_fibs and check_fib_crc(fibs).all()
    got = tout["subch"][1].numpy()
    assert got.shape[0] == n_frames * dab.nb_cifs
    np.testing.assert_array_equal(got[15:], payload[: got.shape[0] - 15])


@pytest.mark.parametrize("n_ens", [1, 2])
def test_example_args_equal_tpudab(n_ens):
    """example_args draws tpudab's arrays (same seed, order and shapes) and
    returns them on the device asked for, with the step's zero carry."""
    jc, tc = configs()
    jstep = JaxStep(mode=1, subchannels=jc, n_ensembles=n_ens)
    tstep = ReceiveStep(1, tc, n_ensembles=n_ens)
    want = jstep.example_args(n_frames=2, seed=3)
    got = tstep.example_args(n_frames=2, seed=3, device="cpu")
    assert all(t.device.type == "cpu" for t in got[1:])
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].item() == float(np.asarray(want[3])) == 0.0
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        np.testing.assert_array_equal(got[0][k].float().numpy(), as_f32(v))


def test_call_complex_matches_forward_and_tpudab():
    """call_complex on complex64 host frames: the same outputs as forward
    on the split f32 frames, tpudab's call_complex's decoded bytes, and its
    carry within test_step_matches_tpudab's bounds."""
    frames, data = capture(N_FRAMES, 7)
    jc, tc = configs()
    jstep = JaxStep(mode=1, subchannels=jc)
    tstep = ReceiveStep(1, tc)
    carry, out = tstep.call_complex(tstep.init_carry("cpu"), frames, 0.0)
    re, im = split_iq(frames)
    carry2, out2 = tstep(tstep.init_carry("cpu"), torch.from_numpy(re), torch.from_numpy(im),
                         0.0)
    np.testing.assert_array_equal(out["fic_bytes"].numpy(), out2["fic_bytes"].numpy())
    for sid, v in out2["subch"].items():
        np.testing.assert_array_equal(out["subch"][sid].numpy(), v.numpy())
    for k, v in carry2.items():
        assert torch.equal(carry[k], v), k
    jcarry, jout = jstep.call_complex(jstep.init_carry(), frames, np.float32(0.0))
    assert_same_outputs(jout, out)
    assert_carry_close(carry, jcarry, "bfloat16")
    np.testing.assert_array_equal(out["subch"][1].numpy()[15:], data[: 4 * N_FRAMES - 15])

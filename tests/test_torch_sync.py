"""The port's acquisition (tpudab_torch.ofdm.sync_device) and channel
impairments against tpudab's, on the captures tpudab's own tests use
(tests/test_sync_device.py, tests/test_multipath.py, tests/test_modes.py),
modes I-IV.

Tolerances. Impairments: bit for bit. Acquisition against tpudab's
acquire_host: frame_start and coarse_bins equal; fine_hz, coarse_hz and
net_freq_hz within 1 Hz; null, coarse and time quality within a relative
1e-3 (the two sum and transform in other orders: torch.cumsum and
torch.fft against jnp.cumsum and tpudab's matmul FFT; measured gaps are
below 1e-3 Hz and 1e-5 relative). null_start and approx_prs are not
outputs: they only choose a window. Against the pure-numpy oracle
acquire_np (no first-path gating): frame_start and coarse_bins equal,
net_freq_hz within 5 Hz, as tests/test_sync_device.py holds tpudab.
"""

import numpy as np
import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.ofdm_params import get_ofdm_params
from tpudab.ofdm.sync import SyncConfig as JaxSyncConfig
from tpudab.ofdm.sync import carrier_spacing_hz as jax_spacing
from tpudab.ofdm.sync_device import acquire_device as jax_acquire_device
from tpudab.ofdm.sync_device import acquire_host as jax_acquire_host
from tpudab.ofdm.sync_device import coarse_freq_device as jax_coarse
from tpudab.ofdm.sync_device import fine_freq_device as jax_fine_freq
from tpudab.ofdm.sync_device import fine_time_sync_device as jax_fine_time
from tpudab.ofdm.sync_np import acquire_np
from tpudab.synth.modulator import Impairments as JaxImpairments
from tpudab.synth.modulator import apply_impairments as jax_apply
from tpudab.synth.modulator import modulate_frame_bits
from test_modes import _spec as modes_spec
from test_multipath import _capture as multipath_capture
from test_multipath import _echo_profile
from tpudab.synth import EnsembleSynthesizer
from tpudab_torch.ofdm.sync import SyncConfig, carrier_spacing_hz
from tpudab_torch.ofdm.sync_device import (acquire_device, acquire_host, coarse_freq_device,
                                           fine_freq_device, fine_time_sync_device)
from tpudab_torch.synth.modulator import Impairments, apply_impairments

HZ_TOL = 1.0
Q_REL = 1e-3
INT_KEYS = ("frame_start", "coarse_bins")
HZ_KEYS = ("coarse_hz", "fine_hz", "net_freq_hz")
Q_KEYS = ("null_quality", "coarse_quality", "time_quality")


def random_frames(seed, mode=1, n_frames=3):
    """tests/test_sync_device.py's capture: random frame bits, modulated."""
    rng = np.random.default_rng(seed)
    p = get_ofdm_params(mode)
    return np.concatenate([modulate_frame_bits(rng.integers(0, 2, p.nb_frame_bits)
                                               .astype(np.uint8), mode)
                           for _ in range(n_frames)])


def modes_capture(mode):
    """tests/test_modes.py:43-48's capture (mode III built the same way)."""
    synth = EnsembleSynthesizer(modes_spec(mode), mode=mode, seed=10 + mode)
    frames = [synth.frame_bits(i) for i in range(2)]
    iq = np.concatenate([modulate_frame_bits(b, mode) for b in frames] * 3)
    imp = dict(freq_offset_hz=9_000.0, delay_samples=123, snr_db=18, seed=1)
    return iq, imp


def assert_same_acquisition(got, want):
    for k in INT_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in HZ_KEYS:
        assert abs(got[k] - want[k]) < HZ_TOL, (k, got[k], want[k])
    for k in Q_KEYS:
        assert abs(got[k] - want[k]) <= Q_REL * abs(want[k]), (k, got[k], want[k])


IMPAIRMENTS = {
    "cfo_delay_awgn": dict(freq_offset_hz=3400.0, delay_samples=1000, snr_db=20, phase=0.7,
                           seed=1),
    "ramp_ppm": dict(freq_offset_hz=-900.0, freq_ramp_hz_per_s=35.0, clock_ppm=40.0,
                     snr_db=12, amplitude=0.8, seed=7),
    "multipath": dict(freq_offset_hz=800.0, snr_db=15.0, amplitude=0.63,
                      multipath=((400, 1.0, 2.1), (150, 0.35, 0.7)), seed=9),
    "clean": dict(delay_samples=17),
}


@pytest.mark.parametrize("case", sorted(IMPAIRMENTS))
def test_impairments_bit_equal(case):
    x = random_frames(4, n_frames=2)
    kw = IMPAIRMENTS[case]
    got = apply_impairments(x, Impairments(**kw))
    want = jax_apply(x, JaxImpairments(**kw))
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# tests/test_sync_device.py:29-33
ORACLE_CASES = [
    dict(freq_offset_hz=3400.0, delay_samples=1000, snr_db=20, phase=0.7, seed=1),
    dict(freq_offset_hz=-47350.0, delay_samples=7777, snr_db=10, phase=2.1, seed=2),
    dict(freq_offset_hz=412.0, delay_samples=3, snr_db=8, phase=0.0, seed=3),
]


@pytest.mark.parametrize("case", range(len(ORACLE_CASES)))
def test_acquire_matches_tpudab_mode1(case):
    imp = ORACLE_CASES[case]
    iq = apply_impairments(random_frames(5), Impairments(**imp))
    got = acquire_host(iq, device="cpu")
    assert_same_acquisition(got, jax_acquire_host(iq))
    assert got["frame_start"] == imp["delay_samples"]
    ref = acquire_np(iq)
    assert got["frame_start"] == ref["frame_start"]
    assert got["coarse_bins"] == ref["coarse_bins"]
    assert abs(got["net_freq_hz"] - ref["net_freq_hz"]) < 5.0


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_acquire_matches_tpudab_other_modes(mode):
    iq, imp = modes_capture(mode)
    iq = apply_impairments(iq, Impairments(**imp))
    got = acquire_host(iq, mode, device="cpu")
    assert_same_acquisition(got, jax_acquire_host(iq, mode))
    assert got["frame_start"] == 123
    assert abs(got["net_freq_hz"] - 9_000.0) < 200
    ref = acquire_np(iq, mode)
    assert (got["frame_start"], got["coarse_bins"]) == (ref["frame_start"], ref["coarse_bins"])


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "argmax"])
@pytest.mark.parametrize("mode", [1, 4])
def test_acquire_multipath_matches_tpudab(mode, gated):
    """tests/test_multipath.py:71-88: the strongest ray a late echo. The
    gated search finds the direct path, plain argmax the echo, in both."""
    fl = get_ofdm_params(mode).nb_frame_length
    iq, _ = multipath_capture(4, snr_db=15.0, mode=mode)
    kw = {} if gated else {"peak_threshold_db": 0.0}
    got = acquire_host(iq[: 4 * fl], mode, device="cpu", **kw)
    assert_same_acquisition(got, jax_acquire_host(iq[: 4 * fl], mode=mode, **kw))
    err = min(got["frame_start"] % fl, fl - got["frame_start"] % fl)
    if gated:
        assert err <= 40
    else:
        assert err >= _echo_profile(mode)[0][0] * 0.75


def test_acquire_device_batched_matches_tpudab():
    """One call over a batch of differently impaired buffers (two of
    tests/test_sync_device.py:53-56 and a multipath one): each row equals
    tpudab's batched call."""
    imps = [dict(freq_offset_hz=1200.0, delay_samples=50_000, snr_db=15, seed=4),
            dict(freq_offset_hz=-8000.0, delay_samples=123, snr_db=12, seed=5),
            IMPAIRMENTS["multipath"]]
    iqs = [apply_impairments(random_frames(6 + i), Impairments(**imp))
           for i, imp in enumerate(imps)]
    n = min(x.shape[0] for x in iqs)
    re = np.stack([x.real[:n] for x in iqs]).astype(np.float32)
    im = np.stack([x.imag[:n] for x in iqs]).astype(np.float32)
    got = acquire_device(torch.from_numpy(re), torch.from_numpy(im))
    want = jax_acquire_device(re, im)
    assert got["frame_start"].dtype == got["coarse_bins"].dtype == torch.int32
    for i in range(len(imps)):
        assert_same_acquisition({k: v[i].item() for k, v in got.items()},
                                {k: np.asarray(v)[i].item() for k, v in want.items()})
    assert got["frame_start"][:2].tolist() == [50_000, 123]


def test_tracking_taps_match_tpudab():
    """The streaming taps: timing recheck, residual coarse bins and
    residual fine frequency, against tpudab's on the same segments."""
    p = get_ofdm_params(1)
    iq = apply_impairments(random_frames(11),
                           Impairments(freq_offset_hz=500.0, delay_samples=0, snr_db=20, seed=9))
    search = 64
    seg_start = p.nb_null_period + p.nb_cyclic_prefix - search
    seg = iq[seg_start: seg_start + 2 * search + p.nb_fft]
    sr, si = seg.real.astype(np.float32)[None], seg.imag.astype(np.float32)[None]
    peak, q = fine_time_sync_device(torch.from_numpy(sr), torch.from_numpy(si), 500.0,
                                    search=search)
    jpeak, jq = jax_fine_time(sr, si, np.float32(500.0), search=search)
    assert peak.tolist() == np.asarray(jpeak).tolist() == [search]
    assert abs(q.item() - float(np.asarray(jq)[0])) <= Q_REL * float(np.asarray(jq)[0])

    body = iq[p.nb_null_period + p.nb_cyclic_prefix:][: p.nb_fft]
    br, bi = body.real.astype(np.float32)[None], body.imag.astype(np.float32)[None]
    for freq in (500.0, 500.0 - 3 * carrier_spacing_hz(1)):
        bins, cq = coarse_freq_device(torch.from_numpy(br), torch.from_numpy(bi), freq)
        jbins, jcq = jax_coarse(br, bi, np.float32(freq))
        assert bins.tolist() == np.asarray(jbins).tolist()
        assert abs(cq.item() - float(np.asarray(jcq)[0])) <= Q_REL * float(np.asarray(jcq)[0])
    assert bins.tolist() == [3]

    frame = iq[: p.nb_frame_length]
    fr, fi = frame.real.astype(np.float32)[None], frame.imag.astype(np.float32)[None]
    for freq in (500.0, 450.0):
        resid = fine_freq_device(torch.from_numpy(fr), torch.from_numpy(fi), freq)
        want = float(np.asarray(jax_fine_freq(fr, fi, np.float32(freq)))[0])
        assert abs(resid.item() - want) < HZ_TOL
        assert abs(resid.item() - (500.0 - freq)) < 10.0


@pytest.mark.parametrize("spacings", [1.5, -2.25])
@pytest.mark.parametrize("mode", [1, 2])
def test_acquire_np_equals_tpudab(mode, spacings):
    """The port's numpy oracle (ofdm/sync_np.py) against tpudab's: the whole
    dict exactly equal, float64 and ints alike, at a CFO of 1.5 and -2.25
    carrier spacings (the half-carrier case that step 2 of acquire_np is
    ordered for), with delay and noise."""
    from tpudab_torch.ofdm import sync_np as port_np
    from tpudab.ofdm import sync_np as jax_np

    cfo = spacings * carrier_spacing_hz(mode)
    iq = apply_impairments(random_frames(20 + mode, mode),
                           Impairments(freq_offset_hz=cfo, delay_samples=321, snr_db=12,
                                       phase=0.3, seed=mode))
    got = port_np.acquire_np(iq, mode)
    want = jax_np.acquire_np(iq, mode)
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)
    assert got["frame_start"] == 321 and abs(got["net_freq_hz"] - cfo) < 50.0
    p = get_ofdm_params(mode)
    seg = iq[: p.nb_frame_length]
    assert port_np.fine_time_sync_np(seg, mode) == jax_np.fine_time_sync_np(seg, mode)
    assert port_np.prs_search_full_np(seg, mode, 1000) == jax_np.prs_search_full_np(seg, mode, 1000)


def test_sync_config_and_spacing_equal_tpudab():
    assert SyncConfig() == SyncConfig(**vars(JaxSyncConfig()))
    for mode in (1, 2, 3, 4):
        assert carrier_spacing_hz(mode) == jax_spacing(mode)


def test_acquire_refuses_short_buffer_and_no_card(monkeypatch):
    fl = get_ofdm_params(1).nb_frame_length
    x = torch.zeros((1, 2 * fl - 1))
    with pytest.raises(ValueError, match="2 frames"):
        acquire_device(x, x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acquire_host(np.zeros(2 * fl, np.complex64))

"""The port's offline pipeline against tpudab's through the UEP
calibration (tests/test_uep_calibration.py:169-272): the step waits while
a budget-solved UEP row calibrates, and a step already running demotes to
the host leg when such a row is discovered late, then rebuilds with every
subchannel. Tolerances as in tests/test_torch_pipeline.py: decoded bytes
equal to tpudab's and to the payload, except the logical frames made of
CIFs of two different captures, which decode to no payload row in either.
"""

import numpy as np
import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_pipeline import assert_same_where_payload, raw, synth_iq
from test_uep_calibration import KEY
from tpudab.fec.uep_calibrate import candidate_profiles
from tpudab.models.pipeline import OfflinePipeline as JaxPipeline
from tpudab.models.pipeline import decode_iq as jax_decode_iq
from tpudab.models.receiver import Receiver as JaxReceiver
from tpudab.synth import ASCTY_DAB_PLUS, EnsembleSpec, ServiceSpec, SubchannelSpec
from tpudab_torch.models.pipeline import OfflinePipeline
from tpudab_torch.models.receiver import Receiver


@pytest.fixture
def alt_table(monkeypatch):
    """tpudab's synthesiser punctures KEY's UEP row with an alternative
    candidate table (tests/test_uep_calibration.py:180-184)."""
    import tpudab.synth.ensemble as synth_mod
    alt = candidate_profiles(*KEY)[4]
    real_get = synth_mod.get_uep_profile
    monkeypatch.setattr(synth_mod, "get_uep_profile",
                        lambda br, pl: alt if (br, pl) == KEY else real_get(br, pl))
    return alt


def test_device_step_waits_for_calibration(alt_table):
    """tests/test_uep_calibration.py:169-215: the step is built only once
    the calibration has locked, with the calibrated table, and both legs
    give tpudab's bytes and the payload."""
    spec = EnsembleSpec(
        ensemble_id=0xCA13, label="Calib Mux3",
        services=[ServiceSpec(0xB202, "MP2 Dev", [(0, 0, 6)])],
        subchannels=[SubchannelSpec(6, start_cu=0, size_cu=116, protection=("uep",) + KEY)])
    payload = np.random.default_rng(35).integers(0, 256, (64, KEY[0] * 3)).astype(np.uint8)
    iq = synth_iq(spec, {6: payload}, 10, seed=23)
    for device_step in (False, True):
        pipe = OfflinePipeline(batch_frames=5, use_device_step=device_step,
                               receiver=Receiver(1, "cpu", decode_audio=False))
        acc = pipe.run(iq)
        jrx, jacc, _ = jax_decode_iq(iq, batch_frames=5, use_device_step=device_step,
                                     receiver=JaxReceiver(decode_audio=False))
        cal = pipe.receiver.uep_calibrations[6]
        assert cal.locked and cal.swapped and (cal.chosen.l, cal.chosen.pi) == \
            (alt_table.l, alt_table.pi)
        got = raw(acc, 6)
        np.testing.assert_array_equal(got, raw(jacc, 6))
        assert got.shape[0] >= 20
        np.testing.assert_array_equal(got, payload[: got.shape[0]])
        assert jrx.stats == pipe.receiver.stats
        if device_step:
            # built after the lock, with the table the calibration chose
            (cfg,) = pipe._driver.step.subchannels
            assert cfg.profile.runs == alt_table.to_profile().runs
            assert cfg.padding_bits == alt_table.padding_bits


def test_late_s_row_demotes_and_rebuilds_like_tpudab():
    """tests/test_uep_calibration.py:218-272: a step built with subchannel
    1 alone meets a budget-solved UEP row discovered late; the StepDriver hands
    the carries back to the host decoders (as f32), the calibration runs
    there, and the step is rebuilt with both. The bytes of both
    subchannels equal tpudab's run of the same two buffers."""
    def capture(with_b):
        services = [ServiceSpec(0xB300, "EEP A", [(0, ASCTY_DAB_PLUS, 1)])]
        subchannels = [SubchannelSpec(1, start_cu=0, size_cu=24, protection=("eep", 3, 0))]
        if with_b:
            services.append(ServiceSpec(0xB301, "UEP B", [(0, 0, 6)]))
            subchannels.append(SubchannelSpec(6, start_cu=24, size_cu=116,
                                              protection=("uep",) + KEY))
        spec = EnsembleSpec(ensemble_id=0xD155, label="Late Mux", services=services,
                            subchannels=subchannels)
        rng = np.random.default_rng(41)
        pay = {sid: rng.integers(0, 256, (64, nb)).astype(np.uint8)
               for sid, nb in ([(1, 32 * 3)] + ([(6, KEY[0] * 3)] if with_b else []))}
        return synth_iq(spec, pay, 16 if with_b else 8, seed=40), pay

    iq_a, _ = capture(False)
    iq_ab, pay = capture(True)
    pipe = OfflinePipeline(batch_frames=4, use_device_step=True,
                           receiver=Receiver(1, "cpu", decode_audio=False))
    jpipe = JaxPipeline(batch_frames=4, use_device_step=True,
                        receiver=JaxReceiver(decode_audio=False))
    demoted = []
    real_build = pipe._driver.maybe_build

    def spy(receiver, total_frames):
        had = pipe._driver.step is not None
        real_build(receiver, total_frames)
        if had and pipe._driver.step is None:
            demoted.append({sid: (d._history.dtype, d._n_seen)
                            for sid, d in receiver.subch_decoders.items()})
    pipe._driver.maybe_build = spy
    for p in (pipe, jpipe):
        first = p.run(iq_a)
        assert {c.subch_id for c in p._driver.step.subchannels} == {1}
        second = p.run(iq_ab)
        assert {c.subch_id for c in p._driver.step.subchannels} == {1, 6}
        p.acc = (first, second)
    assert demoted and demoted[0][1][0] == torch.float32
    assert pipe._driver.carry["deint_6"].dtype == torch.bfloat16
    assert pipe._driver.first_logical == jpipe._driver.first_logical
    assert pipe.receiver.stats == jpipe.receiver.stats
    cal = pipe.receiver.uep_calibrations[6]
    assert cal.locked and not cal.swapped
    np.testing.assert_array_equal(raw(pipe.acc[0], 1), raw(jpipe.acc[0], 1))
    np.testing.assert_array_equal(raw(pipe.acc[1], 6), raw(jpipe.acc[1], 6))
    # subchannel 1's first logical frames of the second buffer are made of
    # CIFs of both captures (the carry went on across them)
    idx = assert_same_where_payload(raw(pipe.acc[1], 1), raw(jpipe.acc[1], 1), pay[1])
    assert idx[15:] == list(range(idx[15], idx[15] + len(idx) - 15)) and idx[15] == 0
    got = raw(pipe.acc[1], 6)
    assert got.shape[0] >= 8
    np.testing.assert_array_equal(got, pay[6][16: 16 + got.shape[0]])

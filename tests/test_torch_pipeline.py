"""The port's offline pipeline (OfflinePipeline, decode_iq, StepDriver)
against tpudab's on the same seeded captures: the host leg alone, and with
the fused ReceiveStep once the FIC has found the layout.

Tolerance: every subchannel's decoded logical frames byte-equal to
tpudab's, and to the known payload; FIB CRC counts and the frame counts
equal; the acquisition's net frequency within 1 Hz. Layouts: one EEP
subchannel under CFO, delay and noise (tests/test_host_wiring.py's
multiplex), an EEP A + EEP B layout and a UEP layout of
tests/test_random_layouts.py (seeds 102 and 108), and a capture with a gap
that forces a resync. The UEP calibration's wait, demotion and rebuild are
in tests/test_torch_pipeline_uep.py. The port's step runs its chain in bf16 with the host history cast to bf16 at
the handoff (tpudab's runs it in f32 there): the bytes still agree.

Where a logical frame's 16 CIFs do not come from one stretch of signal
(frames that straddle a gap in the capture, or the carry of one capture
meeting the next), it decodes to no payload row in either package, and
those bytes are not held: the two Viterbi paths (tpudab's XLA scan on the
CPU, the port's Pallas-order twin) and the two demods' roundings part on
such inconsistent codewords. Every frame that decodes to a payload row in
one package does so in the other, with the same bytes.
"""

import numpy as np
import pytest
import torch

from test_random_layouts import _bitrate, _random_layout
from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.models.pipeline import decode_iq as jax_decode_iq
from tpudab.models.receiver import Receiver as JaxReceiver
from tpudab.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer, ServiceSpec,
                          SubchannelSpec)
from tpudab.synth.modulator import Impairments, apply_impairments, modulate_frame_bits
from tpudab_torch.models.pipeline import OfflinePipeline, decode_iq
from tpudab_torch.models.receiver import Receiver


def synth_iq(spec, payloads, n_frames, seed):
    synth = EnsembleSynthesizer(spec, seed=seed)
    for sid, pay in payloads.items():
        synth.payload_fn[sid] = (lambda p: lambda m: p[m].tobytes())(pay)
    return np.concatenate([modulate_frame_bits(synth.frame_bits(i))
                           for i in range(n_frames)]).astype(np.complex64)


def eep_capture(n_frames=8, seed=21):
    """tests/test_host_wiring.py's multiplex, through CFO, delay and noise."""
    spec = EnsembleSpec(
        ensemble_id=0x5A5A, label="Wiring Mux",
        services=[ServiceSpec(0xC501, "SvcW", [(0, ASCTY_DAB_PLUS, 3)])],
        subchannels=[SubchannelSpec(3, start_cu=0, size_cu=24, protection=("eep", 3, 0))])
    data = np.random.default_rng(100 + seed).integers(0, 256, (n_frames * 4, 96)).astype(np.uint8)
    iq = synth_iq(spec, {3: data}, n_frames, seed)
    iq = apply_impairments(iq, Impairments(freq_offset_hz=1234.0, delay_samples=777,
                                           snr_db=18, seed=3))
    return iq, {3: data}


def layout_capture(seed, n_frames=8):
    """tests/test_random_layouts.py:57-74 for one seed."""
    rng = np.random.default_rng(seed)
    layout = _random_layout(rng)
    spec = EnsembleSpec(
        ensemble_id=0x7000 + seed, label=f"Rand {seed}",
        services=[ServiceSpec(0x9000 + sid, f"R{sid}", [(0, 0, sid)]) for sid, *_ in layout],
        subchannels=[SubchannelSpec(sid, start_cu=st, size_cu=sz, protection=prot)
                     for sid, st, sz, prot in layout])
    pay = {sid: rng.integers(0, 256, (40, _bitrate(prot, sz) * 3)).astype(np.uint8)
           for sid, st, sz, prot in layout}
    return synth_iq(spec, pay, n_frames, seed), pay


def raw(acc, sid):
    rows = [o.raw_frames for o in acc.get(sid, ()) if o.raw_frames is not None
            and len(o.raw_frames)]
    return np.concatenate(rows) if rows else np.zeros((0, 0), np.uint8)


def payload_index(rows, pay):
    """For each decoded row, the payload row it equals, or -1."""
    return [int(np.flatnonzero((pay == r).all(1))[0]) if (pay == r).all(1).any() else -1
            for r in rows]


def assert_same_where_payload(got, want, pay):
    """The rows that decode to a payload row are the same in both, and
    byte-equal; the others (inconsistent codewords) are not held."""
    assert got.shape == want.shape
    idx = payload_index(want, pay)
    assert payload_index(got, pay) == idx
    keep = np.asarray(idx) >= 0
    np.testing.assert_array_equal(got[keep], want[keep])
    return idx


def assert_same_decode(port, ref, payloads, first=0):
    (rx, acc, stats), (jrx, jacc, jstats) = port, ref
    assert rx.stats == jrx.stats
    assert rx.stats["fib_crc_errors"] == 0
    assert (stats.total_frames, stats.frame_start, stats.next_pos, stats.reacquisitions) == \
        (jstats.total_frames, jstats.frame_start, jstats.next_pos, jstats.reacquisitions)
    assert abs(stats.net_freq_hz - jstats.net_freq_hz) < 1.0
    assert set(acc) == set(jacc) == set(payloads)
    for sid, pay in payloads.items():
        got, want = raw(acc, sid), raw(jacc, sid)
        np.testing.assert_array_equal(got, want, err_msg=f"subchannel {sid}")
        assert got.shape[0] >= 15
        np.testing.assert_array_equal(got[first:], pay[first: got.shape[0]],
                                      err_msg=f"subchannel {sid} payload")


CAPTURES = {"eep_impaired": eep_capture,
            "eep_a_b": lambda: layout_capture(102),
            "uep": lambda: layout_capture(108)}


@pytest.mark.parametrize("device_step", [False, True], ids=["host", "step"])
@pytest.mark.parametrize("case", sorted(CAPTURES))
def test_decode_iq_matches_tpudab(case, device_step):
    iq, payloads = CAPTURES[case]()
    kw = dict(batch_frames=4, use_device_step=device_step)
    port = decode_iq(iq, receiver=Receiver(1, "cpu", decode_audio=False), **kw)
    ref = jax_decode_iq(iq, receiver=JaxReceiver(decode_audio=False), **kw)
    # the impaired capture's first logical frame lies before the delay
    assert_same_decode(port, ref, payloads, first=1 if case == "eep_impaired" else 0)


def test_step_takes_over_with_a_bf16_carry():
    """With the step on, the first batch runs the host leg (the FIC finds
    the layout there), the second the step, seeded from the host history
    cast to bf16; the logical frames continue without a gap."""
    iq, payloads = eep_capture()
    pipe = OfflinePipeline(batch_frames=4, use_device_step=True,
                           receiver=Receiver(1, "cpu", decode_audio=False))
    rows = []
    pipe.run(iq, collect=lambda outs: rows.append(raw({3: [outs[3]]}, 3)))
    assert pipe._driver.step is not None and pipe._driver.first_logical == {3: 4 * 8 - 15}
    assert pipe._driver.carry["deint_3"].dtype == torch.bfloat16
    assert pipe._driver.carry["deint_3"].shape == (15, 24 * 64)
    assert [r.shape[0] for r in rows] == [1, 16]
    np.testing.assert_array_equal(np.concatenate(rows)[1:], payloads[3][1:17])


def test_resync_after_a_gap_matches_tpudab():
    """A capture with 1.5 frames of silence cut in after frame 4: every
    FIB of the next batch fails, the pipeline reacquires (pos +=
    frame_start) and decodes on; counts and bytes as tpudab's."""
    iq, payloads = eep_capture(n_frames=10)
    fl = 196608
    cut = 777 + 4 * fl
    iq = np.concatenate([iq[:cut], np.zeros(fl + fl // 2, np.complex64), iq[cut:]])
    kw = dict(batch_frames=2, use_device_step=False)
    rx, acc, stats = decode_iq(iq, receiver=Receiver(1, "cpu", decode_audio=False), **kw)
    jrx, jacc, jstats = jax_decode_iq(iq, receiver=JaxReceiver(decode_audio=False), **kw)
    assert stats.reacquisitions == jstats.reacquisitions >= 1
    assert (stats.total_frames_desync, stats.next_pos) == \
        (jstats.total_frames_desync, jstats.next_pos)
    assert rx.stats == jrx.stats
    # the frames that straddle the gap decode to no payload row
    idx = assert_same_where_payload(raw(acc, 3), raw(jacc, 3), payloads[3])
    assert idx[:7] == list(range(7)) and idx[-5:] == list(range(20, 25))

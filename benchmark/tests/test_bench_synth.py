"""The frozen synthesizer in benchmark/synth gives the same bits, IQ and
payloads as tpudab_torch.synth did when it was copied."""

import numpy as np

from benchmark.synth import ensemble as frozen
from benchmark.synth import modulator as frozen_mod
from benchmark.synth.payload import dabplus_stream


def _spec(mod, protection):
    subs = [mod.SubchannelSpec(1, start_cu=0, size_cu=96, protection=protection),
            mod.SubchannelSpec(2, start_cu=96, size_cu=72, protection=("eep", 3, 0))]
    svcs = [mod.ServiceSpec(0xC201, "one", [(0, mod.ASCTY_DAB, 1)]),
            mod.ServiceSpec(0xC202, "two", [(0, mod.ASCTY_DAB_PLUS, 2)])]
    return mod.EnsembleSpec(ensemble_id=0xBE9C, label="pin", services=svcs, subchannels=subs)


def test_frames_and_iq_equal_the_ports():
    from tpudab_torch import synth as port

    for protection in (("uep", 128, 3), ("eep", 2, 0)):
        a = frozen.EnsembleSynthesizer(_spec(frozen, protection), seed=5)
        b = port.EnsembleSynthesizer(_spec(port, protection), seed=5)
        for i in range(6):          # past the interleaver's 15-CIF ramp
            fa, fb = a.frame_bits(i), b.frame_bits(i)
            assert np.array_equal(fa, fb)
        assert np.array_equal(frozen_mod.modulate_frame_bits(fa), port.modulate_frame_bits(fb))
        x = frozen_mod.modulate_frame_bits(fa)
        imp = dict(freq_offset_hz=1234.5, delay_samples=77, snr_db=15.0,
                   multipath=((300, 0.4, 1.1),), seed=3)
        assert np.array_equal(frozen_mod.apply_impairments(x, frozen_mod.Impairments(**imp)),
                              port.apply_impairments(x, port.Impairments(**imp)))


def test_dabplus_stream_equals_the_ports():
    from tpudab_torch.synth.payload import dabplus_stream as port_stream

    for with_pad in (False, True):
        a, aus_a = dabplus_stream(96, 12, 3, with_pad=with_pad)
        b, aus_b = port_stream(96, 12, 3, with_pad=with_pad)
        assert np.array_equal(a, b) and aus_a == aus_b

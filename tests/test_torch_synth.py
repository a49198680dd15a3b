"""The port's jax-free synthesizer gives tpudab.synth's bits and IQ bit for
bit for the same spec and seed."""

import numpy as np
import pytest

import tpudab.synth as jsynth
import tpudab_torch.synth as tsynth


def _spec(pkg, layout):
    return pkg.EnsembleSpec(
        ensemble_id=0xBE9C, label="Bench Ensemble",
        services=[pkg.ServiceSpec(0xC200 + sid, f"Bench {sid}", [(0, pkg.ASCTY_DAB_PLUS, sid)])
                  for sid, *_ in layout],
        subchannels=[pkg.SubchannelSpec(sid, start_cu=start, size_cu=size, protection=prot)
                     for sid, start, size, prot in layout])


LAYOUTS = {
    "bench": [(i + 1, 108 * i, 108, ("eep", 3, 0)) for i in range(6)],
    "mixed": [(1, 0, 24, ("eep", 3, 0)), (2, 30, 54, ("eep", 1, 1)),
              (3, 100, 64, ("uep", 128, 5))],
    "single": [(1, 0, 36, ("eep", 3, 0))],
}


@pytest.mark.parametrize("name,mode", [("bench", 1), ("mixed", 1), ("single", 1),
                                       ("single", 3)])
def test_synth_iq_bit_exact(name, mode):
    layout = LAYOUTS[name]
    ref = jsynth.EnsembleSynthesizer(_spec(jsynth, layout), mode=mode, seed=1)
    port = tsynth.EnsembleSynthesizer(_spec(tsynth, layout), mode=mode, seed=1)
    data = np.random.default_rng(2).integers(0, 256, (8, 432)).astype(np.uint8)
    for s in (ref, port):
        s.payload_fn[1] = lambda m: data[m, : layout[0][2] // 6 * 24].tobytes()
    n = 2
    for i in range(n):
        np.testing.assert_array_equal(port.frame_bits(i), ref.frame_bits(i))
    np.testing.assert_array_equal(port.frames_iq(n), ref.frames_iq(n))
    bits = ref.frame_bits(0)
    np.testing.assert_array_equal(tsynth.modulate_frame_bits(bits, mode),
                                  jsynth.modulate_frame_bits(bits, mode))

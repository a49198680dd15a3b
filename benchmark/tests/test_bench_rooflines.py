"""The operation and byte counts behind viterbi_roofline and
carve_roofline, on known shapes."""

import json

import numpy as np

from benchmark import harness
from benchmark.peaks import bound_s

VIT = harness.load_module(harness.BENCH / "metrics" / "viterbi_roofline.py")
CARVE = harness.load_module(harness.BENCH / "metrics" / "carve_roofline.py")


def _config(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())


def test_superstep_count_is_the_programs_T2p():
    from tpudab_torch.constants.puncture import FIC_PROFILE, eep_profile, get_uep_profile
    from tpudab_torch.fec.depuncture import depuncture_index

    for profile in (FIC_PROFILE, eep_profile(108, 3, 0), eep_profile(36, 4, 0),
                    get_uep_profile(128, 3).to_profile()):
        assert VIT.superstep_count(profile.data_bits) * 8 == depuncture_index(profile).shape[0]


def test_viterbi_launches_and_bound_bench6():
    launches = VIT.launches(_config("bench6"), 32, 16)
    assert launches == [(2048, 400, 768), (12288, 1744, 3456)]
    # the MSC launch: 12288 x 1744 x 998 operations at 33.5e12 a second
    assert np.isclose(bound_s(0, 12288 * 1744 * 998), 0.6384e-3, rtol=1e-3)
    assert np.isclose(VIT.step_bound_s(_config("bench6"), 32, 16), 0.6628e-3, rtol=1e-3)


def test_viterbi_launches_mixed_layout():
    """A layout of three coding groups: a UEP service and EEP 3-A ones of
    two sizes, the two of one size in one launch."""
    sub = [{"id": 1, "start_cu": 0, "size_cu": 96, "protection": ["uep", 128, 3]},
           {"id": 2, "start_cu": 96, "size_cu": 72, "protection": ["eep", 3, 0]},
           {"id": 3, "start_cu": 168, "size_cu": 72, "protection": ["eep", 3, 0]},
           {"id": 4, "start_cu": 240, "size_cu": 48, "protection": ["eep", 3, 0]}]
    launches = VIT.launches({"mode": 1, "subchannels": sub}, 32, 16)
    assert len(launches) == 4                    # the FIC and 3 coding groups
    assert sum(b for b, _, _ in launches[1:]) == 4 * 32 * 64
    assert sum(b * bits for b, _, bits in launches[1:]) == (3072 + 2 * 2304 + 1536) * 32 * 64


def test_carve_bound():
    # 512 frames x 76 x 2048 windows: 2 bf16 in, 3 bf16 out, f32 tables
    n = 512 * 76 * 2048
    want = (2 * n * 2 + 512 * (76 + 2048) * 8 + 3 * n * 2) / 3.35e12
    assert np.isclose(CARVE.step_bound_s(1, 512), want)
    assert np.isclose(CARVE.step_bound_s(1, 512) * 1e3, 0.2405, rtol=1e-3)


def test_kernel_seconds_matches_whole_names():
    from benchmark.trace import kernel_seconds

    s = {"kernels": {"void (anonymous namespace)::viterbi_kernel<__nv_bfloat16, 16>(int)": [2.0, 2],
                     "void (anonymous namespace)::viterbi_bits_kernel<float>(int)": [5.0, 1],
                     "void (anonymous namespace)::carve_tile_kernel<1>(int)": [5.0, 1],
                     "void (anonymous namespace)::carve_kernel<__nv_bfloat16>(int)": [1.5, 3]}}
    assert kernel_seconds(s, "viterbi_kernel") == (2.0, 2)
    assert kernel_seconds(s, "carve_kernel") == (1.5, 3)

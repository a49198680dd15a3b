"""The port's own copy of tpudab's constants (tpudab_torch/constants/ and
the delay helpers of tpudab_torch/msc/interleave.py) against the originals,
over each function's whole domain: the modules' docstrings and every
module-level table, the EEP and UEP rows and both FIC profiles, all four
modes' OFDM/DAB parameters, carrier maps and PRS, the tables' strings, the
provenance caveats, the Band III channel table and interleave_delays /
interleave_np.
Tolerance: none, every value equal."""

import dataclasses
import importlib
import inspect
import re
import types

import numpy as np
import pytest

import tpudab.constants.provenance as j_prov
import tpudab.constants.puncture as j_punct
import tpudab.constants.tables as j_tables
import tpudab.msc.interleave as j_il
import tpudab_torch.constants.provenance as p_prov
import tpudab_torch.constants.puncture as p_punct
import tpudab_torch.constants.tables as p_tables
import tpudab_torch.msc.interleave as p_il

MODULES = ("ofdm_params", "dab_params", "interleaver", "prs", "puncture", "tables",
           "provenance", "channels")


def plain(v):
    """A value with the port's and tpudab's classes taken out: dataclass
    instances become their class name, fields and properties; arrays their
    dtype, shape and bytes."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        props = {name: plain(getattr(v, name)) for name, m in
                 inspect.getmembers(type(v), lambda m: isinstance(m, property))}
        fields = {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
        return (type(v).__name__, fields, props)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [plain(x) for x in v])
    if isinstance(v, dict):
        return ("dict", [(plain(k), plain(x)) for k, x in v.items()])
    return v


def outcome(fn, *args, **kw):
    """plain(fn(*args)) or the exception's type and message."""
    try:
        return ("ok", plain(fn(*args, **kw)))
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


def same(jfn, pfn, *args, **kw):
    assert outcome(pfn, *args, **kw) == outcome(jfn, *args, **kw), (jfn.__name__, args, kw)


@pytest.mark.parametrize("name", MODULES)
def test_module_tables_and_docstrings_equal(name):
    """Every module-level value (tables, constants, private row lists) and
    every docstring, the module's and each function's and class's."""
    jm = importlib.import_module(f"tpudab.constants.{name}")
    pm = importlib.import_module(f"tpudab_torch.constants.{name}")
    # the one edit of the copy: the reference sources are named from the
    # reference project's root, not as a path on a build machine
    assert pm.__doc__ == re.sub(r"/\w+/reference/src/", "the reference's src/", jm.__doc__)
    jnames = {k for k in vars(jm) if not k.startswith("__")}
    assert {k for k in vars(pm) if not k.startswith("__")} == jnames
    for k in sorted(jnames):
        jv, pv = getattr(jm, k), getattr(pm, k)
        if isinstance(jv, types.ModuleType) or k == "annotations":
            continue
        if callable(jv):
            assert inspect.getdoc(pv) == inspect.getdoc(jv), k
            if not isinstance(jv, type):
                assert inspect.signature(pv) == inspect.signature(jv), k
            continue
        assert plain(pv) == plain(jv), k


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_mode_parameters_maps_and_prs_equal(mode):
    for mod, fns in (("ofdm_params", ["get_ofdm_params"]),
                     ("dab_params", ["get_dab_params"]),
                     ("interleaver", ["get_carrier_map", "get_carrier_map_positions",
                                      "get_inverse_map_positions"]),
                     ("prs", ["get_prs_phases", "get_prs_carriers", "get_prs_spectrum",
                              "get_prs_time"])):
        jm = importlib.import_module(f"tpudab.constants.{mod}")
        pm = importlib.import_module(f"tpudab_torch.constants.{mod}")
        for fn in fns:
            same(getattr(jm, fn), getattr(pm, fn), mode)
    jm = importlib.import_module("tpudab.constants.ofdm_params")
    pm = importlib.import_module("tpudab_torch.constants.ofdm_params")
    same(jm.get_ofdm_params, pm.get_ofdm_params, 5)


@pytest.mark.parametrize("option", [0, 1])
def test_eep_rows_equal(option):
    """eep_profile over every size and level of the option (and the
    refusals), with its masks; the bitrate and data bits of each."""
    for level in (1, 2, 3, 4):
        for size in range(1, 865):
            same(j_punct.eep_profile, p_punct.eep_profile, size, level, option)
            j = outcome(j_punct.eep_profile, size, level, option)
            if j[0] == "ok":
                assert np.array_equal(p_punct.eep_profile(size, level, option).mask(),
                                      j_punct.eep_profile(size, level, option).mask())
                same(j_punct.eep_bitrate_kbps, p_punct.eep_bitrate_kbps, size, level, option)
                same(j_punct.eep_data_bits, p_punct.eep_data_bits, size, level, option)
    same(j_punct.eep_profile, p_punct.eep_profile, 24, 3, 2)


def test_uep_rows_and_index_equal():
    keys = j_punct.uep_index_order()
    assert p_punct.uep_index_order() == keys and len(keys) == 64
    assert p_punct.get_uep_index_table() == j_punct.get_uep_index_table()
    for k in keys + [(33, 1), (32, 6)]:
        same(j_punct.get_uep_profile, p_punct.get_uep_profile, *k)
        same(j_punct.uep_row_confidence, p_punct.uep_row_confidence, *k)
    for k in keys:
        jp, pp = j_punct.get_uep_profile(*k), p_punct.get_uep_profile(*k)
        assert plain(pp.to_profile()) == plain(jp.to_profile())
        assert pp.consistent() == jp.consistent()
        assert np.array_equal(pp.to_profile().mask(), jp.to_profile().mask())
        same(j_punct.uep_descriptor, p_punct.uep_descriptor, jp.size_cu)
        same(j_punct.uep_descriptor, p_punct.uep_descriptor, 0, bitrate_kbps=k[0],
             protection_level=k[1])
    for i in range(-1, 66):
        same(j_punct.get_uep_profile_by_index, p_punct.get_uep_profile_by_index, i)
    same(j_punct.uep_descriptor, p_punct.uep_descriptor, 7)


def test_fic_profiles_and_puncture_vectors_equal():
    for name in ("FIC_PROFILE", "FIC_PROFILE_MODE3"):
        jp, pp = getattr(j_punct, name), getattr(p_punct, name)
        assert plain(pp) == plain(jp)
        assert np.array_equal(pp.mask(), jp.mask())
    for pi in range(0, 26):
        same(j_punct.puncture_vector, p_punct.puncture_vector, pi)
    assert p_punct.TAIL_BITS == j_punct.TAIL_BITS == 6


def test_table_strings_equal():
    for pty in range(-1, 40):
        same(j_tables.programme_type_str, p_tables.programme_type_str, pty)
    for code in range(256):
        same(j_tables.language_str, p_tables.language_str, code)
    for ecc, cid in list(j_tables.COUNTRIES) + [(0, 0), (0xE0, 0xF), (0xFF, 0x1)]:
        same(j_tables.country_str, p_tables.country_str, ecc, cid)
    for sbr in (False, True):
        for ps in (False, True):
            same(j_tables.aac_profile_str, p_tables.aac_profile_str, sbr, ps)
    for code in range(10):
        same(j_tables.mpeg_surround_str, p_tables.mpeg_surround_str, code)


def test_provenance_caveats_equal():
    assert p_prov.reconstruction_caveats() == j_prov.reconstruction_caveats()
    for is_uep in (False, True):
        for mode in (1, 2, 3, 4):
            same(j_prov.caveats_for_subchannel, p_prov.caveats_for_subchannel, is_uep, mode)
            for k in j_punct.uep_index_order() + [(33, 1)]:
                same(j_prov.caveats_for_subchannel, p_prov.caveats_for_subchannel,
                     is_uep, mode, *k)


def test_interleave_helpers_equal():
    assert p_il.TIME_INTERLEAVE_DEPTH == j_il.TIME_INTERLEAVE_DEPTH == 16
    for n in (1, 15, 16, 17, 100, 6912, 55_296):
        assert np.array_equal(p_il.interleave_delays(n), j_il.interleave_delays(n))
    rng = np.random.default_rng(0)
    for shape in ((1, 16), (20, 96), (40, 1000)):
        frames = rng.standard_normal(shape).astype(np.float32)
        assert np.array_equal(p_il.interleave_np(frames), j_il.interleave_np(frames))
        bits = rng.integers(0, 2, shape).astype(np.uint8)
        got, want = p_il.interleave_np(bits), j_il.interleave_np(bits)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_band_iii_channels_equal():
    import tpudab.constants.channels as j_ch
    import tpudab_torch.constants.channels as p_ch
    assert p_ch.channel_labels() == j_ch.channel_labels()
    assert len(p_ch.BAND_III) == 38
    for label in j_ch.channel_labels() + ["12c", " 5a ", "14A", "13G", ""]:
        same(j_ch.channel_freq_hz, p_ch.channel_freq_hz, label)

"""The port's step tools (tpudab_torch/tools/{profile_step3, exp_step_shapes,
exp_demod_output, exp_conv_demod, exp_aligned_demod, exp_viterbi_params,
exp_viterbi_sweep, uep_ambiguity}.py) against tpudab's tools, on the CPU at
a small size.

tpudab's tools fix their sizes inside main() (256 frames, 6144
codewords), so the test rebuilds each tool's formula in jax from tpudab's
public pieces (tpudab.ofdm.demod._dense_demod_matrix, active_bin_indices,
tpudab.ops.carve.carve_rotate in Pallas interpret mode as tpudab's CPU
tests run it, tpudab.synth.modulator, the Pallas Viterbi in interpret
mode) and runs the same numpy-seeded inputs through it and through the
port's tool functions on the CPU (the plain torch twins), at f = 4 frames,
E = 1-2 ensembles x F = 2-4 frames and 8 codewords.

Tolerances:
- spectra and demapped parts (conv, aligned, demod output): a relative RMS
  difference of at most 2^-8, one bf16 ulp as a root mean square (bf16
  keeps 8 significant bits, so one ulp is 2^-8 to 2^-7 of a value). Per
  element the two frameworks' bf16 products round apart: the port's CPU
  carve takes each sample's phase from its time, tpudab's kernel adds
  two angles, and a window sample one ulp apart moves a 2048-term product
  across a rounding step of its bf16 output, which shows in the
  difference of two such outputs as several ulps of the smaller result.
  Measured: 1.5e-3 to 2.5e-3 where the production carve enters (the
  two carves), 0.8e-4 to 1.7e-4 on the conv and aligned paths (one
  formula on both sides);
- the aligned path's hard-decision sign match equal to tpudab's within
  1e-3;
- decoded bytes (profile_step3's stage 3, the Viterbi tools) equal;
- the UEP report equal as a dict.
"""

import functools
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_step import capture, configs, split_iq
from tpudab.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab.constants.interleaver import get_carrier_map_positions
from tpudab.constants.puncture import eep_profile as jax_eep_profile
from tpudab.fec.depuncture import depuncture_t as jax_depuncture_t
from tpudab.models.step import ReceiveStep as JaxStep
from tpudab.ofdm.demod import _dense_demod_matrix, active_bin_indices
from tpudab.ops.carve import carve_rotate as jax_carve_rotate
from tpudab.ops.viterbi_pallas import (viterbi_decode_pallas_bytes,
                                       viterbi_decode_pallas_bytes_t)
from tpudab.synth.modulator import (Impairments as JaxImpairments,
                                    apply_impairments as jax_apply_impairments,
                                    modulate_frame_bits as jax_modulate)
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.ofdm.demod import dft_operands
from tpudab_torch.tools import (exp_aligned_demod, exp_conv_demod, exp_demod_output,
                                exp_step_shapes, exp_viterbi_params, exp_viterbi_sweep,
                                profile_step3, uep_ambiguity)
from tpudab_torch.tools._common import gaussian_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F = 4
REL_RMS_MAX = 2.0 ** -8
MODE = 1
P = get_ofdm_params(MODE)
N_SYM, N_FFT, N_CP = P.nb_symbols, P.nb_fft, P.nb_cyclic_prefix
STRIDE = N_FFT + N_CP
START = N_CP - 12
A0 = P.nb_null_period + START


def rel_rms(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def f32(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


def to_jax_bf16(x: torch.Tensor):
    """The same bf16 values in jax."""
    return jnp.asarray(f32(x), jnp.bfloat16)


# ---------------- tpudab's formulas in jax (tools/exp_*_demod.py) ----------

def karatsuba(ar, ai):
    wre, wim = _dense_demod_matrix(MODE)
    k = wre.shape[1]
    dt = jnp.bfloat16
    mm = lambda a, b: lax.dot_general(a, b, dimension_numbers=(((2, 3), (0, 1)), ((), ())),
                                      preferred_element_type=dt)
    shp = (N_FFT // 128, 128, k)
    m1 = mm((ar + ai).astype(dt), jnp.asarray(wre.reshape(shp), dt))
    m2 = mm(ai, jnp.asarray((wre + wim).reshape(shp), dt))
    m3 = mm(ar, jnp.asarray((wim - wre).reshape(shp), dt))
    return m1 - m2, m3 + m1


def demap(cr, ci):
    dr = cr[:, 1:, :] * cr[:, :-1, :] + ci[:, 1:, :] * ci[:, :-1, :]
    di = ci[:, 1:, :] * cr[:, :-1, :] - cr[:, 1:, :] * ci[:, :-1, :]
    return dr, di


def jax_production(re3, im3, freq):
    """tpudab's tools' production path: the carve kernel (interpret mode)
    and the three products: (cr, ci)."""
    f = re3.shape[0]
    xr, xi = jax_carve_rotate(re3, im3, freq, MODE, 12, interpret=True)
    return karatsuba(xr.reshape(f, N_SYM, N_FFT // 128, 128),
                     xi.reshape(f, N_SYM, N_FFT // 128, 128))


def jax_conv(re3, im3, freq):
    """tools/exp_conv_demod.py::conv_path."""
    f = re3.shape[0]
    wre, wim = _dense_demod_matrix(MODE)

    def conv1d(x, w):
        return lax.conv_general_dilated(
            x[:, None, A0: A0 + (N_SYM - 1) * STRIDE + N_FFT], w.T[:, None, :],
            window_strides=(STRIDE,), padding="VALID",
            dimension_numbers=("NCW", "OIW", "NWC"), preferred_element_type=jnp.bfloat16)

    flat_r = re3.reshape(f, P.nb_frame_length).astype(jnp.float32)
    flat_i = im3.reshape(f, P.nb_frame_length).astype(jnp.float32)
    t = jnp.arange(P.nb_frame_length, dtype=jnp.float32) / SAMPLING_RATE
    ph = -2.0 * jnp.pi * freq[:, None] * t[None, :]
    c, s = jnp.cos(ph), jnp.sin(ph)
    ar = (flat_r * c - flat_i * s).astype(jnp.bfloat16)
    ai = (flat_r * s + flat_i * c).astype(jnp.bfloat16)
    dt = jnp.bfloat16
    m1 = conv1d((ar + ai).astype(dt), jnp.asarray(wre, dt))
    m2 = conv1d(ai, jnp.asarray(wre + wim, dt))
    m3 = conv1d(ar, jnp.asarray(wim - wre, dt))
    return m1 - m2, m3 + m1


def jax_aligned(re3, im3, freq):
    """tools/exp_aligned_demod.py::aligned, with its static tables."""
    f = re3.shape[0]
    a_nom = [P.nb_null_period + STRIDE * s + START for s in range(N_SYM)]
    r0 = [a // 128 for a in a_nom]
    delta = [r * 128 - a for r, a in zip(r0, a_nom)]
    bins = active_bin_indices(MODE)
    pos = get_carrier_map_positions(MODE)
    k_signed = ((bins[pos.astype(np.int64)] + N_FFT // 2) % N_FFT - N_FFT // 2)
    dd = np.array([delta[s + 1] - delta[s] for s in range(N_SYM - 1)])
    ang = -2.0 * np.pi * np.outer(dd, k_signed) / N_FFT
    corr_c = np.cos(ang).astype(np.float32)
    corr_s = np.sin(ang).astype(np.float32)
    rows = P.nb_frame_length // 128
    t_abs = (np.arange(P.nb_frame_length) / SAMPLING_RATE).astype(np.float32)
    t3 = jnp.asarray(t_abs.reshape(rows, 128))
    ph = -2.0 * jnp.pi * freq[:, None, None] * t3[None]
    c, s = jnp.cos(ph), jnp.sin(ph)
    vr = re3.astype(jnp.float32)
    vi = im3.astype(jnp.float32)
    xr = (vr * c - vi * s).astype(jnp.bfloat16)
    xi = (vr * s + vi * c).astype(jnp.bfloat16)
    ar = jnp.stack([lax.slice_in_dim(xr, r, r + N_FFT // 128, axis=1) for r in r0], axis=1)
    ai = jnp.stack([lax.slice_in_dim(xi, r, r + N_FFT // 128, axis=1) for r in r0], axis=1)
    dr, di = demap(*karatsuba(ar, ai))
    cc = jnp.asarray(corr_c, dr.dtype)[None]
    ss = jnp.asarray(corr_s, dr.dtype)[None]
    return dr * cc - di * ss, di * cc + dr * ss


def jax_output_variants(re3, im3, freq):
    """tools/exp_demod_output.py's four variants on f frames."""
    f = re3.shape[0]
    dr, di = demap(*jax_production(re3, im3, freq))
    soft = jnp.concatenate([dr, di], axis=-1).reshape(f, P.nb_frame_bits)
    norm = jnp.mean(jnp.abs(soft).astype(jnp.float32), axis=-1, keepdims=True)
    s = (jnp.mean(jnp.abs(dr).astype(jnp.float32), axis=(1, 2), keepdims=True)
         + jnp.mean(jnp.abs(di).astype(jnp.float32), axis=(1, 2), keepdims=True)) * 0.5
    inv = 1.0 / jnp.maximum(s, 1e-20)
    return {"parts (dr,di)": (dr, di), "concat": soft,
            "concat+norm": (soft.astype(jnp.float32)
                            / jnp.maximum(norm, 1e-20)).astype(jnp.bfloat16),
            "norm parts": ((dr.astype(jnp.float32) * inv).astype(jnp.bfloat16),
                           (di.astype(jnp.float32) * inv).astype(jnp.bfloat16))}


# ---------------- the demod experiments ----------

def test_conv_demod_equals_tpudab():
    re3, im3 = gaussian_frames(F, CPU)
    rng = np.random.default_rng(0)    # tools/exp_conv_demod.py's frames
    for got in (re3, im3):
        want = rng.standard_normal((F, P.nb_frame_length)).astype(np.float32)
        np.testing.assert_array_equal(f32(got).reshape(F, -1),
                                      np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32))
    freq = np.full((F,), exp_conv_demod.FREQ_HZ, np.float32)
    ops = dft_operands(MODE)
    jre, jim, jfreq = to_jax_bf16(re3), to_jax_bf16(im3), jnp.asarray(freq)
    tfreq = torch.from_numpy(freq)
    for port, ref in ((exp_conv_demod.production(re3, im3, tfreq, ops),
                       jax_production(jre, jim, jfreq)),
                      (exp_conv_demod.conv_path(re3, im3, tfreq, ops),
                       jax_conv(jre, jim, jfreq))):
        for got, want in zip(port, ref):
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
            assert rel_rms(f32(got), want) <= REL_RMS_MAX


def test_conv_view_is_the_windows():
    """windows_view reads the carve's windows in place."""
    from tpudab_torch.ops.carve import _windows
    x = torch.arange(2 * P.nb_frame_length, dtype=torch.float32).reshape(2, -1)
    view = exp_conv_demod.windows_view(x)
    assert view.data_ptr() - x.data_ptr() == A0 * 4
    assert torch.equal(view, _windows(x, MODE, 12))


def test_aligned_demod_equals_tpudab():
    frames = exp_aligned_demod.ofdm_frames(F)
    rng = np.random.default_rng(0)
    want_frames = []
    for _ in range(4):
        bits = rng.integers(0, 2, P.nb_frame_bits).astype(np.uint8)
        iq = jax_modulate(bits, MODE)
        want_frames.append(jax_apply_impairments(
            iq, JaxImpairments(freq_offset_hz=1234.5))[:P.nb_frame_length])
    np.testing.assert_array_equal(frames, np.stack(want_frames))

    re3, im3 = (torch.from_numpy(np.ascontiguousarray(v, np.float32).reshape(F, -1, 128))
                .to(torch.bfloat16) for v in (frames.real, frames.imag))
    freq = np.full((F,), exp_aligned_demod.FREQ_HZ, np.float32)
    ops = dft_operands(MODE)
    jre, jim, jfreq = to_jax_bf16(re3), to_jax_bf16(im3), jnp.asarray(freq)
    tfreq = torch.from_numpy(freq)
    tp = exp_aligned_demod.production(re3, im3, tfreq, ops)
    ta = exp_aligned_demod.aligned_path(re3, im3, tfreq, ops)
    jp = demap(*jax_production(jre, jim, jfreq))
    ja = jax_aligned(jre, jim, jfreq)
    for got, want in zip(tp + ta, jp + ja):
        assert tuple(got.shape) == want.shape
        assert rel_rms(f32(got), want) <= REL_RMS_MAX
    match = lambda a, b: float(np.mean(np.sign(np.asarray(a, np.float32))
                                       == np.sign(np.asarray(b, np.float32))))
    assert abs(match(f32(tp[0]), f32(ta[0])) - match(jp[0], ja[0])) <= 1e-3


def test_demod_output_variants_equal_tpudab():
    re3, im3 = gaussian_frames(F, CPU)
    freq = np.full((F,), exp_demod_output.FREQ_HZ, np.float32)
    port = exp_demod_output.variants(re3, im3, torch.from_numpy(freq), dft_operands(MODE))
    ref = jax_output_variants(to_jax_bf16(re3), to_jax_bf16(im3), jnp.asarray(freq))
    assert list(port) == list(ref)
    for name, fn in port.items():
        got, want = fn(), ref[name]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
            assert rel_rms(f32(g), w) <= REL_RMS_MAX, name


@pytest.mark.parametrize("tool", [exp_conv_demod, exp_aligned_demod, exp_demod_output],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_demod_tool_runs_on_the_cpu(tool):
    out = tool.run(CPU, 1, F)
    assert out["checks"] and all(out["checks"].values()), out["checks"]
    assert all(np.isfinite(v) for v in out["ms"].values() if isinstance(v, float))


def test_conv_tool_reports_the_views_product():
    tr = exp_conv_demod.run(CPU, 1, F)["ms"]["view_product"]
    assert "aten::matmul" in tr["ops"] and isinstance(tr["copies"], bool)


# ---------------- the step's breakdown and shapes ----------

def test_profile_step3_msc_bytes_equal_tpudab():
    """Stage 3 (demod, K4 (b), K1+K2, descramble) on a synthesised signal
    of two ensembles x four frames gives tpudab's ReceiveStep MSC bytes;
    every stage runs."""
    e, f = 2, 4
    frames = np.stack([capture(f, 7 + i)[0] for i in range(e)])
    re, im = split_iq(frames)
    jc, tc = configs()
    jstep = JaxStep(mode=1, subchannels=jc, n_ensembles=e)
    _, jout = jstep(jstep.init_carry(), jnp.asarray(re, jnp.bfloat16),
                    jnp.asarray(im, jnp.bfloat16), np.float32(0.0))
    step = ReceiveStep(1, tc, n_ensembles=e)
    fns = profile_step3.stages(step, step.init_carry(CPU),
                               torch.from_numpy(re).to(torch.bfloat16),
                               torch.from_numpy(im).to(torch.bfloat16), 0.0)
    got = fns["+ K1+K2 + descramble (MSC only, no FIC)"]()
    assert set(got) == set(jout["subch"])
    for sid, want in jout["subch"].items():
        np.testing.assert_array_equal(got[sid].reshape(want.shape).numpy(), np.asarray(want))
    carry, inputs = fns["+ K4 (b): deinterleave + depuncture (MSC)"]()
    assert len(inputs) == len(step.groups) and set(carry) == set(step.init_carry(CPU))
    assert fns["demod only"]().shape == (e * f, P.nb_frame_bits)


def test_profile_step3_runs_on_the_cpu():
    out = profile_step3.run(CPU, 1, ((1, 2),))
    assert out["checks"] == {"e1_f2_msc_bytes": True}
    assert out["ms"]["e1_f2"]["rtf"] > 0


def test_step_shapes_runs_on_the_cpu():
    out = exp_step_shapes.run(CPU, 1, ((1, 2), (2, 2)))
    assert out["checks"] == {"e1_f2": True, "e2_f2": True}
    assert all(v["step_ms"] > 0 and v["peak_gib"] is None for v in out["ms"].values())
    assert exp_step_shapes.SHAPES == ((16, 16), (16, 24), (16, 32), (24, 16), (32, 16),
                                      (8, 32))


# ---------------- the Viterbi tools ----------

N_CW = 8


def test_viterbi_params_equal_tpudab_pallas():
    soft = exp_viterbi_params.soft_input(N_CW)
    fns, st = exp_viterbi_params.chain(soft)
    prof = jax_eep_profile(108, 3, 0)
    jst = jax_depuncture_t(to_jax_bf16(soft), prof)
    np.testing.assert_array_equal(f32(st), np.asarray(jst, np.float32))
    want = np.asarray(viterbi_decode_pallas_bytes_t(jst, prof.data_bits, interpret=True))
    np.testing.assert_array_equal(fns["decode"]().numpy(), want)
    np.testing.assert_array_equal(fns["chain"]().numpy(), want)


def test_viterbi_sweep_equals_tpudab_pallas():
    from tpudab_torch.ops.viterbi_cuda import viterbi_decode_bytes_best
    soft = exp_viterbi_sweep.soft_input(N_CW)
    assert tuple(soft.shape) == (N_CW, exp_viterbi_sweep.NBITS + 6, 4)
    full = np.random.default_rng(1).standard_normal((16, exp_viterbi_sweep.NBITS + 6, 4))
    np.testing.assert_array_equal(soft.numpy(), full[:N_CW].astype(np.float32))
    want = np.asarray(viterbi_decode_pallas_bytes(jnp.asarray(soft.numpy()),
                                                  exp_viterbi_sweep.NBITS, interpret=True))
    np.testing.assert_array_equal(
        viterbi_decode_bytes_best(soft, exp_viterbi_sweep.NBITS).numpy(), want)


@pytest.mark.parametrize("tool,args", [(exp_viterbi_params, (N_CW,)),
                                       (exp_viterbi_sweep, (N_CW, 64))],
                         ids=["params", "sweep"])
def test_viterbi_tool_runs_on_the_cpu(tool, args):
    out = tool.run(CPU, 1, *args)
    assert out["checks"] == {"twin": True}


# ---------------- the UEP report ----------

@functools.cache
def tpudab_uep_tool():
    spec = importlib.util.spec_from_file_location(
        "tpudab_tool_uep_ambiguity", os.path.join(ROOT, "tools", "uep_ambiguity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_uep_ambiguity_equals_tpudab(monkeypatch, tmp_path, capsys):
    """tpudab's tool writes UEP_AMBIGUITY.json two levels above its file:
    the test points its __file__ into tmp_path so that it writes there."""
    tool = tpudab_uep_tool()
    monkeypatch.setattr(tool, "__file__", str(tmp_path / "tools" / "uep_ambiguity.py"))
    monkeypatch.setattr(sys, "argv", ["uep_ambiguity.py"])
    tool.main()
    want = json.loads((tmp_path / "UEP_AMBIGUITY.json").read_text())
    capsys.readouterr()

    got = uep_ambiguity.main([])
    assert got == want
    assert json.loads(capsys.readouterr().out) == want
    out = tmp_path / "port.json"
    assert uep_ambiguity.main(["--out", str(out)]) == want
    assert json.loads(out.read_text()) == want

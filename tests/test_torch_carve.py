"""Parity of the port's carve + rotate (the plain twins of kernel K5) with
tpudab's Pallas carve kernel in interpret mode, of its rotator tables, and
of the bf16 sum it writes for the demod's first Karatsuba product."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.ofdm_params import get_ofdm_params
from tpudab.ops.carve import carve_rotate as jax_carve_rotate
from tpudab_torch.ops.carve import (carve_rotate, carve_rotate_ref, carve_rotate_tables_ref,
                                   rotator_tables)


def bf16_ulps(xr, xi, rr, ri):
    """|kernel - plain| of rotated IQ pairs in bf16 ulps at the pair's
    magnitude, in f32: a rotation keeps |x|, and a component near zero may
    differ by more than its own ulp when the f32 phases round apart."""
    xr, xi, rr, ri = (np.asarray(v, np.float32) for v in (xr, xi, rr, ri))
    mag = np.maximum(np.hypot(xr, xi), np.hypot(rr, ri))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.maximum(np.abs(xr - rr), np.abs(xi - ri)) / ulp


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_carve_matches_pallas_kernel(in_dtype):
    """Inputs of tests/test_ofdm.py::test_carve_rotate_kernel_matches_xla.
    Tolerance: 1 bf16 ulp at each sample's magnitude (the two build the
    rotator differently in f32)."""
    p = get_ofdm_params(1)
    rng = np.random.default_rng(3)
    f = 2
    re = rng.standard_normal((f, p.nb_frame_length)).astype(np.float32).reshape(f, -1, 128)
    im = rng.standard_normal((f, p.nb_frame_length)).astype(np.float32).reshape(f, -1, 128)
    freq = np.array([800.0, -350.0], np.float32)
    jdt = jnp.dtype(in_dtype)
    xr, xi = jax_carve_rotate(jnp.asarray(re).astype(jdt), jnp.asarray(im).astype(jdt),
                              jnp.asarray(freq), interpret=True)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[in_dtype]
    tr, ti = carve_rotate(torch.from_numpy(re).to(tdt), torch.from_numpy(im).to(tdt),
                          torch.from_numpy(freq))
    assert tr.dtype == torch.bfloat16 and tuple(tr.shape) == xr.shape
    ulps = bf16_ulps(tr.float().numpy(), ti.float().numpy(),
                     np.asarray(xr.astype(jnp.float32)), np.asarray(xi.astype(jnp.float32)))
    assert ulps.max() <= 1.0


def test_rotator_tables_angle_addition():
    """ca*ci - sa*si is the rotator's cos at absolute sample time, to f32."""
    p = get_ofdm_params(1)
    freq = torch.tensor([1500.0, -2000.0])
    ca, sa, ci, si = rotator_tables(freq, 1, 12)
    c = ca[:, :, None] * ci[:, None, :] - sa[:, :, None] * si[:, None, :]
    first = p.nb_null_period + p.nb_cyclic_prefix - 12
    t = (first + (p.nb_fft + p.nb_cyclic_prefix) * np.arange(p.nb_symbols))[:, None] \
        + np.arange(p.nb_fft)[None]
    want = np.cos(-2 * np.pi * freq.numpy().astype(np.float64)[:, None, None] * t / 2.048e6)
    np.testing.assert_allclose(c.numpy(), want, atol=2e-3)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_rotator_tables_equal_tpudab_tables(mode):
    """The window-start phases are built on the device from integer starts;
    the tables equal carve.py:123-136's f32 arithmetic (starts cast from
    numpy) bit for bit."""
    p = get_ofdm_params(mode)
    freq = torch.tensor([1999.0, -2000.0, 0.0, 731.5])
    first = p.nb_null_period + p.nb_cyclic_prefix - 12
    scale = (-2.0 * np.pi / 2.048e6) * freq
    a_sym = torch.from_numpy((first + (p.nb_fft + p.nb_cyclic_prefix)
                              * np.arange(p.nb_symbols)).astype(np.float32))
    ph_a = scale[:, None] * a_sym[None, :]
    ph_idx = scale[:, None] * torch.arange(p.nb_fft, dtype=torch.float32)[None, :]
    want = (torch.cos(ph_a), torch.sin(ph_a), torch.cos(ph_idx), torch.sin(ph_idx))
    for got, w in zip(rotator_tables(freq, mode, 12), want):
        assert got.dtype == torch.float32 and torch.equal(got, w)



def carve_inputs(mode: int, in_dtype: str, f: int = 2):
    p = get_ofdm_params(mode)
    rng = np.random.default_rng(3)
    re = rng.standard_normal((f, p.nb_frame_length)).astype(np.float32).reshape(f, -1, 128)
    im = rng.standard_normal((f, p.nb_frame_length)).astype(np.float32).reshape(f, -1, 128)
    return re, im, np.array([800.0, -1950.0], np.float32)[:f]


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [1, 2])
def test_tables_twin_within_one_ulp(mode, in_dtype):
    """carve_rotate_tables_ref (the kernel's own f32 arithmetic) within 1
    bf16 ulp at each sample's magnitude of tpudab's Pallas carve in
    interpret mode and of carve_rotate_ref. Measured maxima: 1.0 ulp
    against both in mode I; in mode II 0.0625 (f32 frames) and 0.25 (bf16)
    against Pallas, 1.0 against carve_rotate_ref. About 3e-5 of the
    samples differ from Pallas at all."""
    re, im, freq = carve_inputs(mode, in_dtype)
    jdt = jnp.dtype(in_dtype)
    xr, xi = jax_carve_rotate(jnp.asarray(re).astype(jdt), jnp.asarray(im).astype(jdt),
                              jnp.asarray(freq), mode=mode, interpret=True)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[in_dtype]
    args = (torch.from_numpy(re).to(tdt), torch.from_numpy(im).to(tdt), torch.from_numpy(freq),
            mode)
    tr, ti = carve_rotate_tables_ref(*args)
    assert tr.dtype == torch.bfloat16 and tuple(tr.shape) == xr.shape
    rr, ri = carve_rotate_ref(*args)
    ulps = bf16_ulps(tr.float().numpy(), ti.float().numpy(),
                     np.asarray(xr.astype(jnp.float32)), np.asarray(xi.astype(jnp.float32)))
    assert ulps.max() <= 1.0
    ulps = bf16_ulps(tr.float().numpy(), ti.float().numpy(), rr.float().numpy(),
                     ri.float().numpy())
    assert ulps.max() <= 1.0


@pytest.mark.parametrize("twin", [carve_rotate, carve_rotate_tables_ref])
def test_with_sum_is_the_bf16_sum(twin):
    """The third output is xr + xi as torch adds bf16, and the first two
    are those of the two-output call."""
    re, im, freq = carve_inputs(1, "bfloat16")
    args = (torch.from_numpy(re).to(torch.bfloat16), torch.from_numpy(im).to(torch.bfloat16),
            torch.from_numpy(freq))
    xr, xi, xs = twin(*args, with_sum=True)
    assert xs.dtype == torch.bfloat16 and torch.equal(xs, xr + xi)
    yr, yi = twin(*args)
    assert torch.equal(xr, yr) and torch.equal(xi, yi)


def test_demod_with_sum_equals_eager_add(monkeypatch):
    """demod_frames_split feeding the carve's xs to the first Karatsuba
    product gives the soft bits of the eager `ar + ai` it replaced."""
    from tpudab_torch.ofdm import demod
    re, im, freq = carve_inputs(1, "bfloat16")
    args = (torch.from_numpy(re).to(torch.bfloat16), torch.from_numpy(im).to(torch.bfloat16),
            torch.from_numpy(freq), demod.dft_operands(1, "bfloat16"), 1, 12, torch.bfloat16)
    soft, stats = demod.demod_frames_split(*args)
    p = get_ofdm_params(1)

    def eager_sum(*a, with_sum):
        xr, xi = carve_rotate(*a)
        ar = xr.view(xr.shape[0], p.nb_symbols, p.nb_fft)
        ai = xi.view(xi.shape[0], p.nb_symbols, p.nb_fft)
        return xr, xi, (ar + ai).view(xr.shape)
    monkeypatch.setattr(demod, "carve_rotate", eager_sum)
    old, old_stats = demod.demod_frames_split(*args)
    assert torch.equal(soft, old)
    for k in stats:
        assert torch.equal(stats[k], old_stats[k])

"""Parity of the port's carve + rotate (the plain twin of kernel K5) with
tpudab's Pallas carve kernel in interpret mode, and of its rotator tables."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.constants.ofdm_params import get_ofdm_params
from tpudab.ops.carve import carve_rotate as jax_carve_rotate
from tpudab_torch.ops.carve import carve_rotate, rotator_tables


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



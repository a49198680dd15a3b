"""The port's carve ablations (tpudab_torch/ops/carve_exp.py, X7) against
tpudab's tools/exp_carve.py::make_variant, whose pallas_call runs here in
interpret mode (the tool builds it without `interpret`, so the test patches
jax.experimental.pallas.pallas_call), on the CPU.

Inputs: 4 mode-I frames of f32 IQ made from a seed with numpy, and four
PLL frequencies. Tolerance: 1 bf16 ulp at each sample's magnitude where
the variant rotates (the two take cos/sin of the f32 phases in different
libraries); none where it does not (a cast copy). Also the kernel's tiling
(carve_tiling), which the CUDA kernel cannot show here, and the twin
against K5's tables twin and the no-rotate yardstick, bit for bit."""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_carve import bf16_ulps
from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.ops.carve import _windows, carve_rotate_ref, carve_rotate_tables_ref
from tpudab_torch.ops.carve_exp import (carve_tiling, carve_variant, carve_variant_cuda,
                                        carve_variant_ref)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 4
FREQ = np.array([1999.0, -2000.0, 0.0, 731.5], np.float32)


@functools.cache
def exp_carve():
    spec = importlib.util.spec_from_file_location(
        "tpudab_tool_exp_carve", os.path.join(ROOT, "tools", "exp_carve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def frames():
    p = get_ofdm_params(1)
    rng = np.random.default_rng(9)
    shape = (F, p.nb_frame_length // 128, 128)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("roll,rotate", [(True, True), (False, True), (True, False),
                                         (False, False)],
                         ids=["full", "no_roll", "no_rotate", "copy_only"])
def test_carve_variant_equals_tpudab(monkeypatch, roll, rotate):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    re, im = frames()
    run = exp_carve().make_variant(4, do_roll=roll, do_rotate=rotate)
    wr, wi = run(jnp.asarray(re), jnp.asarray(im), jnp.asarray(FREQ))
    xr, xi = carve_variant(torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(FREQ),
                           4, roll, rotate)
    assert xr.dtype == torch.bfloat16 and tuple(xr.shape) == wr.shape
    got = [v.float().numpy() for v in (xr, xi)]
    want = [np.asarray(v.astype(jnp.float32)) for v in (wr, wi)]
    if rotate:
        assert bf16_ulps(*got, *want).max() <= 1.0
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_full_variant_within_one_ulp_of_k5(in_dtype):
    """The full variant (angle addition) against K5's twin (the phase of
    each sample's absolute time), as chip_smoke.py holds the two kernels;
    fb does not change the result."""
    re, im = (torch.from_numpy(v).to(in_dtype) for v in frames())
    freq = torch.from_numpy(FREQ)
    xr, xi = carve_variant(re, im, freq, 8)
    rr, ri = carve_rotate_ref(re, im, freq)
    assert bf16_ulps(xr.float(), xi.float(), rr.float(), ri.float()).max() <= 1.0
    for fb in (1, 16):
        yr, yi = carve_variant_ref(re, im, freq, fb)
        assert torch.equal(yr, xr) and torch.equal(yi, xi)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_full_variant_twin_equals_tables_twin(in_dtype):
    """Roll and rotate on, the twin is K5's arithmetic (carve_rotate_tables_ref),
    bit for bit, at every fb."""
    re, im = (torch.from_numpy(v).to(in_dtype) for v in frames())
    freq = torch.from_numpy(FREQ)
    tr, ti = carve_rotate_tables_ref(re, im, freq)
    for fb in (1, 3, 8):
        xr, xi = carve_variant_ref(re, im, freq, fb)
        assert torch.equal(xr.view(torch.int16), tr.view(torch.int16))
        assert torch.equal(xi.view(torch.int16), ti.view(torch.int16))


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_no_rotate_twin_equals_library_yardstick(in_dtype):
    """No-rotate is .to(bfloat16) of ops/carve.py::_windows' strided view,
    the one torch call a plane that chip_smoke.py times beside it."""
    re, im = (torch.from_numpy(v).to(in_dtype) for v in frames())
    xr, xi = carve_variant_ref(re, im, 0.0, 8, rotate=False)
    for got, x in ((xr, re), (xi, im)):
        want = _windows(x.reshape(F, -1), 1, 12).to(torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.reshape(got.shape).view(torch.int16))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
@pytest.mark.parametrize("fb", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("f", [1, 5, 256])
def test_tiling_covers_each_window_once(f, fb, mode):
    """Every (frame, symbol) in exactly one block, and no block that
    carves nothing or reaches past the frames or the symbols, with the
    block's ranges computed as csrc/carve.cu::carve_kernel does."""
    n_sym = get_ofdm_params(mode).nb_symbols
    per, (gx, gy) = carve_tiling(f, fb, n_sym)
    assert gy <= 65535
    seen = np.zeros((f, n_sym), np.int64)
    for x in range(gx):
        f0 = x * fb
        f1 = min(f, f0 + fb)
        assert f0 < f1
        for y in range(gy):
            s0 = y * per
            s1 = min(n_sym, s0 + per)
            assert s0 < s1
            seen[f0:f1, s0:s1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("fb", [4, 8, 16])
def test_tiling_keeps_blocks_near_k5(fb):
    """At the tool's 256 frames: at least 4 blocks an SM (132 SMs), and a
    block's windows within 2x of K5's one frame x 19 symbols."""
    per, (gx, gy) = carve_tiling(256, fb, 76)
    assert carve_tiling(256, 1, 76) == (19, (256, 4))
    assert gx * gy >= 4 * 132
    assert 19 <= fb * per <= 2 * 19


def test_wrapper_refuses_what_the_kernel_does_not_take():
    re, im = (torch.from_numpy(v) for v in frames())
    with pytest.raises(ValueError, match="CUDA"):
        carve_variant_cuda(re, im, 0.0)
    for fb in (0, -1):
        with pytest.raises(ValueError, match="fb"):
            carve_tiling(4, fb, 76)
        with pytest.raises(ValueError, match="fb"):
            carve_variant(re, im, 0.0, fb)


def test_tool_main_rehearses_on_cpu(capsys):
    from tpudab_torch.tools.exp_carve import run
    res = run(torch.device("cpu"), 1, 2)
    out = capsys.readouterr().out
    assert len(res["ms"]) == 8 and "copy-only" in out and "host times" in out
    assert "yardstick" in out

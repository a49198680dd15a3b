"""The port's carve ablations (tpudab_torch/ops/carve_exp.py, X7) against
tpudab's tools/exp_carve.py::make_variant, whose pallas_call runs here in
interpret mode (the tool builds it without `interpret`, so the test patches
jax.experimental.pallas.pallas_call), on the CPU.

Inputs: 4 mode-I frames of f32 IQ made from a seed with numpy, and four
PLL frequencies. Tolerance: 1 bf16 ulp at each sample's magnitude where
the variant rotates (the two take cos/sin of the f32 phases in different
libraries); none where it does not (a cast copy)."""

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
from tpudab_torch.ops.carve import carve_rotate_ref
from tpudab_torch.ops.carve_exp import carve_variant, carve_variant_ref

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


def test_tool_main_rehearses_on_cpu(capsys):
    from tpudab_torch.tools.exp_carve import run
    res = run(torch.device("cpu"), 1, 2)
    out = capsys.readouterr().out
    assert len(res["ms"]) == 7 and "copy-only" in out and "host times" in out

"""The port's Viterbi kernel experiments (tpudab_torch/ops/viterbi_exp.py,
ops/i16_probe.py and the tools in tpudab_torch/tools/) against tpudab's
TPU tools, on the CPU.

tpudab's tools build pl.pallas_call without `interpret`, so each test
that runs one patches jax.experimental.pallas.pallas_call to interpret
mode and calls the tool's own run_variant / run_dbuf / run_gmm4 / run_i16
/ fwd_wide / fwd_t / tb_t, loaded from tools/ by file path.
exp_tb_tree.py and exp_i16_probe.py do their work at import, so this file
carries copies of their kernel bodies and probe lambdas instead.

Inputs: integer-valued soft bits in [-127, 127] made from a seed with
numpy, so every sum is exact whatever the order or rebase; B = 128
codewords, T = 256 mother steps (4 chunks of 32 super-steps), one 128-lane
tile. Tolerance: none, decisions and bytes equal after transposing the
port's (B, T2p/4, 64) to tpudab's (T2p/4, 64, B), except X3's int16
decisions against the f32 kernel's in the first group (see
tpudab_torch/tools/exp_viterbi_i16.py).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.fec.conv import N_STATES
from tpudab.ops.viterbi_pallas import _K, _fwd_decisions
from tpudab_torch.ops import i16_probe as pprobe
from tpudab_torch.ops.viterbi_cuda import signs_on
from tpudab_torch.ops.viterbi_exp import forward_decisions, fwd_variant, traceback_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, BT, CHUNK = 128, 256, 128, 32
SIGNS = signs_on(torch.device("cpu"))


@functools.cache
def tool(name):
    """tools/<name>.py, loaded by file path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(f"tpudab_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every pl.pallas_call of tpudab's tools runs in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def int_mother(seed, b=B, t=T):
    return np.random.default_rng(seed).integers(-127, 128, (b, t, 4)).astype(np.float32)


def transposed(mother):
    """(B, T, 4) -> tpudab's and the port's (T/2, 8, B)."""
    b = mother.shape[0]
    return np.ascontiguousarray(np.moveaxis(mother.reshape(b, -1, 8), 0, 2))


def as_tpudab(decs):
    """The port's (B, G, 64) decisions -> tpudab's (G, 64, B) as numpy."""
    return decs.permute(1, 2, 0).numpy()


def tpudab_variant(name, soft_t):
    """Decisions of tpudab's X2 kernel `name` on soft_t (numpy (T2, 8, B))."""
    dec = tool("exp_viterbi_decompose")
    flags = {"full": (True, True, True), "nodec": (True, False, True),
             "noacs": (False, True, True), "bmonly": (False, False, True)}
    x = jnp.asarray(soft_t)
    if name in flags:
        fn, args = dec.run_variant(dec._variant_kernel(*flags[name]), x, b_tile=BT)
    elif name == "prefetch":
        fn, args = dec.run_variant(dec._prefetch_kernel, x, b_tile=BT)
    elif name == "dbuf":
        fn, args = dec.run_dbuf(x, b_tile=BT)
    elif name == "dbuf_bf16":
        fn, args = dec.run_dbuf(x, b_tile=BT, sdt=jnp.bfloat16)
    else:
        fn, args = dec.run_gmm4(x, b_tile=BT)
    return np.asarray(fn(*args))


@pytest.mark.parametrize("name", ["full", "nodec", "noacs", "bmonly", "prefetch", "dbuf",
                                  "dbuf_bf16", "gmm4"])
def test_forward_variant_equals_tpudab(interpret, name):
    """X2: each forward variant's decisions equal tpudab's kernel's."""
    soft_t = transposed(int_mother(1))
    x = torch.from_numpy(soft_t)
    variant = name
    if name == "dbuf_bf16":
        x, variant = x.to(torch.bfloat16), "dbuf"
    got, _ = fwd_variant(x, SIGNS, variant, rebase=CHUNK)
    np.testing.assert_array_equal(as_tpudab(got), tpudab_variant(name, soft_t))


def test_tpudab_noacs_is_bmonly(interpret):
    """tpudab's _variant_kernel returns before do_dec is read when do_acs
    is off, so its noacs and bmonly are one kernel (a finding in tpudab's
    tool, not the port's): the decisions are identical."""
    soft_t = transposed(int_mother(2))
    np.testing.assert_array_equal(tpudab_variant("noacs", soft_t),
                                  tpudab_variant("bmonly", soft_t))


def test_variant_path_metrics():
    """The port's own (B, 64) path-metric output: every variant that runs
    the ACS chain ends at the same metrics; noacs, with no recursion, ends
    at the running max of the start values and the branch metrics of
    j = 2, 3 (those the decisions do not read), here computed in numpy."""
    x = torch.from_numpy(transposed(int_mother(3)))
    pms = {v: fwd_variant(x, SIGNS, v, CHUNK)[1] for v in ("full", "nodec", "prefetch",
                                                            "dbuf", "gmm4")}
    for v, pm in pms.items():
        assert torch.equal(pm, pms["full"]), v
    start = np.full((N_STATES,), -1e9)
    start[0] = 0.0
    bm = np.einsum("ir,tib->trb", SIGNS.numpy().astype(np.float64), x.numpy().astype(np.float64))
    m23 = bm[:, 2 * N_STATES:].reshape(bm.shape[0], 2, N_STATES, B).max(axis=(0, 1))
    want = np.maximum(start[:, None], m23).T.astype(np.float32)
    np.testing.assert_array_equal(fwd_variant(x, SIGNS, "noacs", CHUNK)[1].numpy(), want)


def test_wide_equals_tpudab(interpret):
    """X1: fwd_wide (flush-padded (B, T, 4) input) equals tpudab's
    _fwd_kernel_wide and its base forward."""
    mother = int_mother(4, t=T - 6)
    want = np.asarray(tool("exp_viterbi").fwd_wide(jnp.asarray(mother), chunk=CHUNK, b_tile=BT))
    base = np.asarray(_fwd_decisions(jnp.asarray(mother), CHUNK, BT, True)[0])
    np.testing.assert_array_equal(want, base)
    from tpudab_torch.tools.exp_viterbi import fwd_wide
    np.testing.assert_array_equal(as_tpudab(fwd_wide(torch.from_numpy(mother))), want)
    np.testing.assert_array_equal(
        as_tpudab(forward_decisions(torch.from_numpy(mother), SIGNS, CHUNK)[0]), base)


def test_int16_equals_tpudab_and_f32_from_group_1(interpret):
    """X3: the int16 kernel equals tpudab's; against the f32 kernel on the
    same integer soft bits it differs in group 0 only (f32's -1e9 start
    rounds branch metrics of unreachable states to multiples of 64)."""
    from tpudab_torch.tools.exp_viterbi_i16 import run_i16
    mother = int_mother(5, t=T - 6)
    soft16 = transposed(np.concatenate([mother, np.ones((B, 6, 4), np.float32)], 1)
                        ).astype(np.int16)
    fn, args = tool("exp_viterbi_i16").run_i16(jnp.asarray(soft16), b_tile=BT)
    want = np.asarray(fn(*args))
    pfn, pargs = run_i16(torch.from_numpy(soft16))
    got = as_tpudab(pfn(*pargs))
    np.testing.assert_array_equal(got, want)
    f32 = np.asarray(_fwd_decisions(jnp.asarray(mother), CHUNK, BT, True)[0])
    np.testing.assert_array_equal(got[1:], f32[1:])
    assert not np.array_equal(got[0], f32[0])


def test_fwd_t_equals_tpudab(interpret):
    """X6: fwd_t on bf16 (T2p, 8, B), rebase every 16, equals tpudab's."""
    from tpudab_torch.tools.exp_depunct_t import fwd_t
    soft_t = transposed(int_mother(6))
    xj = jnp.asarray(soft_t).astype(jnp.bfloat16)
    want = np.asarray(tool("exp_depunct_t").fwd_t(xj, b_tile=BT, chunk=16, interpret=True))
    got = fwd_t(torch.from_numpy(soft_t).to(torch.bfloat16), chunk=16)
    np.testing.assert_array_equal(as_tpudab(got), want)


# tools/exp_tb_tree.py:14-37, the pre-r5 production traceback (a masked
# reduction over the 64 sublanes), and :42-69, the select tree; copied
# because that tool runs at import.
def _tb_kernel_masked(dec_ref, out_ref, state_ref):
    n_groups = dec_ref.shape[0]
    b_t = dec_ref.shape[2]

    @pl.when(pl.program_id(1) == 0)
    def _():
        state_ref[:] = jnp.zeros((1, b_t), jnp.int32)

    row = jax.lax.broadcasted_iota(jnp.int32, (N_STATES, b_t), 0)

    def group(i, state):
        gb = n_groups - 1 - i
        dec_b = dec_ref[gb].astype(jnp.int32)
        acc = jnp.zeros((1, b_t), jnp.int32)
        for q in range(3, -1, -1):
            dec_t = (dec_b >> (6 - 2 * q)) & 3
            hit = row == state
            j = jnp.sum(jnp.where(hit, dec_t, 0), axis=0, keepdims=True)
            acc = acc | ((state & 3) << (6 - 2 * q))
            state = (state >> _K) | (j << (6 - _K))
        out_ref[gb] = acc.astype(jnp.uint8)
        return state

    state_ref[:] = lax.fori_loop(0, n_groups, group, state_ref[:])


def _tb_kernel_tree(dec_ref, out_ref, state_ref):
    n_groups = dec_ref.shape[0]
    b_t = dec_ref.shape[2]

    @pl.when(pl.program_id(1) == 0)
    def _():
        state_ref[:] = jnp.zeros((1, b_t), jnp.int32)

    def group(i, state):
        gb = n_groups - 1 - i
        dec_b = dec_ref[gb].astype(jnp.int32)              # (64, B_t)
        acc = jnp.zeros((1, b_t), jnp.int32)
        for q in range(3, -1, -1):
            v = dec_b
            for k in range(5, -1, -1):
                half = v.shape[0] // 2
                bit = ((state >> k) & 1) > 0               # (1, B_t) bool
                v = jnp.where(bit, v[half:], v[:half])
            j = (v >> (6 - 2 * q)) & 3                      # (1, B_t)
            acc = acc | ((state & 3) << (6 - 2 * q))
            state = (state >> _K) | (j << (6 - _K))
        out_ref[gb] = acc.astype(jnp.uint8)
        return state

    state_ref[:] = lax.fori_loop(0, n_groups, group, state_ref[:])


def run_tb(kernel, decs):
    """tools/exp_tb_tree.py::run_tb, interpreted: (G, 64, B) -> (B, G)."""
    g, _, b = decs.shape
    out = pl.pallas_call(
        kernel, grid=(b // BT, g // (CHUNK // 4)),
        in_specs=[pl.BlockSpec((CHUNK // 4, N_STATES, BT),
                               lambda j, i: (pl.num_programs(1) - 1 - i, 0, j),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((CHUNK // 4, 1, BT),
                               lambda j, i: (pl.num_programs(1) - 1 - i, 0, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((g, 1, b), jnp.uint8),
        scratch_shapes=[pltpu.VMEM((1, BT), jnp.int32)], interpret=True)(decs)
    return np.asarray(out)[:, 0, :].T


@pytest.mark.parametrize("mode", ["shuffle", "masked", "tree"])
def test_traceback_modes_equal_tpudab(interpret, mode):
    """X5 and X2's tbonly / X6's tb_t: each traceback mode's bytes equal
    tpudab's pre-r5 masked reduction, its select tree and its r5
    _tb_kernel_packed (through exp_depunct_t.tb_t), on the decisions of
    tpudab's forward pass over Gaussian soft bits."""
    rng = np.random.default_rng(7)
    mother = rng.standard_normal((B, T - 6, 4)).astype(np.float32)
    decs = _fwd_decisions(jnp.asarray(mother), CHUNK, BT, True)[0]
    masked = run_tb(_tb_kernel_masked, decs)
    np.testing.assert_array_equal(run_tb(_tb_kernel_tree, decs), masked)
    r5 = np.asarray(tool("exp_depunct_t").tb_t(decs, b_tile=BT, chunk=16, interpret=True))
    np.testing.assert_array_equal(r5, masked)
    port_decs = torch.from_numpy(np.array(decs)).permute(2, 0, 1).contiguous()
    np.testing.assert_array_equal(traceback_bytes(port_decs, mode).numpy(), masked)
    assert torch.equal(traceback_bytes(port_decs, mode, n_out=5), traceback_bytes(port_decs)[:, :5])


# tools/exp_i16_probe.py:22-34, the probe lambdas; copied because that tool
# runs at import.
PROBES = {
    "add": lambda x, y: x + y,
    "max": lambda x, y: jnp.maximum(x, y),
    "mul": lambda x, y: x * y,
    "shift_right_logical": lambda x, y: jax.lax.shift_right_logical(x, jnp.int16(15)),
    "shift_right_arith": lambda x, y: jax.lax.shift_right_arithmetic(x, jnp.int16(15)),
    "and/or": lambda x, y: (x & y) | x,
    "compare_gt": lambda x, y: (x > y).astype(jnp.int16),
    "select_by_signshift": lambda x, y: jnp.where(
        (jax.lax.shift_right_logical(x - y, jnp.int16(15))) > 0, x, y),
    "sub": lambda x, y: x - y,
    "repeat": lambda x, y: jnp.repeat(x[0:16], 4, axis=0),
    "i16_to_u8": lambda x, y: (x & 3).astype(jnp.uint8).astype(jnp.int16),
    "bcast_1row": lambda x, y: x[0:1, :] + y,
    "bcast_1col_x_1row": lambda x, y: x[:, 0:1] * y[0:1, :],
}


@pytest.mark.parametrize("op", list(PROBES))
def test_i16_probe_equals_tpudab(op):
    """X4: each op's twin equals the tool's probe kernel body, run as a
    pallas_call in interpret mode, on the tool's inputs and on inputs
    that wrap (the full int16 range)."""
    from tpudab_torch.tools.exp_i16_probe import inputs
    assert list(pprobe.OPS) == list(PROBES)

    def kernel(x_ref, y_ref, o_ref):
        o_ref[:] = PROBES[op](x_ref[:], y_ref[:])

    rng = np.random.default_rng(8)
    wide = [torch.from_numpy(rng.integers(-32768, 32768, (64, 256)).astype(np.int16))
            for _ in range(2)]
    for x, y in (inputs("cpu"), wide):
        want = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((64, 256), jnp.int16),
                              interpret=True)(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
        got = pprobe.i16_probe(x, y, op)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,size", [
    ("exp_viterbi_decompose", (4, 200)),
    ("exp_viterbi", (4, 58)),
    ("exp_viterbi_i16", (4, 58)),
    ("exp_tb_tree", (4, 58)),
    ("exp_depunct_t", (2,)),
    ("exp_i16_probe", None),
])
def test_tool_main_rehearses_on_cpu(name, size, capsys):
    """Each tool's work runs end to end on the CPU (the plain twins, host
    times) at a small size, and its checks hold: run() at that size, or
    main itself with --device cpu where the tool is small already."""
    mod = importlib.import_module(f"tpudab_torch.tools.{name}")
    cpu = torch.device("cpu")
    res = mod.main(["--device", "cpu"]) if size is None else mod.run(cpu, 1, *size)
    out = capsys.readouterr().out
    assert res["checks"] and all(res["checks"].values()) and "host times" in out
    assert "False" not in out.replace("identical to production: False", "") \
        .replace("identical to f32 kernel: False", "")
    if name == "exp_i16_probe":
        assert out.count(" OK") == 13
    if name == "exp_viterbi_decompose":
        assert "before the pad (groups < 25): True" in out and "Decomposition" in out
        assert set(res["ms"]) == {"dbuf", "dbuf_bf16", "full", "nodec", "noacs", "bmonly",
                                  "tbonly", "e2e"}


@pytest.mark.parametrize("name", ["exp_viterbi_decompose", "exp_viterbi", "exp_viterbi_i16",
                                  "exp_tb_tree", "exp_depunct_t", "exp_carve"])
def test_tool_main_runs_at_its_shapes(name, monkeypatch):
    """main parses [iters] and --device, as tpudab's tools take iters, and
    hands them to run() with the tool's own shapes (run's defaults)."""
    mod = importlib.import_module(f"tpudab_torch.tools.{name}")
    seen = []
    monkeypatch.setattr(mod, "run", lambda *a: seen.append(a) or {"ms": {}, "checks": {}})
    mod.main(["3", "--device", "cpu"])
    assert seen == [(torch.device("cpu"), 3)]
    with pytest.raises(SystemExit):
        mod.main(["3", "--batch", "4"])


@pytest.mark.parametrize("dtype,rebase", [(torch.float32, 8), (torch.bfloat16, 4),
                                          (torch.int16, 16)])
def test_forward_variant_rejects_unbuilt_rebase(dtype, rebase):
    """The kernel is built for f32/bf16 rebased every 16 or 32 super-steps
    and int16 every 4 (the tools' chunks); the twin takes the same inputs,
    so another interval is refused on either device."""
    x = torch.zeros((32, 8, 2), dtype=dtype)
    with pytest.raises(ValueError, match="rebase"):
        fwd_variant(x, SIGNS, "full", rebase)

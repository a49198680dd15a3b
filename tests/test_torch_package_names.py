"""Every name that a tpudab package's __init__ exports resolves in the
port's counterpart package (tpudab.fec -> tpudab_torch.fec, ...), apart
from the names that ROADMAP.md's "Covered, not ported" list gives a
reason for: tpudab.ofdm.sync's complex-jnp acquire and its helpers, the
XLA scan viterbi_decode and its numpy twin viterbi_decode_np, the matmul
FFT and the jnp bit packers. Also the ACS predecessor tables PRED0/PRED1
of tpudab.fec.conv, equal in the port."""

import ast
import importlib
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXEMPT = {
    "tpudab.ofdm": {"acquire", "estimate_null_start", "fine_time_sync",
                    "coarse_freq_estimate", "fine_freq_estimate"},
    "tpudab.ops": {"viterbi_decode", "viterbi_decode_np"},
}
EXEMPT_PATTERNS = ("matfft", "jnp_")


def exported(init: pathlib.Path):
    """The names an __init__.py imports at its top level."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


PACKAGES = sorted(".".join(p.parent.relative_to(ROOT).parts)
                  for p in (ROOT / "tpudab").glob("**/__init__.py"))


def test_every_package_has_a_counterpart():
    assert "tpudab" in PACKAGES and "tpudab.fec" in PACKAGES
    for pkg in PACKAGES:
        importlib.import_module("tpudab_torch" + pkg[len("tpudab"):])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_names_resolve_in_the_port(pkg):
    names = exported(ROOT.joinpath(*pkg.split("."), "__init__.py"))
    ref = importlib.import_module(pkg)
    port = importlib.import_module("tpudab_torch" + pkg[len("tpudab"):])
    missing = []
    for name in names:
        assert hasattr(ref, name), (pkg, name)
        if name in EXEMPT.get(pkg, ()) or name.startswith(EXEMPT_PATTERNS):
            continue
        if not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{pkg}: {missing}"


def test_exemptions_are_still_needed():
    """An exempt name that the port gains leaves the list."""
    for pkg, names in EXEMPT.items():
        port = importlib.import_module("tpudab_torch" + pkg[len("tpudab"):])
        assert not [n for n in names if hasattr(port, n)], pkg


def test_pred_tables_equal():
    from tpudab.fec import conv as jconv
    from tpudab_torch.fec import conv as tconv
    from tpudab_torch.fec import PRED0, PRED1
    for ours, theirs in ((tconv.PRED0, jconv.PRED0), (tconv.PRED1, jconv.PRED1)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    assert PRED0 is tconv.PRED0 and PRED1 is tconv.PRED1

"""`correct` comes out false where it should: for the control (the
reference in a lower precision, in the program's place) and with the
timed path broken underneath, once for each fault a cell can have."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import run_tiny, tiny_cell

SEED = 2 ** 31 + 29


@pytest.mark.parametrize("name", ["bench6.ens32x16", "bench6.decode1"])
def test_control_fails(name):
    cell = tiny_cell(name)
    readings = harness.driver_module(cell).control(cell, SEED)
    assert any(v > cell.limits[k] for k, v in readings.items()), readings


def _broken(monkeypatch, fault):
    from tpudab_torch.models.step import ReceiveStep

    forward = ReceiveStep.forward

    def broken(self, carry, re, im, freq):
        new, out = forward(self, carry, re, im, freq)
        return fault(self, carry, new, out)
    monkeypatch.setattr(ReceiveStep, "forward", broken)


def _state_unchanged(self, carry, new, out):
    return carry, out


def _half_batch(self, carry, new, out):
    """Ensemble 1 of 2 left out: its outputs those of ensemble 0, its mean
    power the mean over the rest."""
    out = dict(out)
    out["fic_bytes"] = out["fic_bytes"][:1].expand_as(out["fic_bytes"]).clone()
    out["subch"] = {k: v[:1].expand_as(v).clone() for k, v in out["subch"].items()}
    mp = out["mean_power"].reshape(2, -1)
    out["mean_power"] = mp[:1].expand_as(mp).reshape(-1).clone()
    return new, out


def _answer_altered(self, carry, new, out):
    out = dict(out)
    sid = min(out["subch"])
    v = out["subch"][sid].clone()
    v.view(-1)[-1] ^= 0x40
    out["subch"] = {**out["subch"], sid: v}
    return new, out


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_step_faults(monkeypatch, fault):
    _broken(monkeypatch, fault)
    result, checks = run_tiny(tiny_cell("bench6.ens32x16"), seed=SEED)
    assert not result["correct"], checks


def _frame_altered(self, carry, new, out):
    """A decoded logical frame altered past what the superframe's RS code
    corrects: every byte of each step's first row of the first subchannel."""
    out = dict(out)
    sid = min(out["subch"])
    v = out["subch"][sid].clone()
    v[..., 0, :] ^= 0x40
    out["subch"] = {**out["subch"], sid: v}
    return new, out


def test_decode_answer_altered(monkeypatch):
    _broken(monkeypatch, _frame_altered)
    result, checks = run_tiny(tiny_cell("bench6.decode1"), seed=SEED)
    assert not result["correct"] and checks["aus_wrong"][0] > 0, checks


def test_decode_carrier_offset():
    """Acquisition's net frequency one carrier spacing off."""
    from benchmark import calibrate

    cell = tiny_cell("bench6.decode1")
    with calibrate.carrier(harness.driver_module(cell), cell):
        result, checks = run_tiny(cell, seed=SEED)
    assert not result["correct"] and checks["net_freq_gap_hz"][0] > 900, checks

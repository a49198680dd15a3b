"""Checkpoint/resume and the config file: the port's against tpudab's.

- The port's pipeline_checkpoint/pipeline_restore: a capture split across
  two pipelines decodes to the bytes of one run, bit for bit
  (tests/test_host_wiring.py:147-183).
- tpudab's checkpoint resumed by the port: tpudab decodes the first half
  and checkpoints (an f32 carry); the port restores it (cast to its bf16
  step) and decodes the rest; the bytes equal tpudab's one-shot run.
- save_carry/load_carry round-trip a bf16 carry bit for bit (stored as
  its int16 view) and an f32 one; the files hold tpudab's keys and fields.
- RadioConfig/ConfigManager JSON files are interchangeable with tpudab's.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_pipeline import eep_capture
from tpudab.host.config import ConfigManager as JaxConfigManager
from tpudab.host.config import RadioConfig as JaxRadioConfig
from tpudab.models.checkpoint import pipeline_checkpoint as jax_checkpoint
from tpudab.models.checkpoint import pipeline_restore as jax_restore
from tpudab.models.pipeline import OfflinePipeline as JaxPipeline
from tpudab.models.receiver import Receiver as JaxReceiver
from tpudab_torch.host.config import ConfigManager, RadioConfig
from tpudab_torch.models.checkpoint import (load_carry, pipeline_checkpoint, pipeline_restore,
                                            save_carry)
from tpudab_torch.models.pipeline import OfflinePipeline
from tpudab_torch.models.receiver import Receiver

FRAME_LEN = 196608
N_FRAMES, SPLIT = 10, 5


def read_json(path):
    with open(path) as f:
        return json.load(f)


def collect_run(pipe, iq):
    chunks = []
    pipe.run(iq, collect=lambda outs: chunks.extend(
        o.raw_frames for o in outs.values() if o.raw_frames is not None and len(o.raw_frames)))
    return np.concatenate(chunks) if chunks else np.zeros((0, 96), np.uint8)


def port_pipeline():
    return OfflinePipeline(batch_frames=4, use_device_step=True,
                           receiver=Receiver(1, "cpu", decode_audio=False))


def jax_pipeline():
    return JaxPipeline(batch_frames=4, use_device_step=True,
                       receiver=JaxReceiver(decode_audio=False))


@pytest.fixture(scope="module")
def capture():
    return eep_capture(N_FRAMES)


@pytest.fixture(scope="module")
def one_shot(capture):
    """tpudab's one-shot run and the port's, which must agree."""
    iq, payloads = capture
    want = collect_run(jax_pipeline(), iq)
    got = collect_run(port_pipeline(), iq)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want[1:], payloads[3][1: want.shape[0]])
    assert want.shape[0] == 4 * N_FRAMES - 15
    return want


def test_port_checkpoint_resume_bit_exact(capture, one_shot, tmp_path):
    iq, _ = capture
    ckpt = str(tmp_path / "state")
    a = port_pipeline()
    got_a = collect_run(a, iq[: 777 + SPLIT * FRAME_LEN])
    pipeline_checkpoint(a, ckpt)
    extra = read_json(ckpt + ".json")
    assert extra["carry_dtype"] == "bfloat16" and extra["next_pos"] == a.stats.next_pos
    with np.load(ckpt + ".npz") as f:
        assert f.files == ["deint_3"] and f["deint_3"].dtype == np.int16

    b = port_pipeline()
    pipeline_restore(b, ckpt)
    assert b._driver.step is not None        # the step is rebuilt before the first batch
    assert torch.equal(b._driver.carry["deint_3"].view(torch.int16),
                       a._driver.carry["deint_3"].view(torch.int16))
    assert b._driver.first_logical == a._driver.first_logical
    got_b = collect_run(b, iq[a.stats.next_pos:])
    np.testing.assert_array_equal(np.concatenate([got_a, got_b]), one_shot)


def test_tpudab_checkpoint_resumed_by_port(capture, one_shot, tmp_path):
    iq, _ = capture
    ckpt = str(tmp_path / "tpudab_state")
    a = jax_pipeline()
    got_a = collect_run(a, iq[: 777 + SPLIT * FRAME_LEN])
    jax_checkpoint(a, ckpt)
    extra = read_json(ckpt + ".json")
    assert "carry_dtype" not in extra
    with np.load(ckpt + ".npz") as f:
        assert f["deint_3"].dtype == np.float32       # tpudab's promoted f32 carry

    b = port_pipeline()
    pipeline_restore(b, ckpt)
    assert b._driver.carry["deint_3"].dtype == torch.bfloat16
    assert b._driver.first_logical == a._driver.first_logical
    assert b.stats.net_freq_hz == a.stats.net_freq_hz
    got_b = collect_run(b, iq[a.stats.next_pos:])
    np.testing.assert_array_equal(np.concatenate([got_a, got_b]), one_shot)


def test_restore_without_json_acquires_like_tpudab(capture, one_shot, tmp_path):
    """A checkpoint whose .json is gone restores only the carry: the next
    run acquires time and frequency as a fresh one does, as tpudab's does,
    and decodes the rest of the capture to tpudab's bytes (host leg)."""
    iq, _ = capture
    ckpt = str(tmp_path / "state")
    a = port_pipeline()
    collect_run(a, iq[: 777 + SPLIT * FRAME_LEN])
    pipeline_checkpoint(a, ckpt)
    Path(ckpt + ".json").unlink()
    b = OfflinePipeline(batch_frames=4, receiver=Receiver(1, "cpu", decode_audio=False))
    j = JaxPipeline(batch_frames=4, receiver=JaxReceiver(decode_audio=False))
    pipeline_restore(b, ckpt)
    jax_restore(j, ckpt)
    assert not b._resumed and not j._resumed
    assert b._driver.carry["deint_3"].dtype == torch.bfloat16
    rest = iq[a.stats.next_pos:]
    got, want = collect_run(b, rest), collect_run(j, rest)
    assert got.shape[0] > 0 and b.stats.frame_start == j.stats.frame_start
    np.testing.assert_array_equal(got, want)


def test_checkpoint_keys_and_fields_equal_tpudab(capture, tmp_path):
    """Both packages' checkpoints of the same first half hold the same .npz
    keys and the same JSON fields and values (the port adds
    carry_dtype; the frequencies agree within 1 Hz)."""
    iq, _ = capture
    head = iq[: 777 + SPLIT * FRAME_LEN]
    a, j = port_pipeline(), jax_pipeline()
    a.run(head)
    j.run(head)
    pipeline_checkpoint(a, str(tmp_path / "port"))
    jax_checkpoint(j, str(tmp_path / "jax"))
    got = read_json(tmp_path / "port.json")
    want = read_json(tmp_path / "jax.json")
    assert got.pop("carry_dtype") == "bfloat16"
    assert abs(got.pop("net_freq_hz") - want.pop("net_freq_hz")) < 1.0
    assert got == want
    with np.load(tmp_path / "port.npz") as g, np.load(tmp_path / "jax.npz") as w:
        assert g.files == w.files
        for k in w.files:
            assert g[k].shape == w[k].shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_carry_round_trip_bit_exact(dtype, tmp_path):
    """Every bit pattern survives: NaN payloads, infinities, signed zeros,
    subnormals, and the extra dict comes back with carry_dtype added."""
    rng = np.random.default_rng(5)
    width = {torch.bfloat16: np.int16, torch.float32: np.int32}[dtype]
    bits = rng.integers(np.iinfo(width).min, np.iinfo(width).max, (15, 1536), dtype=width)
    bits[0, :4] = np.array([0, -1, 1, np.iinfo(width).min], width)
    carry = {"deint_1": torch.from_numpy(bits).view(dtype),
             "deint_9": torch.from_numpy(bits[::-1].copy()).view(dtype)}
    save_carry(str(tmp_path / "c.npz"), carry, {"note": 1})
    back, extra = load_carry(str(tmp_path / "c"), "cpu")
    assert extra == {"note": 1, "carry_dtype": str(dtype)[6:]}
    assert set(back) == set(carry)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for k, v in carry.items():
        assert back[k].dtype == dtype
        assert torch.equal(back[k].view(view), v.view(view))


def test_load_carry_defaults_to_the_card(tmp_path, monkeypatch):
    """Like every entry point of the port, load_carry runs on the card
    unless "cpu" is passed: with no card, the default raises."""
    save_carry(str(tmp_path / "c"), {"deint_1": torch.zeros((15, 16))})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_carry(str(tmp_path / "c"))
    assert load_carry(str(tmp_path / "c"), "cpu")[0]["deint_1"].device.type == "cpu"


def test_save_carry_refuses_mixed_dtypes(tmp_path):
    carry = {"deint_1": torch.zeros((15, 16)), "deint_2": torch.zeros((15, 16), dtype=torch.bfloat16)}
    with pytest.raises(TypeError, match="carry dtypes"):
        save_carry(str(tmp_path / "c"), carry)


def test_config_json_interchangeable_with_tpudab(tmp_path):
    assert dataclasses.asdict(RadioConfig()) == dataclasses.asdict(JaxRadioConfig())
    assert dataclasses.asdict(RadioConfig().sync_config()) == \
        dataclasses.asdict(JaxRadioConfig().sync_config())
    # tpudab writes, the port reads
    path = str(tmp_path / "radio.json")
    JaxConfigManager(path).set(global_gain=2.5, batch_frames=2, window_offset=10,
                               channel="12C", is_coarse_freq_correction=False)
    mine = ConfigManager(path)
    assert dataclasses.asdict(mine.config) == dataclasses.asdict(JaxConfigManager(path).config)
    assert mine.config.sync_config().window_offset == 10
    # the port writes (autosave), tpudab reads, byte-equal files
    mine.set(desync_threshold=0.5, mode=2)
    theirs = JaxConfigManager(path)
    assert dataclasses.asdict(theirs.config) == dataclasses.asdict(mine.config)
    port_text = Path(path).read_text()
    theirs.save()
    assert Path(path).read_text() == port_text
    with pytest.raises(AttributeError):
        mine.set(not_a_key=1)
    # a corrupt file falls back to the defaults, as tpudab's does
    Path(path).write_text("{not json")
    assert ConfigManager(path).config == RadioConfig()

"""The port's one launch path for its ctypes kernels
(tpudab_torch/ops/_build.py::launch), on the CPU: the C entry point is a
recording stand-in, and torch's current-device and raw-stream queries are
stubbed, so what launch hands the entry point and when it enters a device
guard can be seen without a card."""

import contextlib
import pathlib

import pytest
import torch

from tpudab_torch.ops import _build

PKG = pathlib.Path(_build.__file__).resolve().parent.parent


@pytest.fixture
def fake_cuda(monkeypatch):
    """Device 0 current, stream handle 1000 + device; records each device
    guard entered."""
    guards = []

    @contextlib.contextmanager
    def device(index):
        guards.append(index)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    return guards


def recorder(err=0):
    calls = []

    def fn(*args):
        calls.append(args)
        return err
    return fn, calls


def test_launch_on_the_current_device_enters_no_guard(fake_cuda):
    """Pointers and ints pass as they are, None for a null pointer, and the
    current stream's raw handle goes last."""
    fn, calls = recorder()
    _build.launch(fn, 0, "probe", 0x7f00, None, 3)
    assert calls == [(0x7f00, None, 3, 1000)] and fake_cuda == []


def test_launch_on_another_device_enters_its_guard(fake_cuda):
    fn, calls = recorder()
    _build.launch(fn, 1, "probe", 5)
    assert calls == [(5, 1001)] and fake_cuda == [1]


def test_launch_raises_on_a_cuda_error(fake_cuda):
    fn, _ = recorder(err=9)
    with pytest.raises(RuntimeError, match="probe kernel launch failed: CUDA error 9"):
        _build.launch(fn, 0, "probe")


def test_wrappers_launch_through_the_one_path():
    """No module of the port builds its own ctypes pointers, stream object
    or device guard around a kernel call: that is launch()'s work."""
    for path in sorted(PKG.rglob("*.py")):
        if path.name == "_build.py":
            continue
        src = path.read_text()
        for banned in ("c_void_p(", "torch.cuda.device(", "current_stream().cuda_stream"):
            assert banned not in src, f"{path.relative_to(PKG)}: {banned}"

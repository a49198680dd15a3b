"""rtl_sdr's raw u8 IQ on the receive step's path: the step on u8 frames
against the step on their f32 conversion, K5's and stats_kernel's u8 twins
against their f32 twins, mean_power and the tap against the plain float64
reference (benchmark/reference_u8.py), and HostFeed (models/ingest.py)
handing each step its own frames and counting the bytes. The CPU tests run
the plain twins; the tests marked `cuda` hold the u8 kernels to their twins
bit for bit and a HostFeed's copy to its step on the card, and skip where
torch sees no CUDA device. This file imports no jax, so the card's
machine runs it with --noconftest."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import reference, reference_u8  # noqa: E402
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params  # noqa: E402
from tpudab_torch.models.ingest import HostFeed  # noqa: E402
from tpudab_torch.models.step import ReceiveStep  # noqa: E402
from tpudab_torch.models.step_driver import StepDriver  # noqa: E402
from tpudab_torch.ofdm import demod  # noqa: E402
from tpudab_torch.ops import demod_tail  # noqa: E402
from tpudab_torch.ops.carve import (carve_rotate_ref, carve_rotate_tables_ref,  # noqa: E402
                                    u8_parts)
from tpudab_torch.tools.bench import bench_capture, bench_subchannels  # noqa: E402

FRAME_LEN = get_ofdm_params(1).nb_frame_length


def noise_u8(shape, seed: int) -> torch.Tensor:
    """Random bytes: every value 0..255 in I and in Q."""
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def converted(u8: torch.Tensor):
    """(..., frame_len, 2) uint8 -> (re, im) (..., frame_len) f32, (x - 127.5) / 128."""
    x = (u8.float() - 127.5) / 128.0
    return x[..., 0].contiguous(), x[..., 1].contiguous()


def assert_same_outputs(a: dict, b: dict):
    assert torch.equal(a["fic_bytes"], b["fic_bytes"])
    assert a["subch"].keys() == b["subch"].keys()
    assert all(torch.equal(a["subch"][k], b["subch"][k]) for k in a["subch"])
    for key in ("mean_power", "const_re", "const_im"):
        assert torch.equal(a[key], b[key]), key


def test_u8_parts_exact():
    """Every byte converts to (x - 127.5) / 128 exactly in f32, in both
    layouts, and I and Q keep their places."""
    x = torch.arange(256, dtype=torch.uint8)
    iq = torch.stack([x, x.flip(0)], dim=-1).reshape(1, 128, 2, 2).reshape(1, 256, 2)
    for frames in (iq, iq.reshape(1, 512)):
        re, im = u8_parts(frames, 256)
        want = (torch.arange(256, dtype=torch.float64) - 127.5) / 128
        assert torch.equal(re.double(), want[None]) and torch.equal(im.double(), want.flip(0)[None])
    with pytest.raises(ValueError):
        u8_parts(iq.float(), 256)


@pytest.mark.parametrize("flat", [False, True], ids=["pairs", "flat"])
@pytest.mark.parametrize("mode", [1, 2])
def test_carve_u8_twins_equal_f32_twins(mode, flat):
    """K5's plain twins on u8 frames give their outputs on the f32
    conversion bit for bit (the conversion is exact, then the same f32
    arithmetic)."""
    n = get_ofdm_params(mode).nb_frame_length
    u8 = noise_u8((3, n, 2), 11 + mode)
    frames = u8.reshape(3, 2 * n) if flat else u8
    re, im = converted(u8)
    freq = torch.tensor([1999.0, -2000.0, 731.5])
    for twin in (carve_rotate_tables_ref, carve_rotate_ref):
        got = twin(frames, None, freq, mode, with_sum=True)
        want = twin(re, im, freq, mode, with_sum=True)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), twin.__name__


@pytest.mark.parametrize("f", [1, 3])
def test_stats_u8_twin_equals_f32_twin(f):
    """stats_kernel's twin on u8 frames gives its mean_power and tap on the
    f32 conversion bit for bit."""
    u8 = noise_u8((f, FRAME_LEN, 2), 5 + f)
    re, im = converted(u8)
    m = demod._spectra(re, im, torch.linspace(-900.0, 1300.0, f), demod.dft_operands(1), 1,
                       12, False)
    got = demod_tail.stats_ref(u8, None, *m)
    want = demod_tail.stats_ref(re, im, *m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("f", [1, 3, 4])
@pytest.mark.parametrize("e", [1, 2])
def test_step_u8_equals_f32(e, f):
    """ReceiveStep on u8 frames (pairs, and flat for E = 2) decodes the bytes,
    mean_power and tap of the step on their f32 conversion, bit for bit."""
    step = ReceiveStep(1, bench_subchannels()[:2], n_ensembles=e)
    lead = (e,) if e > 1 else ()
    u8 = noise_u8(lead + (f, FRAME_LEN, 2), 100 * e + f)
    freq = torch.tensor([350.0, -1200.0][:e]) if e > 1 else torch.tensor(-777.0)
    re, im = converted(u8)
    _, want = step(step.init_carry("cpu"), re, im, freq)
    frames = u8.reshape(lead + (f, 2 * FRAME_LEN)) if e > 1 else u8
    _, got = step(step.init_carry("cpu"), frames, None, freq)
    assert_same_outputs(got, want)


def test_step_refuses_u8_with_im():
    step = ReceiveStep(1, bench_subchannels()[:1])
    u8 = noise_u8((1, FRAME_LEN, 2), 3)
    with pytest.raises(ValueError):
        step.demod(u8, u8, 0.0)


def capture_u8(n_frames: int, freq_hz: float, seed: int) -> torch.Tensor:
    """The bench multiplex (the port's synthesizer), the CFO added, AWGN at
    15 dB, then quantised as rtl_sdr delivers it: each rail's RMS 32 LSB
    around 127.5, rounded, clipped to 0..255."""
    frames, _ = bench_capture(n_frames)
    rng = np.random.default_rng(seed)
    t = np.arange(frames.size) / SAMPLING_RATE
    x = frames.ravel().astype(np.complex128) * np.exp(2j * np.pi * freq_hz * t)
    p = np.mean(np.abs(x) ** 2)
    noise = rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size)
    x += np.sqrt(p / 10 ** 1.5 / 2) * noise
    x *= 32.0 / np.sqrt(np.mean(np.abs(x) ** 2) / 2)
    iq = np.stack([x.real, x.imag], axis=-1) + 127.5
    return torch.from_numpy(np.clip(np.rint(iq), 0, 255).astype(np.uint8)).reshape(
        n_frames, FRAME_LEN, 2)


def test_mean_power_and_tap_against_reference_u8():
    """On a seeded u8 capture, the step's mean_power within 1e-6 relative of
    reference_u8's float64 (the conversion is exact; what is left is the f32
    sum of 196,608 squares, a few f32 ulps), and its tap within 0.02 RMS of
    the reference's (the windows and the three DFT products round to bf16,
    2^-9 relative a value: the bench cells' limit, which float8 e4m3, one
    precision lower, exceeds)."""
    freq = 1234.5
    u8 = capture_u8(2, freq, 9)
    step = ReceiveStep(1, bench_subchannels())
    _, out = step(step.init_carry("cpu"), u8, None, torch.tensor(freq))
    want = reference_u8.mean_power(u8).numpy()
    assert reference.mean_power_gap(out["mean_power"].numpy(), want) < 1e-6
    tap = torch.stack([out["const_re"], out["const_im"]]).numpy()
    ref = reference_u8.const_tap(u8[-1], freq, 1).numpy()
    assert reference.const_rms_gap(tap, ref) < 0.02
    control = reference_u8.const_tap(u8[-1], freq, 1, "fp8").numpy()
    assert reference.const_rms_gap(control, ref) > 0.02


def test_hostfeed_hands_each_step_its_frames():
    """Two buffers: each step takes the frames fed for it, oldest first, fed
    whole or as one region a row; a third feed before a take is refused; the
    bytes are counted."""
    shape = (2, 3, 8, 2)
    feed = HostFeed(shape, "cpu")
    a, b, c = (noise_u8(shape, s) for s in (1, 2, 3))
    feed.feed(a)
    feed.feed(list(b))
    with pytest.raises(RuntimeError):
        feed.feed(c)
    assert torch.equal(feed.take(), a)
    with pytest.raises(RuntimeError):
        feed.take()
    feed.release()
    feed.feed(c)
    assert torch.equal(feed.take(), b)
    feed.release()
    assert torch.equal(feed.take(), c)
    feed.release()
    with pytest.raises(RuntimeError):
        feed.take()
    assert feed.bytes_copied == 3 * a.numel()
    with pytest.raises(ValueError):
        feed.feed(a[:1])
    with pytest.raises(ValueError):
        feed.feed(a.float())


def test_step_through_hostfeed():
    """ReceiveStep.forward and StepDriver.process take a HostFeed: each step
    decodes the frames fed for it, as the step does on them directly."""
    step = ReceiveStep(1, bench_subchannels()[:1], n_ensembles=2)
    frames = [noise_u8((2, 1, FRAME_LEN, 2), s) for s in (40, 41)]
    freq = torch.tensor([10.0, -20.0])
    feed = HostFeed(frames[0].shape, "cpu")
    carry = carry_direct = step.init_carry("cpu")
    feed.feed(list(frames[0]))
    for k, x in enumerate(frames):
        carry, got = step(carry, feed, None, freq)
        if k + 1 < len(frames):
            feed.feed(list(frames[k + 1]))
        carry_direct, want = step(carry_direct, x, None, freq)
        assert_same_outputs(got, want)
    assert feed.bytes_copied == 2 * frames[0].numel()


class _Receiver:
    """What StepDriver.process asks of a Receiver: the bytes handed back."""

    class dab:
        nb_cifs = 4

    def process_step_outputs(self, fic, subch, first_logical):
        self.got = (fic, subch)
        return {}


def test_step_driver_process_u8_and_hostfeed():
    driver = StepDriver(1, 12, "cpu")
    driver.step = ReceiveStep(1, bench_subchannels()[:1])
    u8 = noise_u8((2, FRAME_LEN, 2), 77)
    rx = _Receiver()
    got = {}
    for kind in ("u8", "feed"):
        driver.carry, driver.first_logical = driver.step.init_carry("cpu"), {1: 0}
        if kind == "u8":
            driver.process(rx, u8, None, 0.0)
        else:
            feed = HostFeed(u8.shape, "cpu")
            feed.feed(u8)
            driver.process(rx, feed, None, 0.0)
        got[kind] = rx.got
        assert driver.first_logical == {1: 8}
    assert np.array_equal(got["u8"][0], got["feed"][0])
    assert np.array_equal(got["u8"][1][1], got["feed"][1][1])


# ---------------- on the card ----------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_carve_u8_kernel_equals_twin(dev, mode):
    """K5's u8 instantiation bit-equal to its twin on the card and to the f32
    instantiation on the converted frames, in every mode (window starts at
    every alignment mod 8), pairs and flat; one launch a call."""
    from tpudab_torch.ops.carve import carve_rotate_cuda

    n = get_ofdm_params(mode).nb_frame_length
    u8 = noise_u8((3, n, 2), 31 + mode).to(dev)
    re, im = converted(u8)
    freq = torch.tensor([1999.0, -2000.0, 731.5], device=dev)
    n0 = carve_rotate_cuda.launches
    got = carve_rotate_cuda(u8, None, freq, mode, with_sum=True)
    flat = carve_rotate_cuda(u8.reshape(3, 2 * n), None, freq, mode, with_sum=True)
    f32 = carve_rotate_cuda(re, im, freq, mode, with_sum=True)
    torch.cuda.synchronize()
    assert carve_rotate_cuda.launches == n0 + 3
    want = carve_rotate_tables_ref(u8, None, freq, mode, with_sum=True)
    for g, fl, f, w in zip(got, flat, f32, want):
        assert same_bits(g, w) and same_bits(fl, w) and same_bits(f, w)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 16])
def test_stats_u8_kernel_equals_twin(dev, f):
    """stats_kernel's u8 instantiation bit-equal to its twin (on the CPU) and
    to the f32 instantiation on the converted frames."""
    u8 = noise_u8((f, FRAME_LEN, 2), 60 + f).to(dev)
    re, im = converted(u8)
    m = demod._spectra(re.to(torch.bfloat16), im.to(torch.bfloat16),
                       torch.linspace(-1500.0, 2500.0, f, device=dev),
                       tuple(w.to(dev) for w in demod.dft_operands(1)), 1, 12, False)
    got = demod_tail.stats_cuda(u8, None, *m)
    f32 = demod_tail.stats_cuda(re, im, *m)
    torch.cuda.synchronize()
    want = demod_tail.stats_ref(u8.cpu(), None, *(x.cpu() for x in m))
    for g, f_, w in zip(got, f32, want):
        assert same_bits(g.cpu(), w) and same_bits(f_.cpu(), w)


@pytest.mark.cuda
def test_step_u8_equals_f32_on_card(dev):
    """The step on the card decodes u8 frames to the bytes, mean_power and tap
    of their f32 conversion."""
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=2).to(dev)
    u8 = noise_u8((2, 4, FRAME_LEN, 2), 8).to(dev)
    re, im = converted(u8)
    freq = torch.tensor([350.0, -1200.0], device=dev)
    _, want = step(step.init_carry(dev), re, im, freq)
    _, got = step(step.init_carry(dev), u8, None, freq)
    torch.cuda.synchronize()
    assert_same_outputs(got, want)


@pytest.mark.cuda
def test_hostfeed_rewrite_after_feed(dev):
    """A pinned host buffer rewritten right after feed() returns and
    synchronize() waits for its copy does not change the step that was fed;
    a step waits for its own copy, and the next copy into a buffer for the
    step that read it."""
    step = ReceiveStep(1, bench_subchannels()).to(dev)
    frames = [noise_u8((4, FRAME_LEN, 2), s) for s in (90, 91, 92)]
    host = torch.empty(frames[0].shape, dtype=torch.uint8, pin_memory=True)
    feed = HostFeed(host.shape, dev)
    outs, carry = [], step.init_carry(dev)
    host.copy_(frames[0])
    feed.feed(host)
    for k in range(len(frames)):
        feed.synchronize()
        host.fill_(0)                  # rewritten at once: the card holds its copy
        carry, out = step(carry, feed, None, 0.0)
        if k + 1 < len(frames):
            host.copy_(frames[k + 1])
            feed.feed(host)
        outs.append(out)
    torch.cuda.synchronize()
    carry = step.init_carry(dev)
    for x, got in zip(frames, outs):
        carry, want = step(carry, x.to(dev), None, 0.0)
        assert_same_outputs(got, want)
    assert feed.bytes_copied == 3 * host.numel()


@pytest.mark.cuda
def test_hostfeed_one_step_ahead(dev):
    """Fed one step ahead from a ring of two pinned slots,
    each slot refilled only once its step's bytes are on the host: every
    step decodes its own frames, and each copy after the first runs on the
    feed's stream while the step before it runs."""
    step = ReceiveStep(1, bench_subchannels()).to(dev)
    frames = [noise_u8((4, FRAME_LEN, 2), s) for s in (93, 94, 95, 96)]
    ring = [torch.empty(frames[0].shape, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    feed = HostFeed(ring[0].shape, dev)
    ring[0].copy_(frames[0])
    feed.feed(ring[0])
    outs, carry = [], step.init_carry(dev)
    for k in range(len(frames)):
        if k + 1 < len(frames):
            ring[(k + 1) % 2].copy_(frames[k + 1])
            feed.feed(ring[(k + 1) % 2])
        carry, out = step(carry, feed, None, 0.0)
        outs.append({"fic_bytes": out["fic_bytes"].cpu(),
                     "subch": {i: v.cpu() for i, v in out["subch"].items()},
                     **{key: out[key].cpu() for key in ("mean_power", "const_re", "const_im")}})
    carry = step.init_carry(dev)
    for x, got in zip(frames, outs):
        carry, want = step(carry, x.to(dev), None, 0.0)
        want = {"fic_bytes": want["fic_bytes"].cpu(),
                "subch": {i: v.cpu() for i, v in want["subch"].items()},
                **{key: want[key].cpu() for key in ("mean_power", "const_re", "const_im")}}
        assert_same_outputs(got, want)
    assert feed.bytes_copied == 4 * ring[0].numel()

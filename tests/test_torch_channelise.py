"""The wideband front end's channeliser (ofdm/channelise.py) on the CPU:
its plain path against the float64 reference (benchmark/reference_wide.py)
on seeded s8 streams, the filter's spec, the tail carried across steps,
the frame offsets, the plan against the Band III table, a composite of
three blocks decoded through ReceiveStep, and HostFeed with s8 regions.
The kernel itself runs on the card only (tests/test_torch_cuda.py); here
its arithmetic runs as channelise_tables_ref. This file imports no jax."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, reference, reference_wide  # noqa: E402
from tpudab_torch.constants.channels import BAND_III  # noqa: E402
from tpudab_torch.constants.ofdm_params import get_ofdm_params  # noqa: E402
from tpudab_torch.models.ingest import HostFeed  # noqa: E402
from tpudab_torch.models.step import ReceiveStep  # noqa: E402
from tpudab_torch.ofdm.channelise import (ChannelPlan, Channeliser, channelise_ref,  # noqa: E402
                                          channelise_tables_ref, design_taps, f16_taps,
                                          gemm_taps, mma_fragments, plan_taps,
                                          tap_gains)
from tpudab_torch.tools.bench import bench_subchannels  # noqa: E402

FRAME_LEN = get_ofdm_params(1).nb_frame_length
RATE = 16.384e6
CENTRES = [181e6, 195e6, 209e6, 223e6]
HACKRF8 = json.loads((ROOT / "benchmark" / "configs" / "hackrf8.json").read_text())


def streams(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(-128, 128, shape,
                                                                 dtype=np.int8))


def seeded(ch, f, seed, receivers=1):
    """A random tail and f frames of random s8 streams for channeliser ch."""
    tail = ch.init_tail("cpu")
    tail.copy_(streams(tuple(tail.shape), seed))
    return tail, streams((receivers, 8 * f * FRAME_LEN, 2), seed + 1)


def frames(ch, f):
    e = ch.plan.n_ensembles
    return (torch.empty(e, f, FRAME_LEN // 128, 128, dtype=torch.bfloat16),
            torch.empty(e, f, FRAME_LEN // 128, 128, dtype=torch.bfloat16))


def reference_gap(plan, tail, x, offsets, re, im, precision="f64"):
    """The relative RMS error of frames (re, im) against reference_wide's,
    and the largest relative gap of their frames' mean powers."""
    h = reference_wide.design(plan.taps, plan.beta, plan.cutoff_hz, plan.rate_hz)
    err = power = 0.0
    mp_gap = 0.0
    f = re.shape[1]
    for s in range(plan.receivers):
        stream = torch.cat([tail[s], x[s]])
        y = reference_wide.ddc(stream, -(plan.taps - 1), plan.offsets_hz()[s].tolist(), h,
                               plan.rate_hz, plan.decimation)
        for b in range(plan.blocks_per_receiver):
            e = s * plan.blocks_per_receiver + b
            d = int(offsets[e])
            want = y[b, d: d + f * FRAME_LEN]
            a, p = reference_wide.rms_gap(re[e].reshape(-1), im[e].reshape(-1), want)
            err, power = err + a, power + p
            mp = (re[e].double() ** 2 + im[e].double() ** 2).reshape(f, -1).mean(-1)
            want_mp = reference_wide.mean_power(want.reshape(f, -1))
            mp_gap = max(mp_gap, reference.mean_power_gap(mp.numpy(), want_mp.numpy()))
    return (err / power) ** 0.5, mp_gap


def test_plan_offsets_are_the_band_iii_table():
    """Each plan offset is constants/channels.py's block frequency less its
    receiver's centre, every receiver's eight the same (+-0.936, 2.648,
    4.360, 6.072 MHz); the hackrf8 configuration's blocks are the table's."""
    plan = ChannelPlan.band_iii(CENTRES)
    assert plan.n_ensembles == 32 and plan.blocks[0][0] == "5A" and plan.blocks[3][-1] == "12D"
    for s, c in enumerate(CENTRES):
        for b, label in enumerate(plan.blocks[s]):
            assert plan.offsets_hz()[s, b] == BAND_III[label] - c
    want = np.array([-6072, -4360, -2648, -936, 936, 2648, 4360, 6072]) * 1e3
    assert np.allclose(plan.offsets_hz(), want[None], atol=1e-3)
    fe = HACKRF8["front_end"]
    assert fe["blocks"] == [label for bl in plan.blocks for label in bl]
    assert [round(BAND_III[label] / 1e6, 3) for label in fe["blocks"]] == fe["block_mhz"]
    assert [c * 1e6 for c in fe["centres_mhz"]] == CENTRES
    with pytest.raises(ValueError):
        ChannelPlan((181e6,), (("9A",),))          # 21 MHz off its centre


def _response_db(h, f_hz):
    n = np.arange(len(h))
    return 20 * np.log10(np.abs(np.exp(-2j * np.pi * np.outer(f_hz, n) / RATE) @ h))


def test_filter_meets_its_spec():
    """The 120-tap Kaiser (beta 5.653) low-pass, cut off at 1.024 MHz: unity
    gain at DC, ripple within 0.02 dB up to 0.768 MHz (the active carriers)
    and at least 60 dB down from 1.280 MHz (what would fold onto them after
    decimation by 8); the reference designs the same taps in float64. Its
    f16 taps (the kernel's) keep the spec, the float8 control's do not."""
    h = design_taps(120, 5.653, 1.024e6, RATE)
    assert h.sum() == pytest.approx(1.0, abs=1e-12)
    ref = reference_wide.design(120, 5.653, 1.024e6, RATE).numpy()
    assert np.abs(h - ref).max() < 1e-15
    passband, stopband = np.linspace(0, 0.768e6, 3001), np.linspace(1.28e6, RATE / 2, 20001)
    assert np.abs(_response_db(h, passband)).max() <= 0.02
    assert _response_db(h, stopband).max() <= -60.0
    fp8 = reference_wide.design(120, 5.653, 1.024e6, RATE, "fp8").numpy()
    assert np.abs(_response_db(fp8, passband)).max() > 0.02
    assert _response_db(fp8, stopband).max() > -60.0
    # the kernel's complex f16 taps, each block's response about its offset
    both = np.concatenate([-stopband[::-1], stopband])
    for f in (-6072e3, -936e3, 2648e3, 4360e3):
        g = f16_taps(120, 5.653, 1.024e6, RATE, 1.28e6, f)
        assert np.array_equal(g.real, g.real.astype(np.float16).astype(np.float64))
        assert np.abs(_response_db(g, np.concatenate([-passband, passband]) + f)).max() <= 0.02
        assert _response_db(g, both + f).max() <= -60.0


@pytest.mark.parametrize("f", [1, 2])
def test_cpu_path_against_reference(f):
    """One receiver's 8 blocks from seeded s8 streams and a random tail, at
    frame offsets from 0 to frame_len - 1: the frames within 3e-3 relative
    RMS of the float64 reference (bf16 frames round each part to 2^-9,
    1.7e-3 RMS; the float8 control reads 3.7e-2) and their mean powers
    within 1e-4 (the cells' limit; the control's 1.7e-2); the kernel's
    arithmetic (f16 taps, each block's gain) as close."""
    plan = ChannelPlan.band_iii([195e6], first="7A")
    ch = Channeliser(plan)
    tail, x = seeded(ch, f, 10 + f)
    offsets = torch.tensor([0, FRAME_LEN - 1, 5, 1000, 77777, 3, 100000, 2048])
    re, im = frames(ch, f)
    channelise_ref(tail, x, offsets, plan, re, im)
    rms, mp = reference_gap(plan, tail, x, offsets, re, im)
    assert rms < 3e-3 and mp < 1e-4, (rms, mp)
    re2, im2 = frames(ch, f)
    channelise_tables_ref(tail, x, offsets, plan, ch.b_taps, ch.scale, re2, im2)
    rms, mp = reference_gap(plan, tail, x, offsets, re2, im2)
    assert rms < 3e-3 and mp < 1e-4, (rms, mp)


def test_control_fails_the_cpu_tolerances():
    """The float8 reference (taps and mixed samples in e4m3) misses both
    tolerances the CPU path meets."""
    plan = ChannelPlan.band_iii([195e6], first="7A")
    ch = Channeliser(plan)
    tail, x = seeded(ch, 1, 30)
    h64 = reference_wide.design(120, 5.653, 1.024e6, RATE)
    h8 = reference_wide.design(120, 5.653, 1.024e6, RATE, "fp8")
    stream = torch.cat([tail[0], x[0]])
    offs = plan.offsets_hz()[0].tolist()
    want = reference_wide.ddc(stream, -119, offs, h64, RATE, 8)[:, :FRAME_LEN]
    low = reference_wide.ddc(stream, -119, offs, h8, RATE, 8, "fp8")[:, :FRAME_LEN]
    a, p = reference_wide.rms_gap(low.real, low.imag, want)
    assert (a / p) ** 0.5 > 3e-3
    mp = reference.mean_power_gap(reference_wide.mean_power(low).numpy(),
                                  reference_wide.mean_power(want).numpy())
    assert mp > 1e-4


def test_kernel_operands():
    """gemm_taps' 240 x 16 matrix times a window is the block's complex
    filter g_b[k] = h[k] exp(+j 2 pi f_b k / rate) on the window reversed;
    the mma fragments hold rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g for
    lane 4 g + t; each block's gain is within 1e-3 of 1."""
    plan = ChannelPlan.band_iii([209e6], first="9A")
    b = gemm_taps(plan)
    assert b.shape == (1, 240, 16) and b.dtype == torch.float16
    rng = np.random.default_rng(4)
    w = rng.standard_normal(240)
    y = w @ b[0].double().numpy()
    h = plan_taps(plan)
    k = np.arange(120)
    xs = (w[0::2] + 1j * w[1::2])[::-1]            # x[8m - k], k = 0..119
    for j, f in enumerate(plan.offsets_hz()[0]):
        g = h * np.exp(2j * np.pi * f * k / RATE)
        assert abs(y[2 * j] + 1j * y[2 * j + 1] - g @ xs) < 2e-3 * np.abs(g).sum()
    frag = mma_fragments(b).view(1, 15, 2, 8, 4, 4)          # (S, kk, nt, g, t, half)
    rows = b.view(1, 15, 16, 2, 8)
    for t in range(4):
        for half, row in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
            assert torch.equal(frag[:, :, :, :, t, half], rows[:, :, row])
    gain = tap_gains(plan, b)
    assert gain.shape == (1, 8) and float((gain - 1).abs().max()) < 1e-3


def test_three_chunks_with_the_carry_equal_one_run():
    """Three steps of one frame, the tail carried, give the frames of one
    3-frame step (and its tail) bit for bit: the same outputs from the same
    stream, on both plain versions."""
    plan = ChannelPlan.band_iii([181e6])
    ch = Channeliser(plan)
    tail, x = seeded(ch, 3, 50)
    offsets = torch.arange(8) * 24000 + 7
    whole_tail, re, im = ch(tail, x, offsets)
    re, im = re.clone(), im.clone()
    t = tail
    n = 8 * FRAME_LEN
    for k in range(3):
        t, re_k, im_k = ch(t, x[:, k * n:(k + 1) * n].contiguous(), offsets)
        assert torch.equal(re_k[:, 0], re[:, k]) and torch.equal(im_k[:, 0], im[:, k]), k
    assert torch.equal(t, whole_tail)
    assert ch.calls == 4 and ch.samples_in == 2 * x.shape[1] and ch.launches == 0
    out = [frames(ch, 3), frames(ch, 1)]
    channelise_tables_ref(tail, x, offsets, plan, ch.b_taps, ch.scale, *out[0])
    t = tail
    for k in range(3):
        chunk = x[:, k * n:(k + 1) * n]
        channelise_tables_ref(t, chunk, offsets, plan, ch.b_taps, ch.scale, *out[1])
        t = torch.cat([t, chunk], dim=1)[:, -ch.n_tail:]
        assert torch.equal(out[1][0][:, 0], out[0][0][:, k])


def test_frame_offsets_land_the_right_samples():
    """Offsets d and d + 1000 give the same block's outputs 1000 samples
    apart; offset 0 starts at the output whose window ends on the step's
    first new sample less frame_len decimated samples, as the reference
    indexes it."""
    plan = ChannelPlan.band_iii([223e6], first="11A")
    ch = Channeliser(plan)
    tail, x = seeded(ch, 1, 60)
    a, b = torch.arange(8) * 1000, torch.arange(8) * 1000 + 1000
    _, re_a, im_a = ch(tail, x, a)
    re_a, im_a = re_a.clone().reshape(8, -1), im_a.clone().reshape(8, -1)
    _, re_b, im_b = ch(tail, x, b)
    re_b, im_b = re_b.reshape(8, -1), im_b.reshape(8, -1)
    assert torch.equal(re_a[:, 1000:], re_b[:, :-1000]) and torch.equal(im_a[:, 1000:],
                                                                        im_b[:, :-1000])
    # an impulse in the tail at stream sample 8 j + 119 - k reaches output j through tap k
    tail = ch.init_tail("cpu")
    x = torch.zeros(1, 8 * FRAME_LEN, 2, dtype=torch.int8)
    j, k = 1234, 59
    tail[0, 8 * j + 119 - k, 0] = 127
    _, re, im = ch(tail, x, torch.zeros(8, dtype=torch.long))
    peak = (re.float() ** 2 + im.float() ** 2).reshape(8, -1).argmax(dim=1)
    assert (peak == j).all()


def test_three_block_composite_decodes():
    """Three blocks of one receiver, each an ensemble with its own CFO,
    level and frame offset, composed as the benchmark's widefed traffic
    does, quantised to s8: ReceiveStep with the plan decodes every FIC and
    subchannel byte sent, the channeliser's tail carried from step to
    step; through a HostFeed fed the streams' bytes the same bytes."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell("hackrf8.wide32x16", bench)
    cell.traffic.update({"receivers": 1, "blocks_per_receiver": 3, "n_ensembles": 3,
                         "n_frames": 2, "distinct": 3})
    drv = harness.driver_module(cell)
    sig = drv.wide_signal(cell.config, cell.traffic, 2 ** 31 + 5, torch.device("cpu"))
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=3, channels=drv.plan(cell))
    freq, offsets = torch.from_numpy(sig.cfo_hz), torch.from_numpy(sig.frame_offset)
    feed = HostFeed(sig.iq.shape, "cpu")
    carry = carry_feed = step.init_carry("cpu")
    for k in range(3):
        carry, out = step(carry, sig.iq, None, freq, offsets)
        feed.feed([r.view(torch.uint8) for r in sig.iq])
        carry_feed, out_feed = step(carry_feed, feed, None, freq, offsets)
        assert torch.equal(out["fic_bytes"], out_feed["fic_bytes"])
    mon = sig.mon
    dab = drv.get_dab_params(1)
    assert np.array_equal(out["fic_bytes"].numpy(),
                          mon.fibs.reshape(3, 2 * dab.nb_fib_groups, -1))
    truth = drv.step_truth(mon, 3, 2 * dab.nb_cifs, 0)
    for sid, want in truth.items():        # rows past the interleaver's ramp
        assert np.array_equal(out["subch"][sid].numpy()[:, 8:], want[:, 8:]), sid
        assert torch.equal(out["subch"][sid], out_feed["subch"][sid])
    assert step.ddc.calls == 6 and step.ddc.samples_in == 6 * sig.iq.shape[1]
    assert feed.bytes_copied == 3 * sig.iq.numel()


def test_hostfeed_int8_regions():
    """A HostFeed of (receivers, samples, 2) fed one s8 host region a
    receiver as its bytes (a uint8 view): it hands the step those bytes,
    the s8 samples again as an int8 view, and counts them; s8 regions not
    viewed as bytes are refused."""
    shape = (4, 64, 2)
    feed = HostFeed(shape, "cpu")
    regions = [streams(shape[1:], s) for s in range(4)]
    feed.feed([r.view(torch.uint8) for r in regions])
    assert torch.equal(feed.take().view(torch.int8), torch.stack(regions))
    feed.release()
    assert feed.bytes_copied == 4 * 64 * 2
    with pytest.raises(ValueError):
        feed.feed(regions)


def test_step_refuses_what_a_plan_does_not_take():
    """A plan's ensembles must be the step's; wideband streams come with
    frames_im None, as int8 of whole frames."""
    plan = ChannelPlan.band_iii([181e6])
    with pytest.raises(ValueError):
        ReceiveStep(1, bench_subchannels()[:1], n_ensembles=4, channels=plan)
    step = ReceiveStep(1, bench_subchannels()[:1], n_ensembles=8, channels=plan)
    assert step.init_carry("cpu")["ddc"].shape == (1, 8 * FRAME_LEN + 119, 2)
    x = torch.zeros(1, 8 * FRAME_LEN, 2, dtype=torch.int8)
    with pytest.raises(ValueError):
        step(step.init_carry("cpu"), x, x, 0.0)
    with pytest.raises(ValueError):
        step(step.init_carry("cpu"), x[:, :-8], None, 0.0)
    with pytest.raises(ValueError):
        step(step.init_carry("cpu"), x.view(torch.uint8), None, 0.0)


@pytest.mark.parametrize("bad", [-1, FRAME_LEN])
def test_frame_offsets_out_of_range_are_refused(bad):
    """A frame offset outside [0, frame_len) would leave part of its
    ensemble's frames unwritten: the channeliser and the step refuse it,
    from a list, a numpy array or a CPU tensor, before any work."""
    plan = ChannelPlan.band_iii([181e6])
    ch = Channeliser(plan)
    tail, x = seeded(ch, 1, 70)
    offsets = [0, 5, 7, 9, 11, 13, FRAME_LEN - 1, bad]
    for given in (offsets, np.array(offsets), torch.tensor(offsets)):
        with pytest.raises(ValueError):
            ch(tail, x, given)
    assert ch.calls == 0 and ch.samples_in == 0
    step = ReceiveStep(1, bench_subchannels()[:1], n_ensembles=8, channels=plan)
    with pytest.raises(ValueError):
        step(step.init_carry("cpu"), x, None, 0.0, offsets)


def test_plan_takes_the_kernels_taps_and_decimation():
    """The plan's taps, decimation and rate are the kernel's, not options:
    120 taps, decimation 8, 16.384 MS/s (8 x 2.048 MS/s); the configuration
    states the same numbers."""
    from tpudab_torch.ops.channelise_cuda import DECIMATION, TAPS
    plan = ChannelPlan.band_iii(CENTRES)
    assert (plan.taps, plan.decimation, plan.rate_hz) == (TAPS, DECIMATION, RATE) == (120, 8, RATE)
    fe, ch = HACKRF8["front_end"], HACKRF8["channeliser"]
    assert (fe["sample_rate_hz"], fe["decimation"], ch["taps"]) == (RATE, 8, 120)
    with pytest.raises(TypeError):
        ChannelPlan((181e6,), (("5A",),), taps=96)

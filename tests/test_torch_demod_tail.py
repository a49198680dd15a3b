"""The demod tail's plain twins (ops/demod_tail.py), which repeat the
kernels of csrc/demod_tail.cu op for op, against the eager bf16 chain of
ofdm/demod.py that they replace on the card; and the dispatch between the
two. The kernels themselves are held to the twins, bit for bit, in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.ofdm import demod
from tpudab_torch.ops import demod_tail

FRAMES = (1, 3, 16)


def frames(mode: int, f: int, tiled: bool = True, dtype=torch.bfloat16, seed: int = 0):
    """f random IQ frames; with f > 1 frame 1 is all zeros (its mean
    magnitude clamps to 1e-20)."""
    n = get_ofdm_params(mode).nb_frame_length
    g = torch.Generator().manual_seed(seed + 100 * mode + f)
    x = [torch.randn((f, n), generator=g) * 0.3 for _ in range(2)]
    if f > 1:
        x[0][1] = x[1][1] = 0.0
    shape = (f, n // 128, 128) if tiled else (f, n)
    return tuple(v.reshape(shape).to(dtype) for v in x)


def products(mode: int, f: int, seed: int = 0):
    """The three bf16 Karatsuba products of frames(mode, f): the tail's input."""
    re, im = frames(mode, f, seed=seed)
    freq = torch.linspace(-1500.0, 2500.0, f)
    return demod._spectra(re, im, freq, demod.dft_operands(mode), mode, 12, False)


def eager_tail(m1, m2, m3, out_dtype, frames_re=None, frames_im=None):
    """dr, di and the soft bits and stats of demod_frames_split's eager chain
    after the products (its stats on frames_re, frames_im if given)."""
    dr, di = demod.differential_demap(m1 - m2, m3 + m1)
    if frames_re is None:
        frames_re = frames_im = torch.zeros((m1.shape[0], 8))
    soft, stats = demod.eager_tail((m1 - m2, m3 + m1), frames_re, frames_im, out_dtype)
    return dr, di, soft, stats


def within_one_bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return bool(((a - b).abs() <= torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())


@pytest.mark.parametrize("f", FRAMES)
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_twins_round_as_the_eager_chain(mode, f):
    """dr and di bit-equal to the eager bf16 chain's; the soft bits within
    1 bf16 ulp of it with every sign equal, in bf16 and in f32 (only the
    f32 sum behind the frame's mean is taken in another order)."""
    m = products(mode, f)
    p = get_ofdm_params(mode)
    dr, di = demod_tail.demap_parts_ref(*demod_tail.spectra_ref(*m))
    partials = demod_tail.demap_ref(*m)
    assert partials.shape == (f, -(-(p.nb_symbols - 1) // demod_tail.ROWS), 2)
    for out_dtype in (torch.bfloat16, torch.float32):
        er, ei, want, _ = eager_tail(*m, out_dtype)
        assert torch.equal(dr, er.float()) and torch.equal(di, ei.float())
        got = demod_tail.norm_ref(*m, partials, out_dtype)
        assert got.dtype == out_dtype and got.shape == (f, p.nb_frame_bits)
        assert within_one_bf16_ulp(got, want)
        assert torch.equal(got < 0, want < 0) and torch.equal(got == 0, want == 0)
        if f > 1:
            assert not got[1].any()


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "flat"])
@pytest.mark.parametrize("f", FRAMES)
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_stats_twin_matches_the_eager_stats(mode, f, tiled):
    """mean_power within 1e-6 of the eager f32 mean, for bf16 and f32
    frames given tiled or flat; the tap's points those of the eager
    slicing, scaled to unit RMS within 1e-6 (the scale's 480-term sum in
    the kernel's tree, 1 / sqrt for rsqrt)."""
    m = products(mode, f)
    dr, _, _, _ = eager_tail(*m, torch.bfloat16)
    stride = max(1, ((get_ofdm_params(mode).nb_symbols - 1) * dr.shape[-1])
                 // demod.N_CONST_POINTS)
    assert demod_tail.tap_geometry(m[0].shape[1], m[0].shape[2]) == (stride, 480)
    for dtype in (torch.bfloat16, torch.float32):
        re, im = frames(mode, f, tiled, dtype, seed=7)
        power, tap = demod_tail.stats_ref(re, im, *m)
        want = eager_tail(*m, torch.bfloat16, re, im)[3]
        assert power.shape == (f,) and power.dtype == torch.float32
        assert bool(((power - want["mean_power"]).abs() <= 1e-6 * want["mean_power"]).all())
        assert tap.shape == (2, 480)
        torch.testing.assert_close(tap[0], want["const_re"], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(tap[1], want["const_im"], rtol=1e-6, atol=0.0)


def test_twin_sums_follow_the_kernel_order():
    """The twin's reduction is the kernel's: per carrier lane down a chunk's
    rows, then the lane tree, then the block's tree over K/8 threads padded
    to a power of two; here against the same order written as plain loops."""
    m = products(3, 1)
    dr, di = demod_tail.demap_parts_ref(*demod_tail.spectra_ref(*m))
    rows, k = demod_tail.ROWS, dr.shape[-1]
    got = demod_tail.demap_ref(*m)
    for part, x in enumerate((dr, di)):
        x = x[0].abs().numpy()
        for c in range(got.shape[1]):
            threads = []
            for t in range(k // 8):
                acc = np.zeros(8, np.float32)
                for r in range(c * rows, min((c + 1) * rows, x.shape[0])):
                    acc = (acc + x[r, 8 * t: 8 * t + 8]).astype(np.float32)
                a = [np.float32(v) for v in acc]
                threads.append(((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7])))
            s = threads + [np.float32(0.0)] * ((1 << (len(threads) - 1).bit_length())
                                               - len(threads))
            while len(s) > 1:
                h = len(s) // 2
                s = [np.float32(s[i] + s[i + h]) for i in range(h)]
            assert got[0, c, part].item() == s[0]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "flat"])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_demod_tail_path_equals_eager(monkeypatch, mode, tiled, out_dtype):
    """demod_frames_split through the tail path (forced here, so that its
    dispatchers take the twins on the CPU) against the eager chain on the
    same frames: soft bits within 1 bf16 ulp with equal signs, mean_power
    within 1e-6, the tap within 1e-6."""
    re, im = frames(mode, 3, tiled)
    args = (re, im, torch.tensor([300.0, 0.0, -2100.0]), demod.dft_operands(mode), mode, 12,
            out_dtype)
    want, wstats = demod.demod_frames_split(*args)
    monkeypatch.setattr(demod, "_tail_kernels", lambda operands, device: True)
    got, stats = demod.demod_frames_split(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert within_one_bf16_ulp(got, want) and torch.equal(got < 0, want < 0)
    assert sorted(stats) == sorted(wstats)
    torch.testing.assert_close(stats["mean_power"], wstats["mean_power"], rtol=1e-6, atol=0.0)
    for key in ("const_re", "const_im"):
        assert stats[key].shape == (480,)
        torch.testing.assert_close(stats[key], wstats[key], rtol=1e-6, atol=1e-7)


def test_tail_kernels_engage_on_cuda_bf16_alone():
    """The tail runs as kernels only for CUDA tensors with the bf16
    operands; the CPU, and f32 operands anywhere, keep the eager chain."""
    bf16, f32 = demod.dft_operands(2, "bfloat16"), demod.dft_operands(2, "float32")
    assert demod._tail_kernels(bf16, torch.device("cuda", 0))
    assert not demod._tail_kernels(f32, torch.device("cuda", 0))
    assert not demod._tail_kernels(bf16, torch.device("cpu"))
    assert not demod._tail_kernels(f32, torch.device("cpu"))


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_cpu_demod_takes_the_eager_chain(monkeypatch, dft_dtype):
    """On the CPU demod_frames_split calls none of the tail's functions."""
    def refuse(*a, **k):
        raise AssertionError("the demod tail was called on the CPU")
    for name in ("demap", "norm", "stats"):
        monkeypatch.setattr(demod_tail, name, refuse)
    re, im = frames(2, 3)
    soft, stats = demod.demod_frames_split(re, im, 100.0, demod.dft_operands(2, dft_dtype), 2)
    assert soft.shape == (3, get_ofdm_params(2).nb_frame_bits) and stats["const_re"].shape == (480,)


def test_dispatchers_take_the_twins_on_the_cpu():
    m = products(2, 3)
    partials = demod_tail.demap(*m)
    assert torch.equal(partials, demod_tail.demap_ref(*m))
    assert torch.equal(demod_tail.norm(*m, partials, torch.float32),
                       demod_tail.norm_ref(*m, partials, torch.float32))
    re, im = frames(2, 3)
    for a, b in zip(demod_tail.stats(re, im, *m), demod_tail.stats_ref(re, im, *m)):
        assert torch.equal(a, b)


def test_kernels_refuse_what_they_do_not_take():
    """The CUDA entry points check their inputs before loading the library:
    CPU tensors, f32 products and a K that is not a multiple of 8 raise."""
    m = products(2, 1)
    launches = (demod_tail.demap_cuda.launches, demod_tail.norm_cuda.launches,
                demod_tail.stats_cuda.launches)
    with pytest.raises(ValueError):
        demod_tail.demap_cuda(*m)
    with pytest.raises(ValueError):
        demod_tail.norm_cuda(*m, demod_tail.demap_ref(*m))
    re, im = frames(2, 1)
    with pytest.raises(ValueError):
        demod_tail.stats_cuda(re, im, *m)
    with pytest.raises(ValueError):
        demod_tail.demap_cuda(*(x.float() for x in m))
    with pytest.raises(ValueError):
        demod_tail.demap_cuda(*(x[..., :-4] for x in m))
    assert launches == (demod_tail.demap_cuda.launches, demod_tail.norm_cuda.launches,
                        demod_tail.stats_cuda.launches)

"""The port's CUDA kernels against their plain torch twins, on an NVIDIA GPU.

Marked `cuda`; each test skips where torch sees no CUDA device. They import
no jax, so on a GPU machine without jax run them without the repository's
conftest (which pins jax to the CPU):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpudab_torch.constants.dab_params import CU_BITS, get_dab_params
from tpudab_torch.constants.ofdm_params import get_ofdm_params
from tpudab_torch.constants.puncture import FIC_PROFILE, eep_profile, get_uep_profile
from tpudab_torch.fec.depuncture import depuncture_index, depuncture_t
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.msc.interleave import (SoftRows, deinterleave_cuda,
                                         deinterleave_depuncture_t_cuda,
                                         deinterleave_depuncture_t_ref, deinterleave_ref)
from tpudab_torch.ops.carve import carve_rotate_cuda, carve_rotate_ref, carve_rotate_tables_ref
from tpudab_torch.ops.carve_exp import carve_variant_cuda, carve_variant_ref
from tpudab_torch.ops import demod_tail
from tpudab_torch.ops.i16_probe import OPS as I16_OPS
from tpudab_torch.ops.i16_probe import i16_probe_cuda, i16_probe_ref
from tpudab_torch.ops.viterbi import radix_tables
from tpudab_torch.ops.viterbi_cuda import (BFLY4_LAYOUT, BFLY_LAYOUT,
                                           BFLY_LAYOUT_CODEWORDS_PER_SM, WARP_LAYOUT,
                                           WARP_LAYOUT_CODEWORDS_PER_SM, signs_on,
                                           viterbi_decode_bits_cuda, viterbi_decode_bytes_t_cuda,
                                           viterbi_decode_bytes_t_ref, viterbi_decode_ref)
from tpudab_torch.ops.viterbi_exp import (VARIANTS, fwd_variant_cuda, fwd_variant_ref,
                                          traceback_bytes_cuda, traceback_bytes_ref,
                                          traceback_maps_ref)
from tpudab_torch.tools.bench import bench_subchannels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("profile", [eep_profile(24, 3, 0), FIC_PROFILE], ids=["eep", "fic"])
def test_viterbi_kernel_equals_plain(dev, profile, dtype):
    """Bytes equal: same f32 summation order, selects and rebases."""
    rng = np.random.default_rng(1)
    n_punct = int(profile.mask().sum())
    soft = torch.from_numpy(rng.standard_normal((300, n_punct), dtype=np.float32))
    soft[:7] = 0.0  # all-erasure codewords: every compare-select ties
    soft_t = depuncture_t(soft.to(dev, dtype), torch.tensor(depuncture_index(profile), device=dev))
    signs = torch.tensor(radix_tables()[0], device=dev)
    got = viterbi_decode_bytes_t_cuda(soft_t, signs, profile.data_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, viterbi_decode_bytes_t_ref(soft_t, signs, profile.data_bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 17, 1000, 5003, 8003])
def test_viterbi_kernel_ragged_batch(dev, b, dtype):
    """K1+K2 at batches that are not a multiple of the codewords per block
    (8 f32, 16 bf16 one warp a codeword; 16 the butterflies: two a thread
    for 5003 on a card of 105 to 156 SMs, four for 8003 on one of up to
    166): the last block's missing codewords store nothing."""
    rng = np.random.default_rng(b)
    profile = FIC_PROFILE
    soft = torch.from_numpy(rng.standard_normal((b, int(profile.mask().sum())), dtype=np.float32))
    soft[: b // 5] = 0.0
    soft_t = depuncture_t(soft.to(dev, dtype), torch.tensor(depuncture_index(profile), device=dev))
    got = viterbi_decode_bytes_t_cuda(soft_t, signs_on(dev), profile.data_bits)
    torch.cuda.synchronize()
    assert got.shape == (b, profile.data_bits // 8)
    assert torch.equal(got, viterbi_decode_bytes_t_ref(soft_t, signs_on(dev), profile.data_bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deinterleave_kernel_exact(dev, dtype):
    buf = torch.randn((3, 8 + 15, 6912), generator=torch.Generator().manual_seed(0)).to(dev, dtype)
    got = deinterleave_cuda(buf, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, deinterleave_ref(buf, 8))
    assert torch.equal(deinterleave_cuda(buf[0], 8), deinterleave_ref(buf[0], 8))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


# mode, ensembles, frames per ensemble, [(start CU, size CU)], (profile, padding)
CHAINS = {
    "mode2_E3_c5": (2, 3, 5, [(0, 24), (24, 24)], (eep_profile(24, 3, 0), 0)),
    "16cu_eep2a": (1, 2, 2, [(100, 16)], (eep_profile(16, 2, 0), 0)),
    "uep_group_padded": (1, 3, 1, [(0, 96), (96, 96)],
                         (get_uep_profile(128, 3).to_profile(),
                          get_uep_profile(128, 3).padding_bits)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CHAINS))
def test_deinterleave_depuncture_t_kernel_exact(dev, case, dtype):
    """K4 mode (b): the Viterbi input and the new carries bit-equal to the
    twin at ragged shapes (c = 5; c < 15, so the new carry is part old
    carry; a UEP group with padding), one launch per subchannel."""
    mode, n_ens, n_frames, layout, (profile, padding) = CHAINS[case]
    dab = get_dab_params(mode)
    rng = np.random.default_rng(21)
    soft = torch.from_numpy(rng.standard_normal((n_ens * n_frames, dab.nb_frame_bits),
                                                dtype=np.float32)).to(dev, dtype)
    index = torch.tensor(depuncture_index(profile), device=dev)
    n = n_ens * n_frames * dab.nb_cifs
    outs = [torch.full((index.shape[0] // 8, 8, len(layout) * n + 3), 7.0, dtype=dtype,
                       device=dev) for _ in range(2)]
    for i, (start, size) in enumerate(layout):
        rows = SoftRows.cif_slices(dab.nb_fic_bits, dab.nb_cifs, start * CU_BITS, size * CU_BITS)
        carry = torch.from_numpy(rng.standard_normal((n_ens, 15, size * CU_BITS),
                                                     dtype=np.float32)).to(dev, dtype)
        n0 = deinterleave_depuncture_t_cuda.launches
        got = deinterleave_depuncture_t_cuda(soft, rows, carry, index, size * CU_BITS - padding,
                                             outs[0], 1 + i * n)
        torch.cuda.synchronize()
        assert deinterleave_depuncture_t_cuda.launches == n0 + 1
        want = deinterleave_depuncture_t_ref(soft, rows, carry, index, size * CU_BITS - padding,
                                             outs[1], 1 + i * n)
        assert same_bits(got, want)
    assert same_bits(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deinterleave_depuncture_t_fic_at_one_frame(dev, dtype):
    """K4 mode (b) at depth 1: the FIC of one frame, 4 FIB groups."""
    dab = get_dab_params(1)
    rng = np.random.default_rng(22)
    soft = torch.from_numpy(rng.standard_normal((1, dab.nb_frame_bits),
                                                dtype=np.float32)).to(dev, dtype)
    index = torch.tensor(depuncture_index(FIC_PROFILE), device=dev)
    rows = SoftRows.fib_groups(dab.nb_fib_groups, dab.nb_fic_bits_per_group)
    outs = [torch.full((index.shape[0] // 8, 8, 4), 7.0, dtype=dtype, device=dev)
            for _ in range(2)]
    assert deinterleave_depuncture_t_cuda(soft, rows, None, index, FIC_PROFILE.punctured_bits,
                                          outs[0]) is None
    deinterleave_depuncture_t_ref(soft, rows, None, index, FIC_PROFILE.punctured_bits, outs[1])
    torch.cuda.synchronize()
    assert same_bits(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_carve_kernel_equals_tables_twin(dev, mode, dtype):
    """K5's xr, xi and xs bit-equal to carve_rotate_tables_ref on the card,
    in every mode (window starts at every alignment mod 8), f32 and bf16
    frames; the two-output call gives the same xr, xi."""
    rng = np.random.default_rng(23)
    rows = get_ofdm_params(mode).nb_frame_length // 128
    fr, fi = (torch.from_numpy(rng.standard_normal((3, rows, 128), dtype=np.float32)).to(dev, dtype)
              for _ in range(2))
    freq = torch.tensor([1999.0, -2000.0, 731.5], device=dev)
    got = carve_rotate_cuda(fr, fi, freq, mode, with_sum=True)
    two = carve_rotate_cuda(fr, fi, freq, mode)
    torch.cuda.synchronize()
    want = carve_rotate_tables_ref(fr, fi, freq, mode, with_sum=True)
    for g, w in zip(got, want):
        assert same_bits(g, w)
    assert same_bits(two[0], got[0]) and same_bits(two[1], got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_carve_kernel_within_one_ulp(dev, dtype):
    """Within 1 bf16 ulp at each sample's magnitude."""
    rng = np.random.default_rng(2)
    fr = torch.from_numpy(rng.standard_normal((4, 1536, 128), dtype=np.float32)).to(dev, dtype)
    fi = torch.from_numpy(rng.standard_normal((4, 1536, 128), dtype=np.float32)).to(dev, dtype)
    freq = torch.tensor([1999.0, -2000.0, 0.0, 731.5], device=dev)
    (xr, xi), (rr, ri) = carve_rotate_cuda(fr, fi, freq), carve_rotate_ref(fr, fi, freq)
    torch.cuda.synchronize()
    xr, xi, rr, ri = xr.float(), xi.float(), rr.float(), ri.float()
    mag = torch.maximum(torch.hypot(xr, xi), torch.hypot(rr, ri)).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert (torch.maximum((xr - rr).abs(), (xi - ri).abs()) <= ulp).all()


def test_step_cuda_equals_cpu(dev):
    """The step on the card decodes the same bytes as on the CPU."""
    from tpudab_torch.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                                    ServiceSpec, SubchannelSpec, modulate_frame_bits)
    sub = bench_subchannels()[:2]
    spec = EnsembleSpec(0xBE9C, "Cuda", [ServiceSpec(0xC201, "C", [(0, ASCTY_DAB_PLUS, 1)])],
                        [SubchannelSpec(c.subch_id, c.start_cu, c.size_cu, ("eep", 3, 0))
                         for c in sub])
    synth = EnsembleSynthesizer(spec, seed=1)
    frames = np.stack([modulate_frame_bits(synth.frame_bits(i)) for i in range(5)])
    step = ReceiveStep(1, sub)
    tiled = step.tile_frames(frames)
    re = torch.from_numpy(np.ascontiguousarray(tiled.real, np.float32)).to(torch.bfloat16)
    im = torch.from_numpy(np.ascontiguousarray(tiled.imag, np.float32)).to(torch.bfloat16)
    _, cpu = step(step.init_carry("cpu"), re, im, 0.0)
    step = step.to(dev)
    _, gpu = step(step.init_carry(dev), re.to(dev), im.to(dev), 0.0)
    assert torch.equal(gpu["fic_bytes"].cpu(), cpu["fic_bytes"])
    for sid in cpu["subch"]:
        assert torch.equal(gpu["subch"][sid].cpu(), cpu["subch"][sid])


def demod_products(dev, mode, f, seed=5):
    """The three bf16 Karatsuba products of f random frames on the card,
    and the frames; frame 1 all zeros where f > 1 (its mean clamps)."""
    from tpudab_torch.ofdm import demod
    n = get_ofdm_params(mode).nb_frame_length
    rng = np.random.default_rng(seed)
    fr, fi = (torch.from_numpy(0.3 * rng.standard_normal((f, n // 128, 128),
                                                         dtype=np.float32)) for _ in range(2))
    if f > 1:
        fr[1] = fi[1] = 0.0
    fr, fi = fr.to(dev, torch.bfloat16), fi.to(dev, torch.bfloat16)
    freq = torch.linspace(-1500.0, 2500.0, f, device=dev)
    ops = tuple(w.to(dev) for w in demod.dft_operands(mode))
    return demod._spectra(fr, fi, freq, ops, mode, 12, False), (fr, fi)


@pytest.mark.parametrize("f", [1, 3, 16])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_demod_tail_kernels_equal_twins(dev, mode, f):
    """The demod tail's three kernels bit-equal to their plain twins (run on
    the CPU): the partials, the soft bits in bf16 and f32, mean_power and
    the tap for bf16 and f32 frames, tiled and flat; one launch each."""
    m, (fr, fi) = demod_products(dev, mode, f)
    mc = tuple(x.cpu() for x in m)
    n0 = (demod_tail.demap_cuda.launches, demod_tail.norm_cuda.launches,
          demod_tail.stats_cuda.launches)
    partials = demod_tail.demap_cuda(*m)
    soft = {dt: demod_tail.norm_cuda(*m, partials, dt) for dt in (torch.bfloat16, torch.float32)}
    stats = demod_tail.stats_cuda(fr, fi, *m)
    torch.cuda.synchronize()
    assert (demod_tail.demap_cuda.launches, demod_tail.norm_cuda.launches,
            demod_tail.stats_cuda.launches) == (n0[0] + 1, n0[1] + 2, n0[2] + 1)
    want = demod_tail.demap_ref(*mc)
    assert same_bits(partials.cpu(), want)
    for dt, got in soft.items():
        assert same_bits(got.cpu(), demod_tail.norm_ref(*mc, want, dt))
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((f, -1, 128), (f, -1)):
            re, im = fr.to(dtype).reshape(shape), fi.to(dtype).reshape(shape)
            got = stats if dtype == torch.bfloat16 and len(shape) == 3 else \
                demod_tail.stats_cuda(re, im, *m)
            ref = demod_tail.stats_ref(re.cpu(), im.cpu(), *mc)
            assert same_bits(got[0].cpu(), ref[0]) and same_bits(got[1].cpu(), ref[1])


def demod_step_batch(dev):
    """A seeded bf16 batch of the bench multiplex's first two subchannels,
    E = 2 x F = 4, and the step for it on the card."""
    from tpudab_torch.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                                    ServiceSpec, SubchannelSpec, modulate_frame_bits)
    sub = bench_subchannels()[:2]
    spec = EnsembleSpec(0xBE9D, "Tail", [ServiceSpec(0xC201, "T", [(0, ASCTY_DAB_PLUS, 1)])],
                        [SubchannelSpec(c.subch_id, c.start_cu, c.size_cu, ("eep", 3, 0))
                         for c in sub])
    synth = EnsembleSynthesizer(spec, seed=3)
    frames = np.stack([modulate_frame_bits(synth.frame_bits(i)) for i in range(8)])
    step = ReceiveStep(1, sub, n_ensembles=2).to(dev)
    tiled = step.tile_frames(frames).reshape((2, 4) + step.tile_frames(frames).shape[1:])
    re, im = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev, torch.bfloat16)
              for x in (tiled.real, tiled.imag))
    return step, re, im, torch.tensor([0.0, 250.0], device=dev)


def test_receive_step_takes_the_demod_tail(dev, monkeypatch):
    """ReceiveStep on the card with bf16 frames runs the demod's tail as
    the three kernels, once each a step; its outputs (FIC and subchannel
    bytes, mean_power, the tap) are those of the eager chain it replaced:
    bytes equal, mean_power within 1e-6, the tap within 1e-6."""
    from tpudab_torch.ofdm import demod
    step, re, im, freq = demod_step_batch(dev)
    wrappers = (demod_tail.demap_cuda, demod_tail.norm_cuda, demod_tail.stats_cuda)
    n0 = [w.launches for w in wrappers]
    _, got = step(step.init_carry(dev), re, im, freq)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, n0)] == [1, 1, 1]
    monkeypatch.setattr(demod, "_tail_kernels", lambda operands, device: False)
    _, want = step(step.init_carry(dev), re, im, freq)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, n0)] == [1, 1, 1]
    assert torch.equal(got["fic_bytes"], want["fic_bytes"])
    for sid in want["subch"]:
        assert torch.equal(got["subch"][sid], want["subch"][sid])
    torch.testing.assert_close(got["mean_power"], want["mean_power"], rtol=1e-6, atol=0.0)
    for key in ("const_re", "const_im"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-7)


def eager_demod(monkeypatch, step, frames_re, frames_im, freq_hz):
    """step.demod with the graph held off: the eager chain."""
    from tpudab_torch.models import demod_graph
    with monkeypatch.context() as m:
        m.setattr(demod_graph, "engages", lambda device, operands: False)
        return step.demod(frames_re, frames_im, freq_hz)


def same_stats(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("mean_power", "const_re", "const_im"))


def test_demod_graph_replays_the_eager_bits(dev, monkeypatch):
    """ReceiveStep.demod on the same bf16 frames five steps running, the
    frames rewritten in place and the frequency changed each step (a
    tensor, or a number): eager, then a capture and its replay, then
    replays. Each step's soft bits, mean_power, tap and decoded bytes
    equal an eager step's bit for bit; the mean_power and tap of step k,
    held across step k + 1, keep step k's values; each counting wrapper
    (K5, demap, norm, stats) counts one launch a step, replays included."""
    from tpudab_torch.models.demod_graph import counted
    step, re, im, freq = demod_step_batch(dev)
    ref = ReceiveStep(1, step.subchannels, n_ensembles=2).to(dev)
    base_re, base_im = re.clone(), im.clone()
    freqs = [freq, freq + 125.0, freq - 300.0, 777.0, freq * 2.0]
    carry, ref_carry, held = step.init_carry(dev), ref.init_carry(dev), None
    for k, fq in enumerate(freqs):
        re_k, im_k = base_re.roll(k, dims=1), base_im.roll(k, dims=1)
        re.copy_(re_k)
        im.copy_(im_k)
        n0 = [w.launches for w in counted()]
        soft, stats = step.demod(re, im, fq)
        assert [w.launches - n for w, n in zip(counted(), n0)] == [1, 1, 1, 1]
        carry, fic, subch = step.decode_soft(carry, soft)
        want_soft, want_stats = eager_demod(monkeypatch, ref, re_k, im_k, fq)
        ref_carry, want_fic, want_subch = ref.decode_soft(ref_carry, want_soft)
        torch.cuda.synchronize()
        assert torch.equal(soft, want_soft) and same_stats(stats, want_stats)
        assert torch.equal(fic, want_fic)
        assert all(torch.equal(subch[s], want_subch[s]) for s in want_subch)
        if held is not None:
            assert same_stats(*held)
        held = stats, {key: v.clone() for key, v in want_stats.items()}
    g = step.graphs
    assert (g.captures, g.replays, g.eager) == (1, 4, 1)


@pytest.mark.parametrize("activities", [["CUDA"], ["CPU", "CUDA"]], ids=["card", "both"])
def test_demod_graph_not_under_the_profiler(dev, activities):
    """Under torch.profiler (recording the card alone, as the benchmark's
    traced stretch does, or the host too) the demod runs eagerly and its
    spans record; nothing replays until the profiler stops."""
    from tpudab_torch.host.profiling import reset_spans, spans
    step, re, im, freq = demod_step_batch(dev)
    for _ in range(3):
        step.demod(re, im, freq)
    g = step.graphs
    assert (g.captures, g.replays, g.eager) == (1, 2, 1)
    reset_spans()
    acts = [getattr(torch.profiler.ProfilerActivity, a) for a in activities]
    with torch.profiler.profile(activities=acts):
        for _ in range(2):
            step.demod(re, im, freq)
        torch.cuda.synchronize()
    assert (g.captures, g.replays, g.eager) == (1, 2, 3)
    names = [s["name"] for s in spans()]
    for name in ("demod", "demod.carve", "demod.dft", "demod.demap", "demod.norm",
                 "demod.stats"):
        assert names.count(name) == 2, (name, names)
    step.demod(re, im, freq)
    assert (g.captures, g.replays, g.eager) == (1, 3, 3)


def test_demod_graph_hostfeed_two_graphs(dev, monkeypatch):
    """rtl_sdr's u8 frames through a HostFeed: its two buffers alternate
    and give two graphs (eager, eager, capture, capture, replay, replay),
    each step's soft bits and stats equal to an eager step's on the same
    bytes; frames at a third address run eagerly, with the same bits."""
    from tpudab_torch.models.ingest import HostFeed
    step, _, _, freq = demod_step_batch(dev)
    frame_len = get_ofdm_params(1).nb_frame_length
    gen = torch.Generator().manual_seed(7)
    hosts = [torch.randint(0, 256, (2, 4, frame_len, 2), dtype=torch.uint8,
                           generator=gen).pin_memory() for _ in range(6)]
    feed = HostFeed(hosts[0].shape, dev)
    ref = ReceiveStep(1, step.subchannels, n_ensembles=2).to(dev)
    for k, host in enumerate(hosts):
        feed.feed(host)
        soft, stats = step.demod(feed, None, freq + 50.0 * k)
        want_soft, want_stats = eager_demod(monkeypatch, ref, host.to(dev), None,
                                            freq + 50.0 * k)
        torch.cuda.synchronize()
        assert torch.equal(soft, want_soft) and same_stats(stats, want_stats), k
    g = step.graphs
    assert (g.captures, g.replays, g.eager) == (2, 4, 2)
    assert len(g.graphs) == 2
    third = hosts[0].to(dev)
    for _ in range(2):
        soft, stats = step.demod(third, None, freq)
        want_soft, want_stats = eager_demod(monkeypatch, ref, third, None, freq)
        torch.cuda.synchronize()
        assert torch.equal(soft, want_soft) and same_stats(stats, want_stats)
    assert (g.captures, g.replays, g.eager) == (2, 4, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(1, 256), (5, 101), (3, 774 - 6), (70, 3456)],
                         ids=["batch1", "n_odd_T_odd", "fic", "msc"])
def test_viterbi_bits_kernel_equals_plain(dev, b, n, dtype):
    """K1+K3: bits equal to the plain twin, for n not a multiple of 8, an
    odd T (= n + 6), a batch of 1, and all-erasure codewords."""
    rng = np.random.default_rng(b + n)
    mother = torch.from_numpy(rng.standard_normal((b, n + 6, 4), dtype=np.float32))
    mother[: b // 3] = 0.0   # all-erasure codewords: every compare-select ties
    x = mother.to(dev, dtype)
    got = viterbi_decode_bits_cuda(x, signs_on(x.device), n)
    torch.cuda.synchronize()
    want = viterbi_decode_ref(x, signs_on(x.device), n)
    assert got.shape == (b, n) and torch.equal(got, want)
    assert not got[: b // 3].any()


def test_receiver_cuda_equals_cpu(dev):
    """The host per-stage Receiver on the card decodes a 5-frame capture
    (two DAB+ services and a UEP MP2-type one) to the same outputs as on
    the CPU."""
    from tpudab_torch.models.receiver import Receiver
    from tpudab_torch.synth import (ASCTY_DAB, ASCTY_DAB_PLUS, EnsembleSpec,
                                    EnsembleSynthesizer, ServiceSpec, SubchannelSpec)
    from tpudab_torch.synth.payload import dabplus_stream

    spec = EnsembleSpec(0xC0DA, "Cuda Rx",
                        [ServiceSpec(0xC201, "A", [(0, ASCTY_DAB_PLUS, 1)]),
                         ServiceSpec(0xC202, "B", [(0, ASCTY_DAB_PLUS, 2)]),
                         ServiceSpec(0xC203, "C", [(0, ASCTY_DAB, 3)])],
                        [SubchannelSpec(1, 0, 36, ("eep", 3, 0)),
                         SubchannelSpec(2, 36, 72, ("eep", 3, 0)),
                         SubchannelSpec(3, 108, 96, ("uep", 128, 3))])
    synth = EnsembleSynthesizer(spec, seed=1)
    for sid, kbps in ((1, 48), (2, 96)):
        stream, _ = dabplus_stream(kbps, 40, seed=sid, with_pad=True)
        synth.payload_fn[sid] = lambda m, st=stream: st[m].tobytes()
    rng = np.random.default_rng(5)
    bits = np.stack([synth.frame_bits(i) for i in range(5)])
    soft = (1.0 - 2.0 * bits + 0.5 * rng.standard_normal(bits.shape)).astype(np.float32)
    res = {}
    for d in ("cpu", dev):
        rx = Receiver(1, d)
        outs = [rx.process_frame_bits(soft[:3]), rx.process_frame_bits(soft[3:]), rx.finalize()]
        res[str(d)] = (rx.stats, {sid: [(o.raw_frames.tobytes(), [tuple(sf.access_units)
                                                                  for sf in o.superframes])
                                        for o in [out[sid] for out in outs if sid in out]]
                                  for sid in (1, 2, 3)},
                       {k: (c.chosen, c.locked) for k, c in rx.uep_calibrations.items()})
    assert res["cpu"][0]["fib_crc_errors"] == 0
    assert res[str(dev)] == res["cpu"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_variant_equals_plain(dev, variant, dtype):
    """Every forward variant, in every soft dtype, equals its twin
    (decisions and path metrics), and counts one launch per call."""
    rng = np.random.default_rng(11)
    if dtype == torch.int16:
        x = torch.from_numpy(rng.integers(-127, 128, (64, 8, 70)).astype(np.int16))
    else:
        x = torch.from_numpy(rng.standard_normal((64, 8, 70), dtype=np.float32)).to(dtype)
    x[:, :, :5] = 0   # all-erasure codewords: every compare-select ties
    signs = signs_on(dev)
    rebase = 4 if dtype == torch.int16 else 16
    n0 = fwd_variant_cuda.launches
    d, pm = fwd_variant_cuda(x.to(dev), signs, variant, rebase)
    torch.cuda.synchronize()
    assert fwd_variant_cuda.launches == n0 + 1
    td, tpm = fwd_variant_ref(x.to(dev), signs, variant, rebase)
    assert torch.equal(d, td) and torch.equal(pm, tpm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int16])
@pytest.mark.parametrize("variant", ["full", "noacs", "dbuf"])
def test_forward_variant_ragged_batch(dev, variant, dtype):
    """A batch of 37 codewords, not a multiple of the 8 or 16 per block."""
    rng = np.random.default_rng(15)
    if dtype == torch.int16:
        x = torch.from_numpy(rng.integers(-127, 128, (48, 8, 37)).astype(np.int16))
    else:
        x = torch.from_numpy(rng.standard_normal((48, 8, 37), dtype=np.float32)).to(dtype)
    rebase = 4 if dtype == torch.int16 else 16
    d, pm = fwd_variant_cuda(x.to(dev), signs_on(dev), variant, rebase)
    torch.cuda.synchronize()
    td, tpm = fwd_variant_ref(x.to(dev), signs_on(dev), variant, rebase)
    assert torch.equal(d, td) and torch.equal(pm, tpm)


def test_kernels_refuse_other_sign_tables(dev):
    """The kernels' branch-metric table is DAB's: another sign table raises."""
    x = torch.zeros((16, 8, 3), device=dev)
    with pytest.raises(ValueError, match="mother code"):
        viterbi_decode_bytes_t_cuda(x, -signs_on(dev), 8)


@pytest.mark.parametrize("mode", ["shuffle", "masked", "tree"])
def test_traceback_mode_equals_plain(dev, mode):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((64, 8, 133), dtype=np.float32)).to(dev)
    decs, _ = fwd_variant_cuda(x, signs_on(dev), "full", 16)
    n0 = traceback_bytes_cuda.launches
    got = traceback_bytes_cuda(decs, mode, n_out=15)
    torch.cuda.synchronize()
    assert traceback_bytes_cuda.launches == n0 + 1
    assert torch.equal(got, traceback_bytes_ref(decs, mode, n_out=15))


def tie_decisions(rng, b, groups):
    """Packed decisions (B, G, 64): random bytes, and in every third
    codeword the all-tie rows of an erased codeword (every decision 0, as
    the forward pass takes the lower predecessor on a tie)."""
    decs = torch.from_numpy(rng.integers(0, 256, (b, groups, 64)).astype(np.uint8))
    decs[::3] = 0
    return decs


@pytest.mark.parametrize("mode", ["shuffle", "masked", "tree"])
@pytest.mark.parametrize("b,groups,n_out", [(1, 1, 1), (6, 7, 7), (37, 33, 30), (5, 450, 449),
                                            (70, 64, 64)])
def test_traceback_mode_ragged(dev, mode, b, groups, n_out):
    """Each mode at batches that are not a multiple of the codewords per
    block (4 warps; 32 tree threads) and at G not a multiple of a stage (8
    rows), of the ring or of a 32-group output window, n_out < G: equal to
    the twin and to the group-map twin."""
    rng = np.random.default_rng(b * 1000 + groups)
    decs = tie_decisions(rng, b, groups)
    got = traceback_bytes_cuda(decs.to(dev), mode, n_out)
    torch.cuda.synchronize()
    want = traceback_bytes_ref(decs, mode, n_out)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, traceback_maps_ref(decs, mode, n_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t2p,b", [(16, 3), (48, 17), (272, 9), (1744, 33), (16, 4243),
                                   (48, 4501), (16, 6501), (272, 7003)])
def test_viterbi_kernel_ragged_groups(dev, t2p, b, dtype):
    """K1+K2 at G = T2p / 4 of 4, 12, 68 and 436 groups (not multiples of
    the 8-row stage or the 32-group window), ragged B (4243 and 4501 past
    one warp a codeword's 32 an SM on a card of 132 SMs: two butterflies a
    thread; 6501 and 7003 past their 48: four; both in blocks of 16
    codewords), n_data_bits short of 2 T2p by 3 bytes; a fifth of the
    codewords erased (ties)."""
    rng = np.random.default_rng(t2p + b)
    soft_t = torch.from_numpy(rng.standard_normal((t2p, 8, b), dtype=np.float32))
    soft_t[:, :, : b // 5] = 0.0
    soft_t = soft_t.to(dev, dtype)
    n = 2 * t2p - 24
    got = viterbi_decode_bytes_t_cuda(soft_t, signs_on(dev), n)
    torch.cuda.synchronize()
    assert torch.equal(got, viterbi_decode_bytes_t_ref(soft_t, signs_on(dev), n))


def test_viterbi_kernel_layout_launches(dev):
    """Each launch counts once in .launches and once under the layout that
    k12_layout picked for its B on this card; a batch in each of the rule's
    three ranges takes each layout, all bit-equal to the twin."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launches0, layouts0 = (viterbi_decode_bytes_t_cuda.launches,
                           dict(viterbi_decode_bytes_t_cuda.layout_launches))
    rng = np.random.default_rng(5)
    for b in (300, WARP_LAYOUT_CODEWORDS_PER_SM * sms + 5,
              BFLY_LAYOUT_CODEWORDS_PER_SM * sms + 5):
        soft_t = torch.from_numpy(rng.standard_normal((32, 8, b), dtype=np.float32))
        soft_t[:, :, : b // 5] = 0.0
        soft_t = soft_t.to(dev, torch.bfloat16)
        got = viterbi_decode_bytes_t_cuda(soft_t, signs_on(dev), 40)
        torch.cuda.synchronize()
        assert torch.equal(got, viterbi_decode_bytes_t_ref(soft_t, signs_on(dev), 40))
    counts = viterbi_decode_bytes_t_cuda.layout_launches
    assert viterbi_decode_bytes_t_cuda.launches == launches0 + 3
    assert {k: counts[k] - layouts0.get(k, 0) for k in (WARP_LAYOUT, BFLY_LAYOUT,
                                                         BFLY4_LAYOUT)} == \
        {WARP_LAYOUT: 1, BFLY_LAYOUT: 1, BFLY4_LAYOUT: 1}


@pytest.mark.parametrize("b,t,n", [(1, 20, 13), (5, 270, 203), (70, 1550, 1541)])
def test_viterbi_bits_kernel_ragged_groups(dev, b, t, n):
    """K1+K3 at T whose groups (T2p / 4 = 4, 36, 196) are not multiples of
    a stage or an output window, n_bits not a multiple of 8 (the 8-byte
    stores' masked tail), ragged B with erased codewords."""
    rng = np.random.default_rng(b + t)
    mother = torch.from_numpy(rng.standard_normal((b, t, 4), dtype=np.float32))
    mother[::4] = 0.0
    x = mother.to(dev)
    got = viterbi_decode_bits_cuda(x, signs_on(dev), n)
    torch.cuda.synchronize()
    assert torch.equal(got, viterbi_decode_ref(x, signs_on(dev), n))


@pytest.mark.parametrize("op", list(I16_OPS))
def test_i16_probe_ragged_and_unaligned(dev, op):
    """(12, 13): a size that is not a multiple of the 8 elements a thread
    takes; then the same on views 2 bytes past a 16-byte boundary (the
    element-wise path)."""
    rng = np.random.default_rng(16)
    x, y = (torch.from_numpy(rng.integers(-32768, 32768, (12, 13)).astype(np.int16)).to(dev)
            for _ in range(2))
    got = i16_probe_cuda(x, y, op)
    torch.cuda.synchronize()
    assert torch.equal(got, i16_probe_ref(x, y, op))
    xs, ys = (torch.empty(1 + 16 * 24, dtype=torch.int16, device=dev) for _ in range(2))
    xo, yo = xs[1:].view(16, 24), ys[1:].view(16, 24)
    xo.copy_(torch.from_numpy(rng.integers(-32768, 32768, (16, 24)).astype(np.int16)))
    yo.copy_(torch.from_numpy(rng.integers(-32768, 32768, (16, 24)).astype(np.int16)))
    got = i16_probe_cuda(xo, yo, op)
    torch.cuda.synchronize()
    assert torch.equal(got, i16_probe_ref(xo, yo, op))


@pytest.mark.parametrize("op", list(I16_OPS))
def test_i16_probe_equals_plain(dev, op):
    rng = np.random.default_rng(13)
    x, y = (torch.from_numpy(rng.integers(-32768, 32768, (64, 256)).astype(np.int16)).to(dev)
            for _ in range(2))
    n0 = i16_probe_cuda.launches
    got = i16_probe_cuda(x, y, op)
    torch.cuda.synchronize()
    assert i16_probe_cuda.launches == n0 + 1
    assert torch.equal(got, i16_probe_ref(x, y, op))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("roll,rotate", [(True, True), (False, True), (True, False),
                                         (False, False)])
@pytest.mark.parametrize("fb", [1, 3, 8, 16])
def test_carve_variant_equals_plain(dev, fb, roll, rotate, dtype):
    """Bit-equal to the twin at 5 frames (fb 3, 8 and 16 leave a ragged
    last block): the kernel rounds the twin's f32 products one by one."""
    rng = np.random.default_rng(14)
    fr, fi = (torch.from_numpy(rng.standard_normal((5, 1536, 128), dtype=np.float32))
              .to(dev, dtype) for _ in range(2))
    freq = torch.tensor([1999.0, -2000.0, 0.0, 731.5, 12.25], device=dev)
    n0 = carve_variant_cuda.launches
    xr, xi = carve_variant_cuda(fr, fi, freq, fb, roll, rotate)
    torch.cuda.synchronize()
    assert carve_variant_cuda.launches == n0 + 1
    rr, ri = carve_variant_ref(fr, fi, freq, fb, roll, rotate)
    assert same_bits(xr, rr) and same_bits(xi, ri)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_carve_variant_full_equals_k5(dev, dtype):
    """Roll and rotate on, every fb gives K5's xr and xi bit for bit: one
    kernel body."""
    rng = np.random.default_rng(15)
    fr, fi = (torch.from_numpy(rng.standard_normal((5, 1536, 128), dtype=np.float32))
              .to(dev, dtype) for _ in range(2))
    freq = torch.tensor([1999.0, -2000.0, 0.0, 731.5, 12.25], device=dev)
    kr, ki = carve_rotate_cuda(fr, fi, freq)
    for fb in (1, 3, 8, 16):
        xr, xi = carve_variant_cuda(fr, fi, freq, fb)
        torch.cuda.synchronize()
        assert same_bits(xr, kr) and same_bits(xi, ki)


def test_carve_variant_refuses_misaligned(dev):
    """A contiguous view 4 bytes past a 16-byte boundary raises."""
    n = 2 * 1536 * 128
    good = torch.zeros((2, 1536, 128), device=dev)
    bad = torch.zeros(n + 1, device=dev)[1:].view(2, 1536, 128)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        carve_variant_cuda(bad, good, 0.0)
    with pytest.raises(ValueError, match="aligned"):
        carve_variant_cuda(good, bad, 0.0, 8, False, False)


def test_entry_points_default_to_the_card(dev, tmp_path):
    """Receiver, SubchannelDecoder, the FIC decode of a numpy input and
    load_carry run on the card when no device is given."""
    from tpudab_torch.constants.dab_params import get_dab_params
    from tpudab_torch.fic.fib import decode_fic_frame
    from tpudab_torch.models.receiver import Receiver
    from tpudab_torch.msc.subchannel import SubchannelConfig, SubchannelDecoder
    assert Receiver(1).device.type == "cuda"
    cfg = SubchannelConfig(1, 0, 24, eep_profile(24, 3, 0))
    assert SubchannelDecoder(cfg).device.type == "cuda"
    n0 = viterbi_decode_bits_cuda.launches
    fibs, _ = decode_fic_frame(np.ones((1, get_dab_params(1).nb_fic_bits), np.float32))
    assert fibs.shape == (12, 32) and viterbi_decode_bits_cuda.launches == n0 + 1
    from tpudab_torch.models.checkpoint import load_carry, save_carry
    save_carry(str(tmp_path / "c"), {"deint_1": torch.zeros((15, 16))})
    assert load_carry(str(tmp_path / "c"))[0]["deint_1"].device.type == "cuda"


def impaired_capture(n_frames, imp, seed=1):
    """A 24-CU EEP 3-A DAB+ service with a known payload, n_frames frames
    through the port's impairments."""
    from tpudab_torch.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                                    Impairments, ServiceSpec, SubchannelSpec,
                                    apply_impairments, modulate_frame_bits)
    spec = EnsembleSpec(0xACC1, "Cuda Acq", [ServiceSpec(0xC201, "A", [(0, ASCTY_DAB_PLUS, 1)])],
                        [SubchannelSpec(1, 0, 24, ("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=seed)
    data = np.random.default_rng(seed).integers(0, 256, (4 * n_frames, 96)).astype(np.uint8)
    synth.payload_fn[1] = lambda m: data[m].tobytes()
    iq = np.concatenate([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)])
    return apply_impairments(iq, Impairments(**imp)), data


def test_acquire_device_cuda_equals_cpu(dev):
    """A batch of three buffers (CFO and delay; a large negative CFO; a
    late strong echo): frame_start and coarse_bins equal on the card and
    the CPU, the Hz within 1 Hz, the qualities within a relative 1e-3."""
    from tpudab_torch.ofdm.sync_device import acquire_device, acquire_host
    imps = [dict(freq_offset_hz=3400.0, delay_samples=7777, snr_db=15, seed=1),
            dict(freq_offset_hz=-47350.0, delay_samples=123, snr_db=10, seed=2),
            dict(freq_offset_hz=800.0, snr_db=15, amplitude=0.63,
                 multipath=((400, 1.0, 2.1), (150, 0.35, 0.7)), seed=9)]
    iqs = [impaired_capture(3, imp, seed=i)[0] for i, imp in enumerate(imps)]
    n = min(x.shape[0] for x in iqs)
    re = torch.from_numpy(np.stack([x.real[:n] for x in iqs]).astype(np.float32))
    im = torch.from_numpy(np.stack([x.imag[:n] for x in iqs]).astype(np.float32))
    cpu = acquire_device(re, im)
    gpu = acquire_device(re.to(dev), im.to(dev))
    for k in ("frame_start", "coarse_bins"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    for k in ("coarse_hz", "fine_hz", "net_freq_hz"):
        assert (gpu[k].cpu() - cpu[k]).abs().max().item() < 1.0, k
    for k in ("null_quality", "coarse_quality", "time_quality"):
        assert ((gpu[k].cpu() - cpu[k]).abs() <= 1e-3 * cpu[k].abs()).all(), k
    assert gpu["frame_start"][:2].tolist() == [7777, 123]
    one = acquire_host(iqs[0])                 # the card by default
    assert one["frame_start"] == 7777 and one["coarse_bins"] == 3


def test_acquire_device_cuda_equals_acquire_np(dev):
    """acquire_device on the card, one batch of three buffers (CFO and delay;
    a large negative CFO; 1.5 carrier spacings), against the port's numpy
    oracle acquire_np on each: frame_start and coarse_bins equal, the net
    frequency within 1 Hz (chip_smoke.py's ORACLE_HZ)."""
    from tpudab_torch.ofdm.sync_device import acquire_device
    from tpudab_torch.ofdm.sync_np import acquire_np
    imps = [dict(freq_offset_hz=3400.0, delay_samples=7777, snr_db=15, seed=1),
            dict(freq_offset_hz=-47350.0, delay_samples=123, snr_db=10, seed=2),
            dict(freq_offset_hz=1500.0, delay_samples=40_000, snr_db=12, seed=3)]
    iqs = [impaired_capture(3, imp, seed=i)[0] for i, imp in enumerate(imps)]
    n = min(x.shape[0] for x in iqs)
    re = torch.from_numpy(np.stack([x.real[:n] for x in iqs]).astype(np.float32)).to(dev)
    im = torch.from_numpy(np.stack([x.imag[:n] for x in iqs]).astype(np.float32)).to(dev)
    gpu = {k: v.cpu() for k, v in acquire_device(re, im).items()}
    for i, (x, imp) in enumerate(zip(iqs, imps)):
        ref = acquire_np(x[:n])
        assert gpu["frame_start"][i].item() == ref["frame_start"] == imp["delay_samples"]
        assert gpu["coarse_bins"][i].item() == ref["coarse_bins"]
        assert abs(gpu["net_freq_hz"][i].item() - ref["net_freq_hz"]) < 1.0, i


def test_checkpoint_bf16_carry_round_trip_on_cuda(dev, tmp_path):
    from tpudab_torch.models.checkpoint import load_carry, save_carry
    bits = torch.randint(-32768, 32767, (15, 1536), dtype=torch.int16,
                         generator=torch.Generator().manual_seed(3))
    carry = {"deint_1": bits.view(torch.bfloat16).to(dev),
             "deint_2": bits.flip(0).contiguous().view(torch.bfloat16).to(dev)}
    save_carry(str(tmp_path / "c"), carry, {"next_pos": 7})
    back, extra = load_carry(str(tmp_path / "c"), dev)
    assert extra == {"next_pos": 7, "carry_dtype": "bfloat16"}
    for k, v in carry.items():
        assert back[k].device == v.device and back[k].dtype == torch.bfloat16
        assert torch.equal(back[k].view(torch.int16), v.view(torch.int16))


@pytest.mark.parametrize("device_step", [False, True], ids=["host", "step"])
def test_decode_iq_cuda_equals_cpu(dev, device_step):
    """The offline pipeline on the card (acquisition, K5, K4 and the
    Viterbi kernels) decodes the bytes the CPU run decodes."""
    from tpudab_torch.models.pipeline import decode_iq
    from tpudab_torch.models.receiver import Receiver
    iq, data = impaired_capture(8, dict(freq_offset_hz=1234.0, delay_samples=777, snr_db=18,
                                        seed=3))
    rows = {}
    for d in ("cpu", dev):
        rx, acc, stats = decode_iq(iq, batch_frames=4, use_device_step=device_step,
                                   receiver=Receiver(1, d, decode_audio=False))
        rows[str(d)] = (np.concatenate([o.raw_frames for o in acc[1] if len(o.raw_frames)]),
                        rx.stats, stats.frame_start)
    cpu, gpu = rows["cpu"], rows[str(dev)]
    np.testing.assert_array_equal(gpu[0], cpu[0])
    assert gpu[1:] == cpu[1:] and cpu[1]["fib_crc_errors"] == 0
    np.testing.assert_array_equal(gpu[0][1:], data[1: gpu[0].shape[0]])


def test_streaming_radio_cuda_equals_cpu(dev):
    """The live loop on the card: the device step by default (K5, K4 mode
    (b), K1+K2 once the FIC has the layout, after a first batch on the host
    path), the host path on request (K5, K4 mode (a), K1+K3), each decoding
    the bytes and counting the stats of the CPU radio."""
    from tpudab_torch.host.streaming import StreamingRadio
    iq, data = impaired_capture(8, dict(freq_offset_hz=1234.0, delay_samples=777, snr_db=18,
                                        seed=3))

    def stream(device, **kw):
        pos = [0]

        def source(n):
            lo = pos[0]
            pos[0] = min(lo + n, iq.shape[0])
            return iq[lo: pos[0]]
        radio, got = StreamingRadio(source, batch_frames=4, device=device, **kw), []
        radio.run(on_outputs=lambda outs: got.extend(
            o.raw_frames for o in outs.values() if o.raw_frames is not None and len(o.raw_frames)))
        counts = (radio.stats.total_frames, radio.stats.reacquisitions,
                  radio.stats.timing_adjustments, radio.stats.coarse_adjustments)
        return radio, np.concatenate(got), counts

    wrappers = (viterbi_decode_bytes_t_cuda, deinterleave_depuncture_t_cuda, carve_rotate_cuda,
                viterbi_decode_bits_cuda, deinterleave_cuda)
    _, want, counts = stream("cpu")
    for device_step in (True, False):
        for w in wrappers:
            w.launches = 0
        radio, got, got_counts = stream(dev, **({} if device_step else
                                                {"use_device_step": False}))
        assert radio.use_device_step is device_step
        assert (radio._driver.step is not None) is device_step
        np.testing.assert_array_equal(got, want)
        assert got_counts == counts and radio.receiver.stats["fib_crc_errors"] == 0
        launched = [w.launches > 0 for w in wrappers]
        assert launched == ([True] * 5 if device_step else
                            [False, False, True, True, True]), launched
    np.testing.assert_array_equal(want[1:], data[1: want.shape[0]])


# ---------------- the wideband channeliser (csrc/channelise.cu) ----------------

def wide_batch(dev, f, seed, receivers=1):
    """A plan of `receivers` HackRF-style receivers (8 Band III blocks each),
    its Channeliser on the card, random s8 streams of f frames, a random
    tail and random frame offsets (the extremes included)."""
    from tpudab_torch.ofdm.channelise import ChannelPlan, Channeliser
    plan = ChannelPlan.band_iii([181e6, 195e6, 209e6, 223e6][:receivers])
    ch = Channeliser(plan).to(dev)
    frame_len = get_ofdm_params(1).nb_frame_length
    rng = np.random.default_rng(seed)
    n = 8 * f * frame_len
    streams = torch.from_numpy(rng.integers(-128, 128, (receivers, n, 2), dtype=np.int8)).to(dev)
    tail = ch.init_tail(dev)
    tail.copy_(torch.from_numpy(rng.integers(-128, 128, tuple(tail.shape), dtype=np.int8)))
    offsets = rng.integers(0, frame_len, plan.n_ensembles)
    offsets[:2] = (0, frame_len - 1)
    return ch, plan, tail, streams, torch.from_numpy(offsets).to(dev)


def rel_rms(got_re, got_im, want_re, want_im):
    d = (got_re.double() - want_re.double()) ** 2 + (got_im.double() - want_im.double()) ** 2
    return float((d.sum() / (want_re.double() ** 2 + want_im.double() ** 2).sum()).sqrt())


@pytest.mark.parametrize("f", [1, 16])
def test_channelise_kernel_equals_twins(dev, f):
    """The channeliser kernel on one receiver, at the cell's 16 frames and at
    1 (where the tail outlasts the new samples): one launch; the next tail
    the stream's last T samples exactly; the frames against the kernel's
    arithmetic in torch (channelise_tables_ref, the same f16 taps, f32 sums
    in another order: every output within one bf16 ulp, at most 2^-7 of
    its magnitude, plus 2e-6, what f32 sums of 240 products of up to 16 can
    err by after the 1/128 scale where they cancel; 99% bit-equal) and against
    the plain conv1d path (f32 taps: relative RMS error under 1.5e-3, two
    bf16 roundings of 2^-9 RMS each and the f16 taps' 2^-12)."""
    from tpudab_torch.ofdm.channelise import channelise_ref, channelise_tables_ref
    from tpudab_torch.ops.channelise_cuda import channelise_cuda
    torch.backends.cudnn.allow_tf32 = False
    ch, plan, tail, streams, offsets = wide_batch(dev, f, 40 + f)
    n0 = channelise_cuda.launches
    new_tail, re, im = ch(tail, streams, offsets)
    torch.cuda.synchronize()
    assert channelise_cuda.launches == n0 + 1 and ch.launches == 1 and ch.calls == 1
    assert ch.samples_in == streams.shape[1]
    want_tail = torch.cat([tail, streams], dim=1)[:, -ch.n_tail:]
    assert torch.equal(new_tail, want_tail)
    t_re, t_im = torch.empty_like(re), torch.empty_like(im)
    channelise_tables_ref(tail, streams, offsets.cpu(), plan, ch.b_taps, ch.scale, t_re, t_im)
    for got, want in ((re, t_re), (im, t_im)):
        g, w = got.float(), want.float()
        excess = ((g - w).abs() - w.abs() * 2 ** -7).max()
        same = float((got == want).float().mean())
        assert float(excess) <= 2e-6 and same > 0.99, (float(excess), same)
    cpu_re, cpu_im = torch.empty(re.shape, dtype=re.dtype), torch.empty(im.shape, dtype=im.dtype)
    channelise_ref(tail.cpu(), streams.cpu(), offsets.cpu(), plan, cpu_re, cpu_im)
    assert rel_rms(re.cpu(), im.cpu(), cpu_re, cpu_im) < 1.5e-3


def test_channelise_kernel_chunks_equal_whole(dev):
    """Four receivers: two steps of 2 frames, the tail carried, give the
    second half of one 4-frame run's outputs bit for bit (the same kernel
    on the same windows)."""
    ch, plan, tail, streams, offsets = wide_batch(dev, 4, 7, receivers=4)
    n = streams.shape[1] // 2
    t1, _, _ = ch(tail, streams[:, :n].contiguous(), offsets)
    _, re2, im2 = ch(t1, streams[:, n:].contiguous(), offsets)
    re2, im2 = re2.clone(), im2.clone()
    _, re, im = ch(tail, streams, offsets)
    torch.cuda.synchronize()
    assert torch.equal(re2, re[:, 2:]) and torch.equal(im2, im[:, 2:])


def test_wide_step_graph_replay_equals_eager(dev, monkeypatch):
    """ReceiveStep with a plan of one receiver through a HostFeed of s8 bytes,
    four steps: the demod graph captures on the channeliser's frames buffer
    and replays, and every step's bytes, mean_power and tap equal those of
    the same step with the graph held off, bit for bit; the channeliser
    counts one call, its samples and one launch a step."""
    from tpudab_torch.models import demod_graph
    from tpudab_torch.models.ingest import HostFeed
    from tpudab_torch.ofdm.channelise import ChannelPlan
    plan = ChannelPlan.band_iii([195e6], first="7A")
    frame_len = get_ofdm_params(1).nb_frame_length
    rng = np.random.default_rng(3)
    hosts = [torch.from_numpy(rng.integers(-128, 128, (1, 8 * 2 * frame_len, 2),
                                           dtype=np.int8)).pin_memory() for _ in range(4)]
    freq = torch.linspace(-3000.0, 3000.0, 8, device=dev)
    offsets = torch.arange(8, device=dev) * 20000
    outs = {}
    for graphs in (True, False):
        step = ReceiveStep(1, bench_subchannels(), n_ensembles=8, channels=plan).to(dev)
        feed = HostFeed(hosts[0].shape, dev)
        carry, got = step.init_carry(dev), []
        with monkeypatch.context() as m:
            if not graphs:
                m.setattr(demod_graph, "engages", lambda device, operands: False)
            for host in hosts:
                feed.feed(host.view(torch.uint8))
                carry, out = step(carry, feed, None, freq, offsets)
                got.append({"fic": out["fic_bytes"].cpu(),
                            **{f"s{k}": v.cpu() for k, v in out["subch"].items()},
                            **{k: out[k].cpu() for k in ("mean_power", "const_re", "const_im")}})
        outs[graphs] = got
        assert (step.ddc.calls, step.ddc.launches) == (4, 4)
        assert step.ddc.samples_in == 4 * hosts[0].shape[1]
        assert feed.bytes_copied == 4 * hosts[0].numel()
        if graphs:
            assert (step.graphs.captures, step.graphs.replays) == (1, 3)
    for a, b in zip(outs[True], outs[False]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_channelise_refuses_offsets_out_of_range_on_the_card(dev):
    """Frame offsets outside [0, frame_len) on the card are refused before
    the kernel runs (it would leave part of those frames unwritten): a
    tensor on the card is read once and again after it changes in place;
    a list is checked on the host."""
    from tpudab_torch.ops.channelise_cuda import channelise_cuda
    ch, plan, tail, streams, offsets = wide_batch(dev, 1, 11)
    frame_len = get_ofdm_params(1).nb_frame_length
    n0 = channelise_cuda.launches
    ch(tail, streams, offsets)
    ch(tail, streams, offsets)
    offsets[3] = frame_len
    with pytest.raises(ValueError):
        ch(tail, streams, offsets)
    offsets[3] = -1
    with pytest.raises(ValueError):
        ch(tail, streams, offsets)
    with pytest.raises(ValueError):
        ch(tail, streams, [0] * 7 + [frame_len])
    torch.cuda.synchronize()
    assert channelise_cuda.launches == n0 + 2 and ch.calls == 2


def test_bench6_and_rtl6_paths_launch_no_channeliser(dev):
    """A step without a plan has no channeliser and no "ddc" carry; on bf16
    frames and on rtl_sdr's u8 frames it launches K5 once and the
    channeliser never, as before the wideband front end."""
    from tpudab_torch.ops.channelise_cuda import channelise_cuda
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=2).to(dev)
    assert step.ddc is None and "ddc" not in step.init_carry(dev)
    frame_len = get_ofdm_params(1).nb_frame_length
    u8 = torch.randint(0, 256, (2, 2, frame_len, 2), dtype=torch.uint8, device=dev)
    re = torch.randn(2, 2, frame_len // 128, 128, device=dev).to(torch.bfloat16)
    n_ch, n_k5 = channelise_cuda.launches, carve_rotate_cuda.launches
    step(step.init_carry(dev), re, re.clone(), 0.0)
    step(step.init_carry(dev), u8, None, 0.0)
    torch.cuda.synchronize()
    assert channelise_cuda.launches == n_ch and carve_rotate_cuda.launches == n_k5 + 2


def test_carve_and_stats_u8_at_starts_equal_twins(dev):
    """A tracked stream's frames: K5 and stats_kernel on u8 segments at
    per-frame starts, every start mod 8 among them (the frames' loads
    shifted), bit-equal to their twins on the gathered frames, on the
    card."""
    from tpudab_torch.ops.carve import u8_frames_at

    n = get_ofdm_params(1).nb_frame_length
    e, f, seg = 3, 3, 3 * n + 1024
    buf = torch.randint(0, 256, (e, seg, 2), dtype=torch.uint8, device=dev)
    rel = torch.tensor([[0, n + 1, 2 * n + 515], [3, n + 6, 2 * n + 7],
                        [500, n + 500 + 2, 2 * n + 999]], dtype=torch.int64)
    starts = (rel + torch.arange(e)[:, None] * seg).reshape(-1).to(dev)
    freq = torch.tensor([1999.0, -2000.0, 731.5, 5731.0, -5600.5, 0.0, 13.0, -13.0, 99.0],
                        device=dev)
    got = carve_rotate_cuda(buf, None, freq, 1, with_sum=True, starts=starts)
    frames = u8_frames_at(buf, starts, n)
    want = carve_rotate_tables_ref(frames, None, freq, 1, with_sum=True)
    aligned = carve_rotate_cuda(frames, None, freq, 1, with_sum=True)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, aligned):
        assert same_bits(g, w) and same_bits(g, a)
    m = [x.reshape(e * f, 76, -1)[:, :, :1536].contiguous() for x in want]
    mp, tap = demod_tail.stats_cuda(buf, None, *m, starts=starts, frame_len=n)
    mp_a, tap_a = demod_tail.stats_cuda(frames, None, *m)
    torch.cuda.synchronize()
    mp_r, tap_r = demod_tail.stats_ref(buf.cpu(), None, *(x.cpu() for x in m),
                                       starts=starts.cpu(), frame_len=n)
    assert same_bits(mp, mp_a) and same_bits(tap, tap_a)
    assert same_bits(mp.cpu(), mp_r) and same_bits(tap.cpu(), tap_r)


def test_tracker_matches_track_ref_at_32x16(dev):
    """The tracked step at the cell's shape, 32 dongles x 16 frames within
    +-25 ppm: two steps of ReceiveStep.demod_stream on the card against
    ofdm/track_ref.py from the same state on the same segments: the starts
    and the consumed counts equal, the rate within 1e-9, the CFO within
    0.05 Hz, every frame's mean power within 1e-6 and the tap within 0.02
    RMS."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import harness
    from tpudab_torch.ofdm import track_ref

    cell = harness.load_cell("rtl6free.drift32x16")
    drv = harness.driver_module(cell)
    e, f = 32, 16
    step = ReceiveStep(1, tuple(drv._step.subchannel_configs(cell.config)), n_ensembles=e,
                       track_frames=f).to(dev)
    seg_len = step.track.segment_len
    streams = drv.drift_streams(cell.config, cell.traffic, 2 ** 31 + 5, dev, seg_len)
    period = np.array([r.shape[0] - seg_len for r in streams.rings])
    ptr = (period - streams.lead) % period

    def segments():
        return torch.stack([r[int(p):int(p) + seg_len] for r, p in zip(streams.rings, ptr)])
    acq = step.track.acquire(segments().to(dev))
    ptr = (ptr + acq["advance"].cpu().numpy()) % period
    state = step.track.train(segments().to(dev), acq)
    carry = {**step.init_carry(dev), "track": state}
    owed = state["c_prev"].cpu().numpy()
    for k in range(2):
        seg = segments()
        ref = track_ref.track_step(seg, carry["track"], f)
        carry, soft, stats = step.demod_stream(carry, seg.to(dev))
        torch.cuda.synchronize()
        got = carry["track"]
        assert torch.equal(step.track.starts.view(e, f).cpu() - torch.arange(e)[:, None] * seg_len,
                           ref["starts"])
        assert torch.equal(stats["consumed"].cpu(), ref["consumed"])
        assert torch.equal(got["c_prev"].cpu(), ref["state"]["c_prev"])
        assert bool(got["locked"].all()) and bool(ref["state"]["locked"].all())
        assert torch.allclose(got["rate"].cpu(), ref["state"]["rate"], atol=1e-9, rtol=0)
        assert torch.allclose(got["rs"].cpu(), ref["state"]["rs"], atol=1e-6, rtol=0)
        assert torch.allclose((got["coarse_hz"] + got["fine_hz"]).cpu(),
                              ref["state"]["coarse_hz"] + ref["state"]["fine_hz"], atol=0.05,
                              rtol=0)
        mp = stats["mean_power"].double().cpu().view(e, f)
        assert ((mp - ref["mean_power"]).abs() / ref["mean_power"]).max() < 1e-6
        tap = torch.stack([stats["const_re"], stats["const_im"]]).double().cpu()
        assert ((tap - ref["tap"]) ** 2).sum(dim=0).mean().sqrt() < 0.02
        ptr = (ptr + owed) % period
        owed = stats["consumed"].cpu().numpy()


def test_tracked_demod_graph_replays_the_eager_bits(dev):
    """ReceiveStep.demod_stream on one segment buffer and one state: eager
    at the buffer's first sighting, captured at its second, replayed
    after, the tracker's cut and update inside the one demod graph; every
    call gives the same soft bits, stats, next state and consumed counts
    bit for bit, and the tracker's counters count the replays too."""
    e, f = 4, 3
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=e, track_frames=f).to(dev)
    track = step.track
    seg = torch.randint(0, 256, (e, track.segment_len, 2), dtype=torch.uint8, device=dev)
    state = {"rs": torch.tensor([512.0, 700.25, 9.5, 300.0], dtype=torch.float64, device=dev),
             "rate": torch.full((e,), 1.0 + 20e-6, dtype=torch.float64, device=dev),
             "coarse_hz": torch.tensor([2000.0, -5000.0, 0.0, 1000.0], dtype=torch.float64,
                                       device=dev),
             "fine_hz": torch.tensor([12.5, -3.0, 0.0, 400.0], dtype=torch.float64, device=dev),
             "c_prev": torch.full((e,), f * track.frame_len, dtype=torch.int64, device=dev),
             "quality": torch.ones(e, device=dev), "locked": torch.ones(e, dtype=torch.bool,
                                                                           device=dev)}
    carry = {**step.init_carry(dev), "track": state}
    outs = []
    for _ in range(4):
        _, soft, stats = step.demod_stream(carry, seg)
        outs.append((soft.clone(), stats))
    torch.cuda.synchronize()
    g = step.graphs
    assert (g.eager, g.captures, g.replays) == (1, 1, 3)
    assert track.counters()["calls"] == 4
    want_soft, want = outs[0]
    for soft, stats in outs[1:]:
        assert torch.equal(soft.view(torch.int16), want_soft.view(torch.int16))
        assert stats.keys() == want.keys()
        for k, v in stats.items():
            assert torch.equal(v.view(torch.int8), want[k].view(torch.int8)), k

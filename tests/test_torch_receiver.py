"""The port's host per-stage path against tpudab's, on the CPU: the whole
Receiver, the decode-bits command, and a mid-stream handoff of a
SubchannelDecoder. Frame soft bits come from tpudab's synthesiser
(1 - 2b plus seeded Gaussian noise). Tolerance: none; the database,
stats, raw frames, AUs, MP2 frames, slides, dynamic labels, calibration
results, payload files and database listing must all be equal."""

import importlib
import os

import numpy as np
import pytest
import torch

from test_torch_parsers import db_state, one_torch_thread, plain  # noqa: F401
from tpudab.constants.dab_params import CIF_BITS, CU_BITS, get_dab_params
from tpudab.synth import (ASCTY_DAB, ASCTY_DAB_PLUS, EnsembleSpec,
                          EnsembleSynthesizer, ServiceSpec, SubchannelSpec)

SIGMA = 0.5



def noisy(bits, seed):
    rng = np.random.default_rng(seed)
    return (1.0 - 2.0 * bits + SIGMA * rng.standard_normal(bits.shape)).astype(np.float32)


def dabplus_capture():
    """tests/test_receiver.py:15-42 as frame soft bits: a 48 kbps EEP 3-A
    DAB+ service of superframes of random AUs, 14 frames."""
    from tpudab.audio.superframe import SuperFrameHeader, build_superframe, header_size_bytes
    rng = np.random.default_rng(42)
    bitrate = 48
    hdr = SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0,
                           mpeg_surround=0)
    sfs = []
    for _ in range(14 * 4 // 5 + 1):
        avail = 110 * bitrate // 8 - header_size_bytes(6) - 6 * 2
        sizes = [avail // 6] * 5 + [avail - 5 * (avail // 6)]
        aus = [rng.integers(0, 256, s).astype(np.uint8).tobytes() for s in sizes]
        sfs.append(build_superframe(hdr, aus, bitrate))
    payload = np.concatenate(sfs).reshape(-1, bitrate * 3)
    spec = EnsembleSpec(0x8E15, "E2E Mux",
                        [ServiceSpec(0xD111, "DAB+ One", [(0, ASCTY_DAB_PLUS, 4)],
                                     programme_type=12)],
                        [SubchannelSpec(4, start_cu=0, size_cu=36, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=5)
    synth.payload_fn[4] = lambda m: payload[m].tobytes()
    return noisy(np.stack([synth.frame_bits(i) for i in range(14)]), 1)


def slideshow_capture(pkg="tpudab"):
    """tests/test_receiver.py:81-124: an MOT slideshow in a packet-mode
    data subchannel, 10 frames, built with pkg's packet, MOT and synth
    modules (tpudab's or the port's)."""
    build_packets = importlib.import_module(f"{pkg}.data.packet").build_packets
    TINY_PNG = importlib.import_module(f"{pkg}.mot.imagemeta").TINY_PNG
    mot = importlib.import_module(f"{pkg}.mot.mot")
    ContentType, MOTObject = mot.ContentType, mot.MOTObject
    build_mot_object_groups = mot.build_mot_object_groups
    synth_pkg = importlib.import_module(f"{pkg}.synth")
    EnsembleSpec, ServiceSpec = synth_pkg.EnsembleSpec, synth_pkg.ServiceSpec
    SubchannelSpec, EnsembleSynthesizer = synth_pkg.SubchannelSpec, synth_pkg.EnsembleSynthesizer
    rng = np.random.default_rng(9)
    img = TINY_PNG + rng.integers(0, 256, 1200 - len(TINY_PNG)).astype(np.uint8).tobytes()
    obj = MOTObject(transport_id=42, content_type=ContentType.IMAGE, content_subtype=1,
                    body=img, content_name="cover.jpg")
    pkt_stream = b"".join(b"".join(build_packets(2, g, 96))
                          for g in build_mot_object_groups(obj, segment_size=256))
    spec = EnsembleSpec(0x7777, "Data Mux",
                        [ServiceSpec(0xE100, "Slides", [(synth_pkg.TMID_PACKET_DATA, 60, 9)])],
                        [SubchannelSpec(9, start_cu=0, size_cu=24, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=11)
    need = (10 * 4 + 16) * 96
    stream = pkt_stream + build_packets(0, b"", 24)[0] * ((need - len(pkt_stream)) // 24 + 1)
    stream = np.frombuffer(stream[:need], np.uint8).reshape(-1, 96)
    synth.payload_fn[9] = lambda m: stream[m].tobytes()
    return noisy(np.stack([synth.frame_bits(i) for i in range(10)]), 2)


def demo_capture(n_frames=10):
    """The layout of tpudab's demo (tpudab/host/cli.py:361-374): an MP2
    service on UEP 128 kbps PL3 (an 's' row: calibrated online) and a DAB+
    service on 72-CU EEP 3-A. Random bytes on the UEP subchannel; on the
    DAB+ one, superframes of random AUs led by PAD carrying a dynamic label
    and a slide."""
    from tpudab_torch.synth.payload import dabplus_stream
    spec = EnsembleSpec(0xCE15, "TPU DAB Demo",
                        [ServiceSpec(0xC221, "Tone Radio", [(0, ASCTY_DAB, 1)],
                                     programme_type=10),
                         ServiceSpec(0xC222, "Chirp DAB+", [(0, ASCTY_DAB_PLUS, 2)],
                                     programme_type=12)],
                        [SubchannelSpec(1, start_cu=0, size_cu=96, protection=("uep", 128, 3)),
                         SubchannelSpec(2, start_cu=96, size_cu=72, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=1)
    n_logical = n_frames * 4 + 20
    mp2 = np.random.default_rng(3).integers(0, 256, (n_logical, 128 * 3)).astype(np.uint8)
    plus, _ = dabplus_stream(96, n_logical, seed=4, with_pad=True)
    synth.payload_fn[1] = lambda m: mp2[m].tobytes()
    synth.payload_fn[2] = lambda m: plus[m].tobytes()
    return noisy(np.stack([synth.frame_bits(i) for i in range(n_frames)]), 3), mp2


CAPTURES = {"dabplus": (dabplus_capture, 4), "slideshow": (slideshow_capture, 5),
            "demo": (lambda: demo_capture()[0], 4)}


def outputs_of(outs):
    return {sid: (plain(o.raw_frames), plain(o.superframes), o.mp2_frames,
                  o.data_groups, o.is_dab_plus) for sid, o in outs.items()}


def channels_of(rx):
    res = {}
    for sid, ch in rx.channels.items():
        mgr = getattr(ch, "slideshow", None)
        res[sid] = (type(ch).__name__, getattr(ch, "dynamic_label", None),
                    plain(mgr.slides) if mgr is not None else None,
                    plain(getattr(ch, "stats", None)))
    return res


def calibrations_of(rx):
    return {sid: plain(vars(c)) for sid, c in rx.uep_calibrations.items()}


@pytest.mark.parametrize("name", list(CAPTURES))
def test_receiver_matches_tpudab(name):
    from tpudab.models.receiver import Receiver as JaxReceiver
    from tpudab_torch.models.receiver import Receiver

    make, batch = CAPTURES[name]
    soft = make()
    jrx, prx = JaxReceiver(1), Receiver(1, "cpu")
    for lo in range(0, soft.shape[0], batch):
        want = jrx.process_frame_bits(soft[lo: lo + batch])
        got = prx.process_frame_bits(soft[lo: lo + batch])
        assert outputs_of(got) == outputs_of(want), f"batch at frame {lo}"
    assert outputs_of(prx.finalize()) == outputs_of(jrx.finalize())
    assert prx.stats == jrx.stats and prx.stats["fib_crc_errors"] == 0
    assert db_state(prx.updater) == db_state(jrx.updater)
    assert channels_of(prx) == channels_of(jrx)
    assert calibrations_of(prx) == calibrations_of(jrx)
    if name == "slideshow":
        assert len(prx.channels[9].slideshow.slides) == 1
    if name == "demo":
        assert prx.uep_calibrations[1].locked
        assert prx.channels[2].dynamic_label == "tpudab demo - Now Playing: Chirp"
        assert len(prx.channels[2].slideshow.slides) == 1


def test_port_synth_slideshow_decodes_to_tpudabs_slide():
    """The slideshow capture built by the port alone (its synth, packet and
    MOT builders) equals tpudab's, and the port's Receiver decodes it to
    the slide tpudab's Receiver gets from tpudab's capture."""
    from tpudab.models.receiver import Receiver as JaxReceiver
    from tpudab_torch.models.receiver import Receiver

    soft, want_soft = slideshow_capture("tpudab_torch"), slideshow_capture("tpudab")
    np.testing.assert_array_equal(soft, want_soft)
    jrx, prx = JaxReceiver(1), Receiver(1, "cpu")
    for lo in range(0, soft.shape[0], 5):
        jrx.process_frame_bits(want_soft[lo: lo + 5])
        prx.process_frame_bits(soft[lo: lo + 5])
    got = [(s.transport_id, s.name, s.data) for s in prx.channels[9].slideshow.slides]
    want = [(s.transport_id, s.name, s.data) for s in jrx.channels[9].slideshow.slides]
    assert got == want and len(got) == 1 and prx.stats["fib_crc_errors"] == 0


def test_link_tables_and_screen_equal_tpudab():
    """tests/test_host_wiring.py:216-224's FM and DRM links, each package's
    synth into its own Receiver: equal fm_services, drm_services and
    link_services, and equal render_text screens."""
    from test_torch_synth import _link_spec
    import tpudab.synth as jsynth
    from tpudab.host.dashboard import render_text as jax_render
    from tpudab.models.receiver import Receiver as JaxReceiver
    import tpudab_torch.synth as tsynth
    from tpudab_torch.host.dashboard import render_text
    from tpudab_torch.models.receiver import Receiver

    rxs = []
    for pkg, rx in ((tsynth, Receiver(1, "cpu")), (jsynth, JaxReceiver(1))):
        synth = pkg.EnsembleSynthesizer(_link_spec(pkg), seed=13)
        for i in range(2):
            rx.process_frame_bits((1.0 - 2.0 * synth.frame_bits(i).astype(np.float32))[None])
        rxs.append(rx)
    prx, jrx = rxs
    for name in ("fm_services", "drm_services", "link_services"):
        assert plain(getattr(prx.db, name)) == plain(getattr(jrx.db, name)), name
    assert prx.db.fm_services[0xC479].frequencies == [95_800_000]
    assert prx.db.drm_services[0x00A7].frequencies == [6_095_000]
    text = render_text(prx)
    assert text == jax_render(jrx)
    assert "FM  RDS PI 0xC479" in text and "DRM id 0x00A7" in text


def test_decode_bits_cli_matches(tmp_path, capsys):
    """decode-bits through both command lines on one f32 soft file: the
    same payload files (tpudab's .wav aside: PCM is not ported) and the
    same database listing."""
    from tpudab.host.cli import main as jax_main
    from tpudab_torch.host.cli import main

    soft, _ = demo_capture()
    path = tmp_path / "demo.f32"
    soft.tofile(path)
    outs = {}
    for key, fn, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        d = tmp_path / key
        capsys.readouterr()
        assert fn(["decode-bits", str(path), "--bits-format", "f32", "--batch-frames", "4",
                   "--out-dir", str(d)] + extra) == 0
        lines = capsys.readouterr().out.replace(str(d), "OUT").splitlines()
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
                 if not f.endswith(".wav")}
        outs[key] = ([ln for ln in lines if "PCM" not in ln], files)
    assert outs["port"] == outs["jax"]
    lines, files = outs["port"]
    assert set(files) == {"subch2.aac.raw", "subch2_demo.png"}  # random bytes: no MP2 frames
    assert "FIC: 120 FIBs, 0 CRC errors" in lines
    assert any("Ensemble: 'TPU DAB Demo'" in ln for ln in lines)
    assert any("locked shipped table" in ln for ln in lines)


def test_decode_bits_cli_refuses_missing_gpu(tmp_path):
    from tpudab_torch.host.cli import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "x.f32"
    np.zeros(get_dab_params(1).nb_frame_bits, np.float32).tofile(path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["decode-bits", str(path), "--bits-format", "f32"])


def test_msc_decoder_matches():
    """MSCDecoder over whole frames, both demo subchannels, three batches.
    The validity masks and indices are equal throughout, and the bytes of
    every complete logical frame. The warm-up rows (valid False, mostly
    erasures) are held to the Pallas decoder only: there tpudab's CPU path,
    the XLA scan, breaks ties otherwise (test_torch_viterbi_bits.py::
    test_erased_codewords_follow_pallas)."""
    from tpudab.constants.puncture import eep_profile, get_uep_profile
    from tpudab.msc.subchannel import MSCDecoder as JaxMSC, SubchannelConfig as JaxConfig
    from tpudab_torch.msc.subchannel import MSCDecoder, SubchannelConfig

    soft, _ = demo_capture(n_frames=8)
    uep = get_uep_profile(128, 3)
    args = [(1, 0, 96, uep.to_profile(), uep.padding_bits, (128, 3)),
            (2, 96, 72, eep_profile(72, 3, 0), 0, None)]
    dab = get_dab_params(1)
    jdec = JaxMSC([JaxConfig(*a) for a in args], dab.nb_cifs, CIF_BITS)
    pdec = MSCDecoder([SubchannelConfig(*a) for a in args], dab.nb_cifs, CIF_BITS, "cpu")
    msc = soft[:, dab.nb_fic_bits:]
    for lo in (0, 3, 6):
        want, got = jdec.process_frames(msc[lo: lo + 3]), pdec.process_frames(msc[lo: lo + 3])
        assert set(got) == set(want) == {1, 2}
        for sid in want:
            (wb, wv, wi), (gb, gv, gi) = want[sid], got[sid]
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gb[gv], np.asarray(wb)[wv])


def _cif_batches(soft, start_cu, size_cu):
    dab = get_dab_params(1)
    cifs = soft[:, dab.nb_fic_bits:].reshape(-1, CIF_BITS)
    sl = cifs[:, start_cu * CU_BITS: (start_cu + size_cu) * CU_BITS]
    return [sl[i: i + 4] for i in range(0, sl.shape[0], 4)]   # one frame each


@pytest.mark.parametrize("sid,handoff", [(1, 1), (1, 4), (1, 6), (2, 3)])
def test_subchannel_handoff_continues_stream(sid, handoff):
    """A tpudab SubchannelDecoder runs `handoff` frames, is carried over by
    subchannel_state_from_jax, and the port's decoder then gives the bytes
    tpudab's gives continuing on its own: before the UEP calibration has
    its frames (1, 4), after it locked (6), and on EEP (sid 2)."""
    from tpudab.constants.puncture import eep_profile, get_uep_profile
    from tpudab.msc.subchannel import SubchannelConfig, SubchannelDecoder
    from tpudab_torch.models.convert import subchannel_state_from_jax

    soft, mp2 = demo_capture(n_frames=9)
    if sid == 1:
        uep = get_uep_profile(128, 3)
        cfg = SubchannelConfig(1, 0, 96, uep.to_profile(), uep.padding_bits, uep_key=(128, 3))
    else:
        cfg = SubchannelConfig(2, 96, 72, eep_profile(72, 3, 0))
    batches = _cif_batches(soft, cfg.start_cu, cfg.size_cu)
    jdec = SubchannelDecoder(cfg)
    for b in batches[:handoff]:
        jdec.process(b)
    pdec = subchannel_state_from_jax(jdec, "cpu")
    assert (pdec._n_seen, pdec._cal_pending) == (jdec._n_seen, jdec._cal_pending)
    emitted = []
    for b in batches[handoff:]:
        want, got = jdec.process(b), pdec.process(torch.from_numpy(b))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, np.asarray(w))
        emitted.append(got[0][got[1]])
    for w, g in zip(jdec.flush(), pdec.flush()):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (pdec.calibration is None) == (jdec.calibration is None) == (sid == 2)
    if sid == 1:
        assert plain(vars(pdec.calibration)) == plain(vars(jdec.calibration))
    got = np.concatenate(emitted)
    assert got.shape[0] >= 4
    if sid == 1 and handoff < 6:   # the held frames come out from frame 0
        np.testing.assert_array_equal(got, mp2[: got.shape[0]])

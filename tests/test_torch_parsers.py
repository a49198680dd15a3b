"""Parity of the port's host parsers with tpudab's, on the fuzz inputs of
tests/test_fuzz_parsers.py (same seeds, same draws) and on well-formed
streams: the FIG parser's event lists, the database updater's state, the
superframe, MP2, X-PAD, MOT/slideshow and packet parsers' outputs, the
RS(120,110) code, the Fire code and the CRC-16. Tolerance: none, every
event and output equal."""

import dataclasses
import enum

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a test module that imports this
    fixture: the plain Viterbi twin is ~10^4 small torch ops per decode,
    and with several test workers on one machine intra-op threads only
    contend (a 100x slowdown measured with 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(x):
    """Structural value of x, comparable between the two packages: a
    dataclass becomes its class name and fields, an enum its class and
    member name, containers their elements."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted((plain(v) for v in x), key=repr))
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def db_state(updater):
    """Everything a DatabaseUpdater holds: the database, misc, stats."""
    db = updater.db
    return plain({k: v for k, v in vars(db).items()}), plain(updater.misc), \
        plain(updater.stats), plain(vars(updater).get("_completed"))


def fuzz_fibs():
    """The FIBs of test_fig_parser_never_raises, in its draw order."""
    rng = np.random.default_rng(1)
    out = [rng.integers(0, 256, 32).astype(np.uint8) for _ in range(2000)]
    for fig_type in range(8):
        for length in range(0, 30):
            body = bytes([(fig_type << 5) | length]) + bytes(
                rng.integers(0, 256, 31).astype(np.uint8).tolist())
            out.append(np.frombuffer(body[:32], dtype=np.uint8))
    return out


def synth_fibs():
    """Well-formed FIBs of a synthesised ensemble (every FIG the synthesiser
    writes, packet mode included)."""
    from tpudab.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                              ServiceSpec, SubchannelSpec, TMID_PACKET_DATA)
    spec = EnsembleSpec(
        ensemble_id=0xCE15, label="TPU DAB Demo",
        services=[ServiceSpec(0xC221, "Tone Radio", [(0, 0, 1)], programme_type=10),
                  ServiceSpec(0xC222, "Chirp DAB+", [(0, ASCTY_DAB_PLUS, 2)],
                              programme_type=12),
                  ServiceSpec(0xE100, "Slides", [(TMID_PACKET_DATA, 60, 3)])],
        subchannels=[SubchannelSpec(1, 0, 96, ("uep", 128, 3)),
                     SubchannelSpec(2, 96, 72, ("eep", 3, 0)),
                     SubchannelSpec(3, 168, 24, ("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=1)
    fibs = []
    for i in range(6):
        fibs.extend(synth._build_figs(i).pack_fibs(synth.dab.nb_fibs))
        synth.cif_counter += 4
    return fibs


@pytest.mark.parametrize("source", ["fuzz", "synth"])
def test_fig_parser_and_database_match(source):
    from tpudab.database.updater import DatabaseUpdater as JaxUpdater
    from tpudab.fic.fig_parser import parse_fib as jax_parse
    from tpudab_torch.database.updater import DatabaseUpdater
    from tpudab_torch.fic.fig_parser import parse_fib

    fibs = fuzz_fibs() if source == "fuzz" else synth_fibs()
    ju, pu = JaxUpdater(), DatabaseUpdater()
    for fib in fibs:
        want, got = jax_parse(fib), parse_fib(fib)
        assert plain(got) == plain(want)
        ju.process_events(want)
        pu.process_events(got)
    assert db_state(pu) == db_state(ju)
    if source == "synth":
        assert pu.db.ensemble.label == "TPU DAB Demo" and len(pu.db.services) == 3


def test_superframe_parser_matches():
    from tpudab.audio.superframe import parse_superframe as jax_parse
    from tpudab_torch.audio.superframe import parse_superframe
    from tpudab_torch.fec.crc import firecode_compute

    rng = np.random.default_rng(2)
    for _ in range(200):
        sf = rng.integers(0, 256, 480).astype(np.uint8)
        assert plain(parse_superframe(sf, 32, apply_rs=False)) == \
            plain(jax_parse(sf, 32, apply_rs=False))
    for _ in range(500):
        sf = rng.integers(0, 256, 480).astype(np.uint8)
        fc = int(firecode_compute(sf[2:11]))
        sf[0], sf[1] = fc >> 8, fc & 0xFF
        got = parse_superframe(sf, 32, apply_rs=False)
        assert got.firecode_ok
        assert plain(got) == plain(jax_parse(sf, 32, apply_rs=False))


def test_superframe_build_rs_roundtrip_matches():
    """build_superframe gives tpudab's bytes; with byte errors injected,
    parse_superframe (RS on) corrects them as tpudab does."""
    from tpudab.audio import superframe as jsf
    from tpudab_torch.audio import superframe as psf

    rng = np.random.default_rng(8)
    for bitrate in (32, 48, 96):
        hdr_args = dict(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0,
                        mpeg_surround=0)
        n_aus = psf.SuperFrameHeader(**hdr_args).num_aus
        avail = 110 * bitrate // 8 - psf.header_size_bytes(n_aus) - 2 * n_aus
        sizes = [avail // n_aus] * (n_aus - 1) + [avail - (n_aus - 1) * (avail // n_aus)]
        aus = [rng.integers(0, 256, s).astype(np.uint8).tobytes() for s in sizes]
        got = psf.build_superframe(psf.SuperFrameHeader(**hdr_args), aus, bitrate)
        want = jsf.build_superframe(jsf.SuperFrameHeader(**hdr_args), aus, bitrate)
        np.testing.assert_array_equal(got, want)
        bad = got.copy()
        bad[rng.choice(bad.shape[0], 12, replace=False)] ^= 0x5A
        res = psf.parse_superframe(bad, bitrate)
        assert plain(res) == plain(jsf.parse_superframe(bad, bitrate))
        assert [bytes(a) for a in res.access_units] == aus


def test_rs_firecode_crc_match():
    from tpudab.fec import crc as jcrc
    from tpudab.fec import rs as jrs
    from tpudab_torch.fec import crc as pcrc
    from tpudab_torch.fec import rs as prs

    rng = np.random.default_rng(9)
    msg = rng.integers(0, 256, (40, 110)).astype(np.uint8)
    cw = prs.rs_encode(msg)
    np.testing.assert_array_equal(cw, jrs.rs_encode(msg))
    for k in range(40):   # 0..7 byte errors per codeword: correctable up to 5
        pos = rng.choice(120, k % 8, replace=False)
        cw[k, pos] ^= rng.integers(1, 256, pos.shape[0]).astype(np.uint8)
    assert plain(prs.rs_decode(cw)) == plain(jrs.rs_decode(cw))
    data = rng.integers(0, 256, (64, 30)).astype(np.uint8)
    np.testing.assert_array_equal(pcrc.crc16_ccitt(data), jcrc.crc16_ccitt(data))
    np.testing.assert_array_equal(pcrc.firecode_compute(data[:, :9]),
                                  jcrc.firecode_compute(data[:, :9]))
    np.testing.assert_array_equal(pcrc.firecode_check(data), jcrc.firecode_check(data))
    assert pcrc.crc16_ccitt(data[0]) == jcrc.crc16_ccitt(data[0])
    assert pcrc.crc16_ccitt(data[0, :0]) == jcrc.crc16_ccitt(data[0, :0])


def _slides(mgr):
    return plain(mgr.slides), mgr.rejected


def test_mot_and_packet_parsers_match():
    from tpudab.data.packet import PacketChannel as JaxPackets
    from tpudab.mot.slideshow import SlideshowManager as JaxSlides
    from tpudab_torch.data.packet import PacketChannel
    from tpudab_torch.mot.slideshow import SlideshowManager

    rng = np.random.default_rng(3)
    jm, pm = JaxSlides(), SlideshowManager()
    jc = JaxPackets(address=None, on_data_group=jm.push_data_group)
    pc = PacketChannel(address=None, on_data_group=pm.push_data_group)
    for _ in range(50):
        stream = rng.integers(0, 256, 4096).astype(np.uint8).tobytes()
        assert pc.process_bytes(stream) == jc.process_bytes(stream)
    for _ in range(500):
        n = int(rng.integers(1, 300))
        g = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        jm.push_data_group(g)
        pm.push_data_group(g)
    assert _slides(pm) == _slides(jm)
    assert plain(pc.stats) == plain(jc.stats)


def test_packet_slideshow_stream_matches():
    """A well-formed MOT slideshow in packets (tests/test_receiver.py's
    object) comes out as the same slide from both."""
    from tpudab.data.packet import PacketChannel as JaxPackets
    from tpudab.mot.slideshow import SlideshowManager as JaxSlides
    from tpudab_torch.data.packet import PacketChannel, build_packets
    from tpudab_torch.mot.imagemeta import TINY_PNG
    from tpudab_torch.mot.mot import ContentType, MOTObject, build_mot_object_groups
    from tpudab_torch.mot.slideshow import SlideshowManager

    rng = np.random.default_rng(9)
    img = TINY_PNG + rng.integers(0, 256, 1200 - len(TINY_PNG)).astype(np.uint8).tobytes()
    obj = MOTObject(transport_id=42, content_type=ContentType.IMAGE,
                    content_subtype=1, body=img, content_name="cover.jpg")
    stream = b"".join(b"".join(build_packets(2, g, 96))
                      for g in build_mot_object_groups(obj, segment_size=256))
    jm, pm = JaxSlides(), SlideshowManager()
    JaxPackets(on_data_group=jm.push_data_group).process_bytes(stream)
    PacketChannel(on_data_group=pm.push_data_group).process_bytes(stream)
    assert _slides(pm) == _slides(jm)
    assert len(pm.slides) == 1 and pm.slides[0].data == img


def test_xpad_matches():
    from tpudab.pad import xpad as jx
    from tpudab_torch.pad import xpad as px

    rng = np.random.default_rng(4)
    jg, pg = [], []
    jp = jx.XPADProcessor(on_mot_data_group=jg.append)
    pp = px.XPADProcessor(on_mot_data_group=pg.append)
    for _ in range(1000):
        fpad = bytes(rng.integers(0, 256, 2).astype(np.uint8).tolist())
        xlen = int(rng.integers(0, 64))
        xpad = bytes(rng.integers(0, 256, xlen).astype(np.uint8).tolist())
        jp.push(fpad, xpad)
        pp.push(fpad, xpad)
    assert pg == jg
    assert plain(vars(pp.dynamic_label)) == plain(vars(jp.dynamic_label))
    assert pp.stats == jp.stats
    for _ in range(500):
        n = int(rng.integers(0, 128))
        au = bytes(rng.integers(0, 256, n).astype(np.uint8).tolist())
        assert px.extract_pad_from_dabplus_au(au) == jx.extract_pad_from_dabplus_au(au)
    # a well-formed dynamic label through both
    segs = px.build_dynamic_label_segments("tpudab demo - Now Playing: Chirp")
    assert segs == jx.build_dynamic_label_segments("tpudab demo - Now Playing: Chirp")
    for s in segs:
        au = px.build_xpad_into_au(b"\x00" * 8, [(px.APP_DYNAMIC_LABEL_START, s)])
        assert au == jx.build_xpad_into_au(b"\x00" * 8, [(jx.APP_DYNAMIC_LABEL_START, s)])


@pytest.mark.parametrize("kind", ["mp2", "dabplus"])
def test_channels_match_on_garbage(kind):
    from tpudab.audio.mp2 import DABChannel as JaxMP2
    from tpudab.audio.superframe import DABPlusChannel as JaxPlus
    from tpudab_torch.audio.mp2 import DABChannel
    from tpudab_torch.audio.superframe import DABPlusChannel

    if kind == "mp2":
        rng, mk, shape = np.random.default_rng(5), (JaxMP2, DABChannel, 128), (4, 128 * 3)
    else:
        rng, mk, shape = np.random.default_rng(6), (JaxPlus, DABPlusChannel, 32), (5, 96)
    jc, pc = mk[0](mk[2]), mk[1](mk[2])
    for _ in range(20):
        frames = rng.integers(0, 256, shape).astype(np.uint8)
        assert plain(pc.process_frames(frames)) == plain(jc.process_frames(frames))
    assert pc.dynamic_label == jc.dynamic_label


def test_mp2_header_parser_matches():
    from tpudab.audio.mp2 import parse_mp2_header as jax_parse
    from tpudab_torch.audio.mp2 import parse_mp2_header

    rng = np.random.default_rng(12)
    heads = [rng.integers(0, 256, 4).astype(np.uint8).tobytes() for _ in range(3000)]
    heads += [bytes([0xFF, 0xF0 | (b & 0x0F), c, d]) for b, c, d in
              rng.integers(0, 256, (3000, 3)).tolist()]
    for h in heads:
        assert plain(parse_mp2_header(h)) == plain(jax_parse(h))

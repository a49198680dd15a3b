"""The port's jax-free synthesizer gives tpudab.synth's bits and IQ bit for
bit for the same spec and seed."""

import importlib

import numpy as np
import pytest

import tpudab.synth as jsynth
import tpudab_torch.synth as tsynth


def _spec(pkg, layout):
    return pkg.EnsembleSpec(
        ensemble_id=0xBE9C, label="Bench Ensemble",
        services=[pkg.ServiceSpec(0xC200 + sid, f"Bench {sid}", [(0, pkg.ASCTY_DAB_PLUS, sid)])
                  for sid, *_ in layout],
        subchannels=[pkg.SubchannelSpec(sid, start_cu=start, size_cu=size, protection=prot)
                     for sid, start, size, prot in layout])


LAYOUTS = {
    "bench": [(i + 1, 108 * i, 108, ("eep", 3, 0)) for i in range(6)],
    "mixed": [(1, 0, 24, ("eep", 3, 0)), (2, 30, 54, ("eep", 1, 1)),
              (3, 100, 64, ("uep", 128, 5))],
    "single": [(1, 0, 36, ("eep", 3, 0))],
}


@pytest.mark.parametrize("name,mode", [("bench", 1), ("mixed", 1), ("single", 1),
                                       ("single", 3)])
def test_synth_iq_bit_exact(name, mode):
    layout = LAYOUTS[name]
    ref = jsynth.EnsembleSynthesizer(_spec(jsynth, layout), mode=mode, seed=1)
    port = tsynth.EnsembleSynthesizer(_spec(tsynth, layout), mode=mode, seed=1)
    data = np.random.default_rng(2).integers(0, 256, (8, 432)).astype(np.uint8)
    for s in (ref, port):
        s.payload_fn[1] = lambda m: data[m, : layout[0][2] // 6 * 24].tobytes()
    n = 2
    for i in range(n):
        np.testing.assert_array_equal(port.frame_bits(i), ref.frame_bits(i))
    np.testing.assert_array_equal(port.frames_iq(n), ref.frames_iq(n))
    bits = ref.frame_bits(0)
    np.testing.assert_array_equal(tsynth.modulate_frame_bits(bits, mode),
                                  jsynth.modulate_frame_bits(bits, mode))


# ---------------------------------------------------------------------------
# packet-mode components and FM/DRM links: the FIC's FIGs 0/2 (SCId form),
# 0/3, 0/6 and 0/21
# ---------------------------------------------------------------------------

def _packet_spec(pkg):
    """One packet-mode MOT service (TMId 3, DSCTy 60) on a 24-CU subchannel."""
    return pkg.EnsembleSpec(0x7777, "Data Mux",
                            [pkg.ServiceSpec(0xE100, "Slides", [(pkg.TMID_PACKET_DATA, 60, 9)])],
                            [pkg.SubchannelSpec(9, 0, 24, ("eep", 3, 0))])


def _link_spec(pkg):
    """tests/test_host_wiring.py:216-224: a DAB+ service with an FM and a
    DRM link."""
    ens = importlib.import_module(f"{pkg.__name__}.ensemble")
    spec = pkg.EnsembleSpec(
        ensemble_id=0x5B5B, label="Link Mux",
        services=[pkg.ServiceSpec(0xC601, "Linked", [(0, pkg.ASCTY_DAB_PLUS, 4)])],
        subchannels=[pkg.SubchannelSpec(4, start_cu=0, size_cu=24, protection=("eep", 3, 0))])
    spec.fm_links = [ens.FMLinkSpec(service_id=0xC601, rds_pi=0xC479,
                                    frequencies_hz=[95_800_000])]
    spec.drm_links = [ens.DRMLinkSpec(service_id=0xC601, drm_id=0x00A7,
                                      frequencies_hz=[6_095_000])]
    return spec


def _packet_mux_spec(pkg):
    """chip_smoke.py's phase 13 multiplex: the bench layout, DAB+ on
    subchannels 1-5, a packet-mode slideshow on 6, an FM link on service 1
    and a DRM link on service 2."""
    ens = importlib.import_module(f"{pkg.__name__}.ensemble")
    layout = LAYOUTS["bench"]
    services = [pkg.ServiceSpec(0xC200 + sid, f"Bench {sid}", [(0, pkg.ASCTY_DAB_PLUS, sid)])
                for sid, *_ in layout[:-1]]
    services.append(pkg.ServiceSpec(0xC206, "Bench Slides", [(pkg.TMID_PACKET_DATA, 60, 6)]))
    return pkg.EnsembleSpec(
        ensemble_id=0xBE9D, label="Packet Ensemble", services=services,
        subchannels=[pkg.SubchannelSpec(sid, start_cu=start, size_cu=size, protection=prot)
                     for sid, start, size, prot in layout],
        fm_links=[ens.FMLinkSpec(0xC201, 0xC479, [95_800_000])],
        drm_links=[ens.DRMLinkSpec(0xC202, 0x00A7, [6_095_000])])


SPECS = {"packet": _packet_spec, "links": _link_spec,
         "stream": lambda pkg: _spec(pkg, LAYOUTS["bench"])}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fic_and_frame_bits_equal_tpudab(name):
    """build_fic_bits(i) and frame_bits(i), i = 0..2, bit-equal to
    tpudab's. Tolerance: none."""
    ref = jsynth.EnsembleSynthesizer(SPECS[name](jsynth), seed=1)
    port = tsynth.EnsembleSynthesizer(SPECS[name](tsynth), seed=1)
    for i in range(3):
        np.testing.assert_array_equal(port.build_fic_bits(i), ref.build_fic_bits(i))
        np.testing.assert_array_equal(port.frame_bits(i), ref.frame_bits(i))


def test_packet_mux_beyond_tpudabs_packer():
    """Phase 13's multiplex: six services, a packet component and two links
    overflow 12 FIBs when packed greedily in FIG order, so tpudab's synth
    refuses it and the port's packs it first-fit decreasing. Its CIFs are
    bit-equal to tpudab's on the same spec and seed, and tpudab's Receiver
    reads the port's FIC (every FIB CRC passing) to the same database,
    misc and stats as the port's Receiver. Tolerance: none."""
    from test_torch_parsers import db_state
    from tpudab.models.receiver import Receiver as JaxReceiver
    from tpudab_torch.models.receiver import Receiver

    ref = jsynth.EnsembleSynthesizer(_packet_mux_spec(jsynth), seed=1)
    with pytest.raises(AssertionError, match="did not fit in 12 FIBs"):
        ref.build_fic_bits(0)
    port = tsynth.EnsembleSynthesizer(_packet_mux_spec(tsynth), seed=1)
    for c in range(12):
        np.testing.assert_array_equal(port.build_cif_bits(c), ref.build_cif_bits(c))
    soft = 1.0 - 2.0 * np.stack([port.frame_bits(i) for i in range(3)]).astype(np.float32)
    jrx, prx = JaxReceiver(1), Receiver(1, "cpu")
    jrx.process_frame_bits(soft)
    prx.process_frame_bits(soft)
    assert prx.stats["fibs"] == 36 and prx.stats["fib_crc_errors"] == 0
    assert db_state(prx.updater) == db_state(jrx.updater)
    comps = [(c.scid, c.subch_id, c.data_type, c.packet_address)
             for c in prx.db.service_components.values() if c.service_id == 0xC206]
    assert comps == [(6, 6, 60, 2)]
    assert prx.db.fm_services[0xC479].frequencies == [95_800_000]
    assert prx.db.drm_services[0x00A7].frequencies == [6_095_000]


def test_packet_mux_spec_is_chip_smokes():
    import chip_smoke
    assert chip_smoke.packet_mux_spec() == _packet_mux_spec(tsynth)


def test_packet_component_reaches_the_database():
    """The port's Receiver reads the port's packet FIC as tpudab's FIG 0/3
    says: SCId 9 on subchannel 9, DSCTy 60, packet address 2."""
    from tpudab_torch.models.receiver import Receiver

    synth = tsynth.EnsembleSynthesizer(_packet_spec(tsynth), seed=1)
    rx = Receiver(1, "cpu")
    rx.process_frame_bits(1.0 - 2.0 * np.stack([synth.frame_bits(i) for i in range(2)])
                          .astype(np.float32))
    comps = [c for c in rx.db.service_components.values() if c.service_id == 0xE100]
    assert [(c.scid, c.subch_id, c.data_type, c.packet_address) for c in comps] == \
        [(9, 9, 60, 2)]


@pytest.mark.parametrize("pkg", [jsynth, tsynth], ids=["tpudab", "port"])
def test_uep_size_mismatch_raises(pkg):
    """A UEP subchannel must have its profile's size (128 kbps PL3: 96 CU)."""
    spec = pkg.EnsembleSpec(0x1234, "Bad", [pkg.ServiceSpec(0xC001, "S", [(0, 0, 1)])],
                            [pkg.SubchannelSpec(1, 0, 95, ("uep", 128, 3))])
    with pytest.raises(AssertionError, match="requires size 96 CU, got 95"):
        pkg.EnsembleSynthesizer(spec)


# ---------------------------------------------------------------------------
# the `synth` subcommand and its demo streams (need FFmpeg's encoders)
# ---------------------------------------------------------------------------

@pytest.fixture
def ffmpeg():
    from tpudab_torch.host.native_lib import ffmpeg_probe
    found, what = ffmpeg_probe()
    if not found:
        pytest.skip(f"the codec probe found no FFmpeg: {what}")


def test_demo_streams_equal_tpudab(ffmpeg):
    """synth/payload.py's demo streams against tpudab's synth's: the MP2
    tone and the DAB+ stream with its PAD, byte for byte."""
    from tpudab.host.cli import _dabplus_stream, _mp2_tone_stream
    from tpudab_torch.synth.payload import demo_dabplus_stream, mp2_tone_stream

    np.testing.assert_array_equal(mp2_tone_stream(128, 24), _mp2_tone_stream(128, 24))
    stream, aus = demo_dabplus_stream(96, 24)
    np.testing.assert_array_equal(stream, _dabplus_stream(96, 24))
    assert len(aus) == 6 * (24 // 5 + 1)


def test_demo_stream_without_pad_carries_the_tone(ffmpeg):
    """The no-PAD option (chip_smoke.py's codec capture): the receiver's
    superframe parser gets back every AU, no PAD DSE leads any, and the
    DAB+ decoder turns them into the tone."""
    from tpudab_torch.audio.codecs import AACDecoder
    from tpudab_torch.audio.superframe import SuperFrameHeader, parse_superframe
    from tpudab_torch.synth.payload import demo_dabplus_stream

    stream, aus = demo_dabplus_stream(96, 10, with_pad=False)
    got = []
    for k in range(2):
        sf = parse_superframe(stream[5 * k: 5 * k + 5].reshape(-1), 96)
        got.extend(bytes(a) for a in sf.access_units)
    assert got == aus[:12]
    assert all(a[0] >> 5 != 4 for a in got)     # no DSE (syntax element 4) leads an AU
    dec = AACDecoder(SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0,
                                      mpeg_surround=0))
    pcm = np.concatenate([dec.decode(a) for a in got[2:]]).astype(np.float64)
    assert np.sqrt(np.mean(pcm ** 2)) > 2000


def test_cli_synth_equals_tpudab(ffmpeg, tmp_path):
    """`python -m tpudab_torch.host.cli synth f --seconds 0.5` writes
    tpudab's synth's capture with the same flags, byte for byte."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = {}
    for pkg in ("tpudab_torch", "tpudab"):
        files[pkg] = tmp_path / f"{pkg}.f32"
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.host.cli", "synth",
                               str(files[pkg]), "--seconds", "0.5", "--snr", "20"],
                              cwd=root, env=dict(os.environ, PYTHONPATH=root),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "Wrote 5 frames (0.48 s)" in proc.stdout
    assert files["tpudab_torch"].read_bytes() == files["tpudab"].read_bytes()
    assert files["tpudab"].stat().st_size == 5 * 196608 * 8


def test_cli_synth_without_ffmpeg_writes_nothing(tmp_path, monkeypatch, capsys):
    """Where the codec probe finds no FFmpeg, synth fails with the
    encoder's "unavailable" error and writes no capture without audio."""
    from tpudab_torch.host import cli, native_lib

    monkeypatch.setattr(native_lib, "ffmpeg_probe", lambda: (False, "no avcodec.h"))
    assert cli.main(["synth", str(tmp_path / "cap.f32"), "--seconds", "0.5"]) == 1
    assert "encoder mp2 unavailable (no FFmpeg: no avcodec.h)" in capsys.readouterr().err
    assert not (tmp_path / "cap.f32").exists()

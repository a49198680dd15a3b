"""The port's host audio (tpudab_torch.utils.resample, audio/pipeline.py,
audio/sink.py, audio/codecs.py) against tpudab's on the same inputs.

Tolerance: none. The resampler's output, the mix and the WAV bytes are
equal to tpudab's, bit for bit (the same numpy code); the codecs' packets
and PCM are equal (the same libavcodec through the same shim source). The
codec tests skip only where the port's codec probe finds no FFmpeg.
"""

import io
import time
import wave

import numpy as np
import pytest

import tpudab.audio.codecs as j_codecs
import tpudab.audio.pipeline as j_pipe
import tpudab.utils.resample as j_rs
import tpudab_torch.audio.codecs as p_codecs
import tpudab_torch.audio.pipeline as p_pipe
import tpudab_torch.utils.resample as p_rs
from tpudab_torch.audio.sink import PlaybackSink
from tpudab_torch.audio.superframe import SuperFrameHeader
from tpudab_torch.host.native_lib import ffmpeg_probe


@pytest.mark.parametrize("args", [(128, 16, 0.46, 8.0), (128, 64, 0.5, 8.0), (32, 8, 0.25, 5.0)])
def test_polyphase_bank_equal(args):
    got, want = p_rs.polyphase_bank(*args), j_rs.polyphase_bank(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("ratio,taps,kind", [
    (1.0 + 100e-6, 16, "iq"), (1.0 - 37e-6, 16, "iq"), (48000 / 32000, 64, "stereo"),
    (24000 / 48000, 64, "stereo"), (44100 / 48000, 64, "mono")])
def test_polyphase_resampler_bit_equal(ratio, taps, kind):
    """Chunks of uneven sizes (one shorter than the filter), the ratio
    retuned half-way, as the drift servo does."""
    rng = np.random.default_rng(3)
    n = 20_000
    if kind == "iq":
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    elif kind == "stereo":
        x = rng.standard_normal((n, 2)).astype(np.float32)
    else:
        x = rng.standard_normal(n).astype(np.float32)
    p, j = p_rs.PolyphaseResampler(ratio, taps=taps), j_rs.PolyphaseResampler(ratio, taps=taps)
    lo = 0
    for k, size in enumerate([5, 4096, 333, 7000, 1, 8565]):
        if k == 3:
            p.set_ratio(ratio * (1 + 20e-6))
            j.set_ratio(ratio * (1 + 20e-6))
        got, want = p.process(x[lo: lo + size]), j.process(x[lo: lo + size])
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), k
        lo += size
    assert p._pos == j._pos


def pcm_blocks():
    rng = np.random.default_rng(5)
    t = np.arange(4800)
    tone = (9000 * np.sin(2 * np.pi * 440 * t / 48000)).astype(np.int16)
    return [
        (1, np.stack([tone, tone // 2], axis=1), 48000),
        (2, (0.3 * rng.standard_normal(3200)).astype(np.float32), 32000),
        (3, rng.integers(-20000, 20000, (2400, 2)).astype(np.int16), 24000),
        (1, np.stack([tone, tone], axis=1)[:960], 48000),
    ]


def drive(pipe_mod, wav_path):
    """The same writes, gains, mutes and pulls on one module's pipeline;
    returns the mixed blocks, and the WAV sink writes wav_path."""
    pipe = pipe_mod.AudioPipeline(48000)
    sink = pipe_mod.WavSink(str(wav_path), pipe.sink_rate)
    out = []
    for k, (key, pcm, rate) in enumerate(pcm_blocks()):
        pipe.add_source(key).write(pcm, rate)
        if k == 1:
            pipe.set_source_gain(2, 0.5)
            pipe.global_gain = 1.7
        out.append(pipe.mix(1500))
        sink.write(out[-1])
    pipe.muted = True
    out.append(pipe.mix(700))
    pipe.muted = False
    pipe.set_sink_rate(44100)
    out.append(pipe.mix(2000))
    sink.write(out[-1])
    pipe.clear_sources()
    out.append(pipe.mix(100))
    sink.close()
    return out


def test_audio_pipeline_mix_and_wav_equal(tmp_path):
    got = drive(p_pipe, tmp_path / "port.wav")
    want = drive(j_pipe, tmp_path / "tpudab.wav")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.abs(got[0]).max() > 0.1 and not got[-3].any()
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "tpudab.wav").read_bytes()


class FakeDevice(io.BytesIO):
    def __init__(self):
        super().__init__()
        self.writes = 0
        self.data = bytearray()

    def write(self, data):
        self.writes += 1
        self.data.extend(data)
        return super().write(data)


def test_playback_sink_fake_device():
    """As tests/test_audio_sink.py holds tpudab's: 20 ms blocks paced
    against real time, no blocks while no source has data, a clean stop."""
    pipe = p_pipe.AudioPipeline(8_000)
    dev = FakeDevice()
    sink = PlaybackSink(pipe, rate=8_000, block_seconds=0.02, device_factory=lambda rate: dev)
    sink.start()
    time.sleep(0.06)
    assert dev.writes == 0 and sink.underruns >= 1
    t = np.arange(8_000) / 8_000
    pcm = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    pipe.add_source(1).write(np.stack([pcm, pcm], axis=1), 8_000)
    time.sleep(0.25)
    sink.stop()
    assert dev.writes >= 3
    assert np.frombuffer(bytes(dev.data), dtype="<i2").astype(np.int32).max() > 1000
    assert len(dev.data) % (int(8_000 * 0.02) * 2 * 2) == 0


def test_playback_sink_rate_change():
    pipe = p_pipe.AudioPipeline(48_000)
    devs = []

    def factory(rate):
        d = FakeDevice()
        d.rate = rate
        devs.append(d)
        return d

    sink = PlaybackSink(pipe, rate=48_000, device_factory=factory)
    sink.start()
    sink.set_rate(32_000)
    assert pipe.sink_rate == 32_000 and devs[-1].rate == 32_000
    sink.stop()


def test_audio_specific_config_equal():
    for rate in j_codecs._FREQ_INDEX:
        for ch in (1, 2):
            for f960 in (False, True):
                assert p_codecs.audio_specific_config(rate, ch, f960) == \
                    j_codecs.audio_specific_config(rate, ch, f960)
    for dac in (0, 1):
        for sbr in (0, 1):
            for mode in (0, 1):
                kw = dict(dac_rate=dac, sbr_flag=sbr, aac_channel_mode=mode, ps_flag=0,
                          mpeg_surround=0)
                assert p_codecs.asc_for_header(SuperFrameHeader(**kw)) == \
                    j_codecs.asc_for_header(j_codecs.SuperFrameHeader(**kw))


@pytest.fixture
def ffmpeg():
    found, what = ffmpeg_probe()
    if not found:
        pytest.skip(f"the codec probe found no FFmpeg: {what}")
    assert p_codecs.aac_decode_available() and p_codecs.mp2_decode_available()


def tone_frames(frame_size: int, n: int, f_hz: float):
    t = np.arange(frame_size)
    out = []
    for k in range(n):
        x = (8000 * np.sin(2 * np.pi * f_hz * (t + k * frame_size) / 48000)).astype(np.int16)
        out.append(np.stack([x, x], axis=1))
    return out


def rms(pcm) -> float:
    return float(np.sqrt(np.mean(np.concatenate(pcm).astype(np.float64) ** 2)))


def test_mp2_round_trip_equals_tpudab(ffmpeg):
    p_enc, j_enc = p_codecs.MP2Encoder(48000, 2, 128), j_codecs.MP2Encoder(48000, 2, 128)
    assert p_enc.frame_size == j_enc.frame_size == 1152
    frames = tone_frames(p_enc.frame_size, 12, 440.0)
    packets = [p_enc.encode(x) for x in frames] + [p_enc.flush()]
    assert packets == [j_enc.encode(x) for x in frames] + [j_enc.flush()]
    p_dec, j_dec = p_codecs.MP2Decoder(), j_codecs.MP2Decoder()
    pcm = []
    for pkt in packets:
        got, want = p_dec.decode(pkt), j_dec.decode(pkt)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        pcm.append(got)
    assert (p_dec.sample_rate, p_dec.channels) == (j_dec.sample_rate, j_dec.channels) == (48000, 2)
    assert sum(map(len, pcm)) >= 11 * 1152 and rms(pcm) > 1000


def test_aac960_round_trip_equals_tpudab(ffmpeg):
    """AAC-LC packets from the port's encoder (as tpudab's synth makes its
    DAB+ AUs; the encoder's first, empty packet dropped: an empty packet
    is the shim's flush) through each package's DAB+ decoder, opened with
    the 960-sample AudioSpecificConfig of the superframe header."""
    enc = p_codecs._ShimEncoder("aac", 48000, 2, 64_000)
    packets = [p for p in (enc.encode(x) for x in tone_frames(enc.frame_size, 16, 550.0)) if p]
    hdr = dict(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0, mpeg_surround=0)
    p_dec = p_codecs.AACDecoder(SuperFrameHeader(**hdr))
    j_dec = j_codecs.AACDecoder(j_codecs.SuperFrameHeader(**hdr))
    pcm = []
    for pkt in packets:
        got, want = p_dec.decode(pkt), j_dec.decode(pkt)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        pcm.append(got)
    assert p_dec.sample_rate == j_dec.sample_rate == 48000
    assert {len(x) for x in pcm} == {960} and rms(pcm) > 1000


def test_dabplus_aac_stream_carries_the_tone(ffmpeg):
    """synth/payload.py::demo_dabplus_stream without PAD (chip_smoke.py's
    codec capture): full superframes whose AUs are the encoder's non-empty
    packets, each decoding under the DAB+ decoder to 960 samples of the
    tone; and a subchannel too small for 64 kbps AAC is refused."""
    from tpudab_torch.audio.superframe import build_superframe
    from tpudab_torch.synth.payload import demo_dabplus_stream
    stream, aus = demo_dabplus_stream(96, 12, with_pad=False)
    assert stream.shape == (12, 288) and stream.dtype == np.uint8
    assert len(aus) == 18 and all(aus)
    hdr = dict(dac_rate=1, sbr_flag=0, aac_channel_mode=1, ps_flag=0, mpeg_surround=0)
    assert np.array_equal(stream[:5].reshape(-1),
                          build_superframe(SuperFrameHeader(**hdr), aus[:6], 96))
    dec = p_codecs.AACDecoder(SuperFrameHeader(**hdr))
    pcm = [dec.decode(au) for au in aus]
    assert {len(x) for x in pcm} == {960} and rms(pcm[2:]) > 2000
    with pytest.raises(ValueError, match="overflows"):
        demo_dabplus_stream(32, 5, with_pad=False)


def test_decoder_refuses_a_bad_codec(ffmpeg):
    with pytest.raises(p_codecs.CodecUnavailable, match="unavailable"):
        p_codecs._ShimDecoder("no-such-codec")
    with pytest.raises(ValueError):
        p_codecs.MP2Encoder().encode(np.zeros((100, 2), np.int16))


def test_wav_from_pcm_equals_tpudab(tmp_path):
    from tpudab.host.cli import WavFromPCM as JaxWav
    from tpudab_torch.host.cli import WavFromPCM
    blocks = [b for _, b, _ in pcm_blocks() if b.dtype == np.int16 and b.ndim == 2]
    for cls, name in ((WavFromPCM, "port.wav"), (JaxWav, "tpudab.wav")):
        w = cls(str(tmp_path / name), 48000)
        for b in blocks:
            w.write(b)
        w.close()
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "tpudab.wav").read_bytes()
    with wave.open(str(tmp_path / "port.wav")) as w:
        assert w.getnchannels() == 2 and w.getnframes() == sum(len(b) for b in blocks)

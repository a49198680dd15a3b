"""The port's rtl_tcp source (tpudab_torch.host.rtl_tcp, the native client
of host/native/tcpsource.c) against tpudab's, `stream --tcp` against
tpudab's, and a live retune on the port's radio.

Every server and client here is local (127.0.0.1, a free port); every
stream loop runs in a thread joined with a timeout, and a server is
stopped in a finally.

Tolerance: none. A client's samples are the server's u8 IQ converted as
(u8 - 127.5) / 128 in f32 by either package's client; each package's
`stream --tcp` reads the same samples from a fresh instance of the port's
server, so the database, the FIB counts, the WAV and the last line equal
tpudab's.
"""

import threading
import time

import numpy as np
import pytest

import tpudab.host.controls as jax_controls
import tpudab.host.rtl_tcp as jax_rtl
import tpudab_torch.host.controls as port_controls
import tpudab_torch.host.rtl_tcp as port_rtl
from test_live_source import _capture
from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.host.cli import main as jax_main
from tpudab_torch.constants.channels import channel_freq_hz
from tpudab_torch.host.cli import main
from tpudab_torch.host.streaming import StreamingRadio

F12C, F12D = channel_freq_hz("12C"), channel_freq_hz("12D")
PAIRS = {"port-client-tpudab-server": (port_rtl, jax_rtl),
         "tpudab-client-port-server": (jax_rtl, port_rtl),
         "port-both": (port_rtl, port_rtl)}
LOOP_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def two_channels():
    """tests/test_live_source.py's two ensembles, 8 frames each."""
    return {"12C": _capture(8, label="Mux Charlie", eid=0xC12C, seed=5)[0],
            "12D": _capture(8, label="Mux Delta", eid=0xD12D, seed=6)[0]}


def quantized(iq):
    """What a client reads of iq served as u8 IQ."""
    u8 = lambda x: np.clip(x * 128.0 + 127.5, 0, 255).astype(np.uint8)
    conv = lambda q: (q.astype(np.float32) - np.float32(127.5)) / np.float32(128.0)
    return (conv(u8(iq.real)) + 1j * conv(u8(iq.imag))).astype(np.complex64)


def find_in(loop, x):
    """Where x starts in the looped capture `loop`, or -1."""
    twice = np.concatenate([loop, loop[: x.shape[0]]])
    for p in np.flatnonzero(twice[: loop.shape[0]] == x[0]):
        if np.array_equal(twice[p: p + x.shape[0]], x):
            return int(p)
    return -1


class Ramp:
    """A server source that ignores the frequency: a fixed pattern whose
    u8 codes sweep 0-255, from the first sample of the session."""

    def __init__(self, n=1 << 17):
        k = np.arange(n)
        self.x = (((k * 37) % 256 - 127.5) / 128 + 1j * (((k * 91) % 256 - 127.5) / 128))
        self.pos = 0

    def __call__(self, freq_hz, n):
        out = self.x[self.pos: self.pos + n]
        self.pos += n
        return out


def wait_for(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_handshake_and_u8_conversion(pair):
    """Header (tuner type), SET_SAMPLE_RATE and SET_FREQ on connect, and
    the u8 -> complex64 conversion into the ring, sample for sample."""
    client, server_mod = PAIRS[pair]
    ramp = Ramp()
    server = server_mod.RtlTcpServer(ramp, tuner_type=7).start()
    try:
        src = client.TcpSource(server.host, server.port, freq_hz=F12C)
        try:
            assert src.tuner_type == 7
            x = src.ring.read_complex64(100_000)
            wait_for(lambda: server.freq_hz == F12C, "the server never saw SET_FREQ")
            assert server.sample_rate == 2_048_000
        finally:
            src.close()
    finally:
        server.stop()
    assert x.dtype == np.complex64 and x.shape == (100_000,)
    np.testing.assert_array_equal(x, quantized(ramp.x[:100_000]))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_set_freq_switches_the_ensemble(pair, two_channels):
    """SET_FREQ mid-stream: before it the ring holds 12C's capture as
    served, after it (once the old samples have drained) 12D's."""
    client, server_mod = PAIRS[pair]
    server = server_mod.RtlTcpServer(server_mod.LoopingCaptureSource(
        {F12C: two_channels["12C"], F12D: two_channels["12D"]})).start()
    try:
        src = client.TcpSource(server.host, server.port, freq_hz=F12C)
        try:
            wait_for(lambda: server.freq_hz == F12C, "the server never saw SET_FREQ")
            src.ring.read_complex64(200_000)            # any samples before the tune
            x = src.ring.read_complex64(65536)
            src.set_freq(F12D)
            wait_for(lambda: server.freq_hz == F12D, "the server never saw the retune")
            src.ring.read_complex64(1_000_000)          # the ring and sockets drain
            y = src.ring.read_complex64(65536)
        finally:
            src.close()
    finally:
        server.stop()
    assert find_in(quantized(two_channels["12C"]), x) >= 0
    assert find_in(quantized(two_channels["12D"]), y) >= 0
    assert find_in(quantized(two_channels["12C"]), y) < 0


class PowerOnChannel:
    """12C's ensemble also on the server's power-on frequency (0 Hz), one
    position for both, so what a client reads does not depend on when its
    SET_FREQ lands."""

    def __init__(self, rtl, captures):
        self.src = rtl.LoopingCaptureSource(captures)

    def __call__(self, freq_hz, n):
        return self.src(F12C if freq_hz == 0.0 else freq_hz, n)


def run_cli_tcp(controls_mod, cli_main, two_channels, wav, extra=()):
    """`stream --tcp HOST:PORT --channel 12C --no-dashboard` of one package
    against a fresh server of the port's for 12 batches of 2 frames;
    returns what its controls saw at each poll (ensemble, FIBs, frames)."""
    server = port_rtl.RtlTcpServer(PowerOnChannel(port_rtl, {
        F12C: two_channels["12C"], F12D: two_channels["12D"]})).start()
    seen = []
    orig = controls_mod.KeyController

    class AutoQuit(orig):
        def __init__(self, *a, **kw):
            kw["read_key"] = lambda: None
            super().__init__(*a, **kw)

        def poll(self):
            rx = self.receiver
            seen.append((rx.db.ensemble.label, rx.db.ensemble.ensemble_id, rx.stats["fibs"],
                         rx.stats["fib_crc_errors"], self.radio.stats.total_frames,
                         self.radio.channel))
            return len(seen) < 12

    controls_mod.KeyController = AutoQuit
    try:
        rc = cli_main(["stream", "--tcp", f"{server.host}:{server.port}", "--channel", "12C",
                       "--no-dashboard", "--no-device-step", "--batch-frames", "2",
                       "--wav", str(wav), *extra])
    finally:
        controls_mod.KeyController = orig
        server.stop()
    assert rc == 0
    return seen


def test_cli_stream_tcp_equals_tpudab(two_channels, tmp_path, capsys):
    """`stream --tcp HOST:PORT --channel 12C --no-dashboard`: the port's
    CLI decodes the socket-served ensemble as tpudab's does, each against
    a fresh instance of the port's server."""
    got = run_cli_tcp(port_controls, main, two_channels, tmp_path / "port.wav",
                      ("--device", "cpu"))
    want = run_cli_tcp(jax_controls, jax_main, two_channels, tmp_path / "tpudab.wav")
    out = capsys.readouterr().out.splitlines()
    assert got == want
    assert got[-1][:2] == ("Mux Charlie", 0xC12C) and got[-1][3] == 0 and got[-1][5] == "12C"
    stopped = [ln for ln in out if ln.startswith("stopped:")]
    assert len(stopped) == 2 and stopped[0] == stopped[1], stopped
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "tpudab.wav").read_bytes()


@pytest.mark.parametrize("device_step", [False, True], ids=["host", "step"])
def test_stream_retune_while_running(two_channels, device_step):
    """tests/test_live_source.py's retune, on the port's radio (CPU) and
    client and tpudab's server: locked on 12C, radio.retune("12D") (the
    '>' key's call) drains the old channel's samples, resets the database
    and the decoders (on the step path the step too), reacquires and
    decodes the other ensemble."""
    server = jax_rtl.RtlTcpServer(jax_rtl.LoopingCaptureSource(
        {F12C: two_channels["12C"], F12D: two_channels["12D"]})).start()
    src = port_rtl.TcpSource(server.host, server.port, freq_hz=F12C)
    radio = StreamingRadio(src.ring.read_complex64, batch_frames=2,
                           use_device_step=device_step, tuner=src, channel="12C",
                           drift_resample=False, device="cpu")
    seen = {}

    def on_outputs(outputs):
        label = radio.receiver.db.ensemble.label
        if label:
            seen[label] = seen.get(label, 0) + 1
        if label == "Mux Charlie" and "retuned" not in seen \
                and (radio._driver.step is not None or not device_step):
            seen["old_step"] = radio._driver.step
            seen["retuned"] = True
            radio.retune("12D")
        if seen.get("Mux Delta", 0) >= 3 and (radio._driver.step is not None
                                              or not device_step):
            radio.request_stop()

    t = threading.Thread(target=radio.run, kwargs=dict(max_batches=200, on_outputs=on_outputs))
    t.start()
    t.join(timeout=LOOP_TIMEOUT_S)
    try:
        assert not t.is_alive(), "stream loop hung"
        assert seen.get("Mux Charlie", 0) >= 1, seen
        assert seen.get("Mux Delta", 0) >= 3, seen
        assert radio.channel == "12D" and src.freq_hz == F12D
        assert radio.receiver.db.ensemble.ensemble_id == 0xD12D
        if device_step:
            assert radio._driver.step is not None and radio._driver.step is not seen["old_step"]
        else:
            assert radio._driver.step is None
    finally:
        radio.request_stop()
        t.join(timeout=30)
        src.close()
        server.stop()

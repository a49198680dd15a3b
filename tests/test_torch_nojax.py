"""tpudab_torch must run where jax and ml_dtypes are not installed (as on a
GPU machine), and imports nothing of tpudab. A subprocess refuses jax,
jaxlib, ml_dtypes and tpudab (by the first name component, so tpudab_torch
passes), imports every module of the port, its tools and the smoke script,
synthesises a 5-frame capture and runs one CPU ReceiveStep, the CPU
Receiver (the host per-stage path), the offline pipeline (with and
without the step) and the live loop (StreamingRadio over an array source)
on it, the sharded step in a world of one (gloo), the numpy acquisition
oracle and a packet-mode FIC with FM/DRM links, and finds no tpudab module
loaded at the end."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "ml_dtypes", "tpudab")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"{name} is refused in this test")
            return None

    sys.meta_path.insert(0, Refuse())

    import numpy as np
    import torch
    import tpudab_torch
    mods = [m.name for m in pkgutil.walk_packages(tpudab_torch.__path__, "tpudab_torch.")]
    assert any(m.startswith("tpudab_torch.tools.") for m in mods), mods
    assert {"tpudab_torch.parallel", "tpudab_torch.parallel.sharded_step",
            "tpudab_torch.host.rtl_tcp", "tpudab_torch.tools.launch_multihost",
            "tpudab_torch.ofdm.sync_np", "tpudab_torch.tools.bench",
            "tpudab_torch.tools.bench_scaling"} <= set(mods)
    for m in mods:
        importlib.import_module(m)
    import chip_smoke  # the smoke script imports only the port and torch

    from tpudab_torch.constants.puncture import eep_profile
    from tpudab_torch.fec.crc import check_fib_crc
    from tpudab_torch.models.step import ReceiveStep
    from tpudab_torch.msc.subchannel import SubchannelConfig
    from tpudab_torch.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                                    ServiceSpec, SubchannelSpec, modulate_frame_bits)
    sub = (SubchannelConfig(1, 0, 24, eep_profile(24, 3, 0)),)
    spec = EnsembleSpec(0xBE9C, "Guard", [ServiceSpec(0xC201, "G", [(0, ASCTY_DAB_PLUS, 1)])],
                        [SubchannelSpec(1, 0, 24, ("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=1)
    data = np.random.default_rng(2).integers(0, 256, (20, 96)).astype(np.uint8)
    synth.payload_fn[1] = lambda m: data[m].tobytes()
    frames = np.stack([modulate_frame_bits(synth.frame_bits(i)) for i in range(5)])
    step = ReceiveStep(1, sub)
    tiled = step.tile_frames(frames)
    re = torch.from_numpy(np.ascontiguousarray(tiled.real, np.float32)).to(torch.bfloat16)
    im = torch.from_numpy(np.ascontiguousarray(tiled.imag, np.float32)).to(torch.bfloat16)
    _, out = step(step.init_carry("cpu"), re, im, 0.0)
    assert check_fib_crc(out["fic_bytes"].numpy().reshape(-1, 3, 32)).all()
    assert (out["subch"][1].numpy()[15:] == data[:5]).all()

    from tpudab_torch.models.receiver import Receiver
    bits = np.stack([synth.frame_bits(i) for i in range(5)])
    rx = Receiver(1, "cpu")
    outs = rx.process_frame_bits(1.0 - 2.0 * bits.astype(np.float32))
    assert rx.stats["fibs"] == 60 and rx.stats["fib_crc_errors"] == 0
    assert rx.db.ensemble.label == "Guard" and 1 in rx.subch_decoders
    assert (outs[1].raw_frames == data[:5]).all()

    from tpudab_torch.models.pipeline import decode_iq
    for device_step in (False, True):
        rx, acc, stats = decode_iq(frames.reshape(-1), batch_frames=2, device="cpu",
                                   use_device_step=device_step)
        assert stats.frame_start == 0 and rx.stats["fib_crc_errors"] == 0
        assert (np.concatenate([o.raw_frames for o in acc[1]]) == data[:5]).all()

    from tpudab_torch.host.streaming import StreamingRadio
    iq, pos, got = frames.reshape(-1), [0], []

    def source(n):
        lo = pos[0]
        pos[0] = min(lo + n, iq.shape[0])
        return iq[lo: pos[0]]
    radio = StreamingRadio(source, batch_frames=2, device="cpu")
    radio.run(on_outputs=lambda outs: got.extend(
        o.raw_frames for o in outs.values() if o.raw_frames is not None and len(o.raw_frames)))
    got = np.concatenate(got)
    assert radio.stats.state == "STOPPED" and radio.stats.total_frames == 5
    assert radio.receiver.stats["fib_crc_errors"] == 0 and (got == data[: len(got)]).all()
    # the sharded step in a world of one (gloo, mesh (1, 1)): the step's bytes
    import socket, datetime
    import torch.distributed as dist
    from tpudab_torch.parallel import ShardedReceiveStep, make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    sharded = ShardedReceiveStep(make_mesh(), 1, sub, device="cpu")
    _, sout = sharded(sharded.init_carry(1), *sharded.shard_inputs(frames[None], [0.0]))
    sout = sharded.gather_outputs(sout)
    dist.destroy_process_group()
    assert (sout["fic_bytes"][0] == out["fic_bytes"]).all()
    assert (sout["subch"][1][0] == out["subch"][1]).all()

    # the numpy acquisition oracle, and a packet-mode FIC with FM/DRM links
    from tpudab_torch.ofdm.sync_np import acquire_np
    acq = acquire_np(frames.reshape(-1))
    assert acq["frame_start"] == 0 and acq["coarse_bins"] == 0
    pk = chip_smoke.packet_mux_spec()
    assert EnsembleSynthesizer(pk, seed=1).build_fic_bits(0).shape == (9216,)

    bad = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    assert not bad, bad
    print("OK", len(mods))
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")   # see one_torch_thread
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")

"""The port's sharded receive step (tpudab_torch.parallel) against tpudab's
ShardedReceiveStep, and its launcher.

The port's ranks run in spawned processes joined by gloo on the CPU (a
free port, init_process_group with a 60 s timeout, the world joined with
a deadline and killed on a hang); tpudab's step runs in this process on
conftest's 8-device CPU mesh. The spawned workers import this module, so
it imports nothing of tpudab or jax at its top.

Tolerances: decoded bytes are equal. tpudab's rows 0-14 (the zero-carry
warm-up, erased codewords that tpudab's XLA Viterbi and the port's twin,
which follows Pallas, break ties in apart) are compared from row 15 on, as
every consumer reads them; every row of the port's sharded step, the seams
among them, equals the port's own ReceiveStep over the whole capture. The
carry holds demodulated soft bits. Against the port's ReceiveStep, whose
one demod runs the DFT GEMMs at another batch size than the sharded
step's two (so a bf16 product may round an ulp apart), it is held to
equal signs and one bf16 ulp; against tpudab's to equal signs and the
relative RMS bounds of tests/test_torch_step.py (the two round the bf16
DFT apart). Two chained calls and one call demodulate the same edge
frames at the same batch size: their carries are equal bit for bit.
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tpudab_torch.constants.dab_params import get_dab_params
from tpudab_torch.constants.puncture import eep_profile
from tpudab_torch.models.convert import carry_to_numpy
from tpudab_torch.models.step import ReceiveStep
from tpudab_torch.msc.subchannel import SubchannelConfig
from tpudab_torch.parallel import Mesh, ShardedReceiveStep, default_mesh_shape, make_mesh
from tpudab_torch.tools.launch_multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240
SUB24 = (1, 0, 24)      # id, start CU, size CU; EEP 3-A (test_parallel.py's capture)
SUB36 = (1, 0, 36)      # test_modes.py's
CARRY_REL_RMS = {"bfloat16": 3e-3, "float32": 1.5e-3}


def configs(layout):
    return tuple(SubchannelConfig(sid, start, size, eep_profile(size, 3, 0))
                 for sid, start, size in layout)


def _world_worker(rank, world, port, jobs, out_path):
    """One rank: every job's calls through the port's ShardedReceiveStep on
    the CPU; rank 0 saves the gathered outputs and its carry after each."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        saved = {}
        for name, job in jobs.items():
            step = ShardedReceiveStep(make_mesh(job["shape"]), job["mode"],
                                      configs(job["layout"]), soft_dtype=job["soft_dtype"],
                                      halo_exchange=job.get("halo", True), device="cpu")
            n_ens = job["calls"][0].shape[0]
            carry = (step.carry_from_jax(job["carry"]) if "carry" in job
                     else step.init_carry(n_ens))
            for i, frames in enumerate(job["calls"]):
                carry, out = step(carry, *step.shard_inputs(frames, np.zeros(n_ens)))
                got = step.gather_outputs(out)
                if rank == 0:
                    saved[f"{name}/{i}/fic"] = got["fic_bytes"].numpy()
                    for sid, v in got["subch"].items():
                        saved[f"{name}/{i}/subch{sid}"] = v.numpy()
                    for k, v in carry_to_numpy(carry).items():
                        saved[f"{name}/{i}/{k}"] = v
        if rank == 0:
            np.savez(out_path, **saved)
    finally:
        dist.destroy_process_group()


def run_world(world, jobs, path):
    """Spawn `world` gloo ranks on the CPU running `jobs`; fail on a
    worker's error or when the world outlives WORLD_TIMEOUT_S (its
    processes are killed)."""
    ctx = mp.start_processes(_world_worker, args=(world, free_port(), jobs, str(path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, f"the {world}-rank world hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with np.load(path) as f:
        return dict(f)


def as_f32(v):
    """A carry_to_numpy array (f32, or bf16 as its uint16 bits) as f32."""
    if v.dtype == np.uint16:
        return (v.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(v, np.float32)


def assert_within_bf16_ulp(got, want, what):
    """Soft bits of one demod against another's that ran its DFT GEMMs at
    another batch size (whose bf16 products may round an ulp apart): equal
    signs, and at most one bf16 ulp of the reference apart."""
    g, w = as_f32(got), as_f32(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    np.testing.assert_array_equal(g < 0, w < 0, err_msg=what)
    assert (np.abs(g - w) <= ulp).all(), (what, float(np.max(np.abs(g - w) / ulp)))


def port_step(frames, layout, soft_dtype, mode=1):
    """The port's single-device ReceiveStep over (E, T, L) frames, one call:
    (carry, fic_bytes, subch) as numpy with a leading E axis."""
    e = frames.shape[0]
    step = ReceiveStep(mode, configs(layout), n_ensembles=e, soft_dtype=soft_dtype)
    tiled = step.tile_frames(frames if e > 1 else frames[0])
    carry, out = step(step.init_carry("cpu"),
                      torch.from_numpy(np.ascontiguousarray(tiled.real, np.float32)),
                      torch.from_numpy(np.ascontiguousarray(tiled.imag, np.float32)), 0.0)
    lead = (lambda x: x) if e > 1 else (lambda x: x[None])
    return ({k: lead(v) for k, v in carry_to_numpy(carry).items()},
            lead(out["fic_bytes"].numpy()), {k: lead(v.numpy()) for k, v in out["subch"].items()})


def jax_sharded(frames_calls, shape, mode=1, carry=None):
    """tpudab's ShardedReceiveStep on the first shape[0] * shape[1] CPU
    devices: [(carry, fic_bytes, subch)] a call, as numpy."""
    import jax
    from tpudab.parallel.mesh import make_mesh as jax_mesh
    from tpudab.parallel.sharded_step import ShardedReceiveStep as JaxSharded
    from tpudab.msc.subchannel import SubchannelConfig as JaxConfig

    n = shape[0] * shape[1]
    layout = SUB24 if mode == 1 else SUB36
    cfg = JaxConfig(layout[0], layout[1], layout[2], eep_profile(layout[2], 3, 0))
    step = JaxSharded(jax_mesh(n, shape=shape, devices=jax.devices()[:n]), mode=mode,
                      subchannels=(cfg,))
    e = frames_calls[0].shape[0]
    carry = step.init_carry(e) if carry is None else carry
    outs = []
    for frames in frames_calls:
        fr, fi, fq = step.shard_inputs(frames, np.zeros(e, np.float32))
        carry, out = step(carry, fr, fi, fq)
        outs.append(({k: np.asarray(v) for k, v in carry.items()},
                     np.asarray(out["fic_bytes"]),
                     {k: np.asarray(v) for k, v in out["subch"].items()}))
    return outs


# ---------------------------------------------------------------------------
# the captures and the two worlds, each spawned once for the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def captures():
    from test_modes import _payload_capture
    from test_parallel import _make_capture

    dab = {m: get_dab_params(m) for m in (2, 3, 4)}
    return {
        "a": _make_capture(8, 3),                          # (8, L) mode I, payload
        "b": _make_capture(16, 4),
        "c": [_make_capture(8, 20 + s) for s in range(2)],
        **{f"mode{m}": _payload_capture(m, 2 * -(-15 // dab[m].nb_cifs), seed=40 + m)
           for m in (2, 3, 4)},
    }


@pytest.fixture(scope="module")
def reference(captures):
    """tpudab's sharded outputs for every case."""
    a, b = captures["a"][0][None], captures["b"][0][None]
    ref = {"a": jax_sharded([a], (1, 2)),
           "b": jax_sharded([b[:, :8], b[:, 8:]], (1, 2)),
           "c": jax_sharded([np.stack([c[0] for c in captures["c"]])], (2, 2))}
    for m in (2, 3, 4):
        ref[f"mode{m}"] = jax_sharded([captures[f"mode{m}"][0][None]], (1, 2), mode=m)
    return ref


@pytest.fixture(scope="module")
def world2(captures, reference, tmp_path_factory):
    """The port at mesh (1, 2): every case of one world of 2 ranks."""
    a, b = captures["a"][0][None], captures["b"][0][None]
    jobs = {
        "a_f32": {"calls": [a], "soft_dtype": "float32"},
        "a_bf16": {"calls": [a], "soft_dtype": "bfloat16"},
        "a_nohalo": {"calls": [a], "soft_dtype": "float32", "halo": False},
        "b_one": {"calls": [b], "soft_dtype": "float32"},
        "b_two": {"calls": [b[:, :8], b[:, 8:]], "soft_dtype": "float32"},
        # tpudab's carry after its first call, continued by the port
        "f": {"calls": [b[:, 8:]], "soft_dtype": "float32", "carry": reference["b"][0][0]},
    }
    for j in jobs.values():
        j.update(shape=(1, 2), mode=1, layout=[SUB24])
    for m in (2, 3, 4):
        jobs[f"mode{m}"] = {"calls": [captures[f"mode{m}"][0][None]], "soft_dtype": "bfloat16",
                            "shape": (1, 2), "mode": m, "layout": [SUB36]}
    return run_world(2, jobs, tmp_path_factory.mktemp("world2") / "out.npz")


@pytest.fixture(scope="module")
def world4(captures, tmp_path_factory):
    """The port at mesh (2, 2): E = 2 (E_l = 1) and E = 4 (E_l = 2)."""
    two = np.stack([c[0] for c in captures["c"]])
    jobs = {"c_e2": {"calls": [two]}, "c_e4": {"calls": [np.concatenate([two, two])]}}
    for j in jobs.values():
        j.update(shape=(2, 2), mode=1, layout=[SUB24], soft_dtype="float32")
    return run_world(4, jobs, tmp_path_factory.mktemp("world4") / "out.npz")


def assert_bytes_like_tpudab(got, name, call, want, rows_from=15):
    """FIC bytes equal; each subchannel's rows equal from rows_from on."""
    carry, fic, subch = want
    np.testing.assert_array_equal(got[f"{name}/{call}/fic"], fic)
    for sid, v in subch.items():
        np.testing.assert_array_equal(got[f"{name}/{call}/subch{sid}"][:, rows_from:],
                                      v[:, rows_from:], err_msg=f"{name} subchannel {sid}")


def assert_carry_close(got, name, call, want_carry, soft_dtype):
    for k, v in want_carry.items():
        g, w = as_f32(got[f"{name}/{call}/{k}"]), np.asarray(v, np.float32)
        assert g.shape == w.shape
        rel_rms = np.sqrt(((g - w) ** 2).mean() / (w ** 2).mean())
        assert rel_rms < CARRY_REL_RMS[soft_dtype], (name, k, rel_rms)
        np.testing.assert_array_equal(g < 0, w < 0, err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_default_mesh_shape_equals_tpudab():
    from tpudab.parallel.mesh import default_mesh_shape as jax_shape
    for n in range(1, 13):
        assert default_mesh_shape(n) == jax_shape(n), n
    assert [default_mesh_shape(n) for n in (1, 8, 6, 9)] == [(1, 1), (4, 2), (3, 2), (3, 3)]


@pytest.mark.parametrize("soft_dtype", ["float32", "bfloat16"])
def test_sharded_step_equals_tpudab_and_the_single_device_step(world2, captures, reference,
                                                               soft_dtype):
    """(a) Mesh (1, 2), mode I, one 24-CU EEP 3-A subchannel: the FIC and
    the payload equal tpudab's sharded step; every row, the seam rows 16-30
    (time shard 1's rows 0-14, decoded from the halo) among them, equals
    the port's ReceiveStep over the whole capture, as does the carry."""
    frames, payload = captures["a"]
    name = "a_f32" if soft_dtype == "float32" else "a_bf16"
    assert_bytes_like_tpudab(world2, name, 0, reference["a"][0])
    assert_carry_close(world2, name, 0, reference["a"][0][0], soft_dtype)
    carry, fic, subch = port_step(frames[None], [SUB24], soft_dtype)
    got = world2[f"{name}/0/subch1"]
    assert got.shape == (1, 32, 96)
    np.testing.assert_array_equal(world2[f"{name}/0/fic"], fic)
    np.testing.assert_array_equal(got, subch[1])
    np.testing.assert_array_equal(got[0, 15:], payload[:17])
    np.testing.assert_array_equal(got[0, 16:31], reference["a"][0][2][1][0, 16:31])
    assert_within_bf16_ulp(world2[f"{name}/0/deint_1"], carry["deint_1"], name)


def test_two_chained_calls_equal_one(world2, reference):
    """(b) The carry crosses from time rank 1 to rank 0 between calls: two
    calls of 8 frames decode as one call of 16, and as tpudab's two."""
    two = np.concatenate([world2["b_two/0/subch1"], world2["b_two/1/subch1"]], axis=1)
    np.testing.assert_array_equal(two, world2["b_one/0/subch1"])
    np.testing.assert_array_equal(np.concatenate([world2["b_two/0/fic"], world2["b_two/1/fic"]],
                                                 axis=1), world2["b_one/0/fic"])
    for call in (0, 1):
        assert_bytes_like_tpudab(world2, "b_two", call, reference["b"][call],
                                 rows_from=15 if call == 0 else 0)
        assert_carry_close(world2, "b_two", call, reference["b"][call][0], "float32")
    np.testing.assert_array_equal(world2["b_two/1/deint_1"], world2["b_one/0/deint_1"])


def test_mesh_2x2_batches_ensembles(world4, reference):
    """(c) Mesh (2, 2): E_l = 2 (each capture twice) equals the E_l = 1
    run ensemble for ensemble, which equals tpudab's."""
    assert_bytes_like_tpudab(world4, "c_e2", 0, reference["c"][0])
    for key in ("fic", "subch1"):
        e2, e4 = world4[f"c_e2/0/{key}"], world4[f"c_e4/0/{key}"]
        assert e4.shape[0] == 4
        np.testing.assert_array_equal(e4, np.concatenate([e2, e2]))


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_other_modes_at_mesh_1x2(world2, captures, reference, mode):
    """(d) Modes II, III and IV at mesh (1, 2), ceil(15 / nb_cifs) frames a
    time rank: every FIB CRC passes and the payload is byte-equal, as is
    tpudab's."""
    from tpudab_torch.fec.crc import check_fib_crc

    name = f"mode{mode}"
    assert check_fib_crc(world2[f"{name}/0/fic"].reshape(-1, 32)).all()
    got = world2[f"{name}/0/subch1"][0, 15:]
    np.testing.assert_array_equal(got, captures[name][1][:got.shape[0]])
    assert_bytes_like_tpudab(world2, name, 0, reference[name][0])


def test_halo_exchange_off_changes_the_seam_rows(world2, captures):
    """(e) Without the exchange zeros stand in for the halo: time shard
    1's rows 0-14 (global 16-30) change, its first no longer decodes the
    payload, and the rows each shard decodes from its own frames alone
    stay equal."""
    on, off = world2["a_f32/0/subch1"][0], world2["a_nohalo/0/subch1"][0]
    payload = captures["a"][1]
    np.testing.assert_array_equal(on[16:31], payload[1:16])
    assert not np.array_equal(off[16:31], on[16:31])
    assert not np.array_equal(off[16], payload[1])     # 15 of its 16 CIFs were the halo's
    np.testing.assert_array_equal(off[:16], on[:16])
    np.testing.assert_array_equal(off[31:], on[31:])


def test_carry_from_tpudab_continues_its_stream(world2, reference):
    """(f) tpudab's carry after its first call, sharded onto the port's
    ranks by carry_from_jax, gives tpudab's second call, every row."""
    assert_bytes_like_tpudab(world2, "f", 0, reference["b"][1], rows_from=0)
    np.testing.assert_array_equal(world2["f/0/subch1"], world2["b_two/1/subch1"])


def test_too_few_frames_per_time_rank():
    """(g) t_l * nb_cifs < 15: the halo does not fit one exchange."""
    mesh = Mesh((1, 2), 0, None, None, "gloo")
    step = ShardedReceiveStep(mesh, 1, configs([SUB24]), device="cpu")
    frames = torch.zeros((1, 3, 1536, 128))
    with pytest.raises(ValueError, match="need >= 4 frames per time shard"):
        step(step.init_carry(1), frames, frames, torch.zeros(1))


def test_launch_multihost_local_cpu():
    """`launch_multihost local --num-processes 2 --device cpu`: each
    worker checks its shard and says MULTIHOST_OK."""
    proc = subprocess.run([sys.executable, "-m", "tpudab_torch.tools.launch_multihost",
                           "local", "--num-processes", "2", "--device", "cpu"],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=WORLD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("MULTIHOST_OK") == 2, proc.stdout

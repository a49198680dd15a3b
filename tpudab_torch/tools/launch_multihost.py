"""Multi-process launch of the port's sharded receive step (counterpart of
tpudab's tools/launch_multihost.py and its worker, tests/_multihost_worker.py).

Two modes:

  local  - spawn N worker processes on the local host, joined by gloo: on the
           CPU with --device cpu, otherwise all on cuda:0 with the halo
           staged through host memory. Every worker is killed, and the
           launcher exits non-zero, when one fails or the job outlives
           LOCAL_TIMEOUT_S.

      python -m tpudab_torch.tools.launch_multihost local --num-processes 2 --device cpu

  worker - run ONE process of an N-process job (once per host, e.g. from a
           scheduler, mpirun or ssh), on cuda:(process id mod the cards
           it sees) unless --device cpu:

      python -m tpudab_torch.tools.launch_multihost worker \\
          --coordinator host0:12345 --num-processes 4 --process-id $IDX

Each worker joins the world (init_process_group over tcp://COORDINATOR,
a 60 s timeout), takes its place on the default_mesh_shape(N) mesh,
synthesises the same capture as every other (2 ensembles per ensemble
rank, 4 mode I frames per time rank, one 24-CU EEP 3-A subchannel with a
seeded payload), decodes its block through ShardedReceiveStep, checks its
own shard (every FIB CRC, every payload row past the deinterleaver's
warm-up), prints MULTIHOST_OK and exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
E_PER_RANK, T_PER_RANK = 2, 4      # 4 frames: 16 CIFs, the 15-CIF halo fits
LOCAL_TIMEOUT_S = 300               # `local` kills every worker after this


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now, for a local world's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _capture(e: int, n_frames: int, data_bytes: int):
    """Ensemble e's frames (n_frames, frame_len) and its payload rows."""
    from tpudab_torch.synth import (ASCTY_DAB_PLUS, EnsembleSpec, EnsembleSynthesizer,
                                    ServiceSpec, SubchannelSpec, modulate_frame_bits)

    spec = EnsembleSpec(
        ensemble_id=0x5000 + e, label=f"MH {e}",
        services=[ServiceSpec(0xC300 + e, f"Svc {e}", [(0, ASCTY_DAB_PLUS, 1)])],
        subchannels=[SubchannelSpec(1, start_cu=0, size_cu=24, protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=e)
    data = np.random.default_rng(700 + e).integers(
        0, 256, (n_frames * 4, data_bytes)).astype(np.uint8)
    synth.payload_fn[1] = lambda m: data[m].tobytes()
    return np.stack([modulate_frame_bits(synth.frame_bits(i)) for i in range(n_frames)]), data


def run_worker(coordinator: str, n: int, pid: int, device: str) -> int:
    import torch
    import torch.distributed as dist

    from tpudab_torch.constants.puncture import eep_profile
    from tpudab_torch.fec.crc import check_fib_crc
    from tpudab_torch.msc.subchannel import SubchannelConfig
    from tpudab_torch.parallel import ShardedReceiveStep, make_mesh

    if device != "cpu":
        device = f"cuda:{pid % max(torch.cuda.device_count(), 1)}"
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", rank=pid,
                            world_size=n, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh()
        n_e, n_t = mesh.shape
        e_idx, t_idx = mesh.coords
        cfg = SubchannelConfig(1, 0, 24, eep_profile(24, 3, 0))
        caps = [_capture(e, n_t * T_PER_RANK, cfg.data_bits // 8)
                for e in range(n_e * E_PER_RANK)]
        frames = np.stack([c[0] for c in caps])
        step = ShardedReceiveStep(mesh, 1, (cfg,), device=device)
        _, out = step(step.init_carry(len(caps)), *step.shard_inputs(frames, np.zeros(len(caps))))

        fibs = out["fic_bytes"].cpu().numpy().reshape(-1, 32)
        if not check_fib_crc(fibs).all():
            raise SystemExit(f"rank {pid}: {int((~check_fib_crc(fibs)).sum())} FIB CRC failures")
        got = out["subch"][1].cpu().numpy()           # (E_l, C_l, bytes)
        c0 = t_idx * got.shape[1]
        n_rows = 0
        for j, rows in enumerate(got):
            payload = caps[e_idx * E_PER_RANK + j][1]
            for c, row in enumerate(rows):
                if c0 + c >= 15:                      # past the warm-up
                    if not np.array_equal(row, payload[c0 + c - 15]):
                        raise SystemExit(f"rank {pid}: ensemble {e_idx * E_PER_RANK + j} "
                                         f"CIF row {c0 + c} is not its payload")
                    n_rows += 1
        if n_rows == 0:
            raise SystemExit(f"rank {pid}: no payload row checked")
        print(f"MULTIHOST_OK pid={pid} mesh={mesh.shape} coords={mesh.coords} "
              f"device={step.device} fibs={len(fibs)} payload_cifs={n_rows}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def local_env(threads: int) -> dict:
    """The environment of a local worker: the repo first on PYTHONPATH and,
    unless set, OMP_NUM_THREADS threads."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    env.setdefault("OMP_NUM_THREADS", str(threads))
    return env


def run_local(n: int, device: str) -> int:
    coord = f"127.0.0.1:{free_port()}"
    env = local_env(max(1, (os.cpu_count() or 1) // n))  # a share of the cores each
    procs = [subprocess.Popen([sys.executable, "-m", "tpudab_torch.tools.launch_multihost",
                               "worker", "--coordinator", coord, "--num-processes", str(n),
                               "--process-id", str(i), "--device", device], env=env, cwd=ROOT)
             for i in range(n)]
    deadline = time.monotonic() + LOCAL_TIMEOUT_S
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                rc = 1
                break
            time.sleep(0.1)
        rc = rc or max(p.returncode for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if rc:
        print(f"launch_multihost: a worker failed or the job outlived {LOCAL_TIMEOUT_S} s: "
              f"exit codes {[p.returncode for p in procs]}", file=sys.stderr)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    lo = sub.add_parser("local")
    lo.add_argument("--num-processes", type=int, default=2)
    wk = sub.add_parser("worker")
    wk.add_argument("--coordinator", required=True, metavar="HOST:PORT")
    wk.add_argument("--num-processes", type=int, required=True)
    wk.add_argument("--process-id", type=int, required=True)
    for p in (lo, wk):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "local":
        return run_local(args.num_processes, args.device)
    return run_worker(args.coordinator, args.num_processes, args.process_id, args.device)


if __name__ == "__main__":
    sys.exit(main())

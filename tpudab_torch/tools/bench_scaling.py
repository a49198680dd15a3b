"""Weak-scaling sweep of the sharded receive step over torch.distributed
ranks (the port of the repo's bench_scaling.py).

The per-rank work is fixed: one 24-CU EEP 3-A subchannel, 2 ensembles x 4
frames a rank, complex Gaussian frames from default_rng(0); perfect
scaling keeps the per-rank sample rate flat. Where tpudab runs one
process of n virtual devices, the port runs n ranks, one process each:

- for each size n in SIZES (mesh default_mesh_shape(n), (1, 1) for
  n = 1), n worker processes join a world on a fresh port, rank r pinned
  by taskset to a core of its own (shared beyond the core count) where
  taskset exists. Each runs one warm step and `reps` steps of
  ShardedReceiveStep on the host clock (on the card synchronised before
  each read), then times the halo directly
  (halo_ms): PERMUTE_ITERS dependent exchanges of the step's halo shape
  (E_l, 15, slice_bits) f32 to the right time neighbour, on the step's
  own exchange path (post_halo / wait_halo), 0.0 with one time rank. The
  slowest rank gives the row; the best of `trials` worlds is kept;
- the transport: gloo on the CPU. On the card NCCL where every rank has
  a card of its own; else gloo, rank r on cuda:(r mod cards), the halo
  staged through host memory. A size with more ranks than cards, or than
  cores, is marked oversubscribed;
- the two-process gloo row (tpudab's "dcn" row, `two_process_gloo`): the
  size-2 world forced onto gloo, PERMUTE_ITERS_GLOO exchanges;
- the summary: bench_scaling.py's keys and formulas (summary()), with the
  card's name and power limit under `device` in it and in every row.

Prints each row, the two-process row and the whole summary (its last
line) as JSON; --out PATH also writes the summary there. A worker that
fails, or a world that outlives WORLD_TIMEOUT_S, ends the run with exit
code 1 after the ranks' output.

Run: python -m tpudab_torch.tools.bench_scaling [--device cpu] [--reps N]
         [--trials N] [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpudab_torch.constants.ofdm_params import SAMPLING_RATE, get_ofdm_params
from tpudab_torch.constants.puncture import eep_profile
from tpudab_torch.msc.interleave import TIME_INTERLEAVE_DEPTH
from tpudab_torch.msc.subchannel import SubchannelConfig
from tpudab_torch.parallel.mesh import default_mesh_shape
from tpudab_torch.tools._common import card
from tpudab_torch.tools.launch_multihost import ROOT, free_port, local_env
from tpudab_torch.utils.device import resolve_device

SIZES = (1, 2, 4, 8)
PERMUTE_ITERS, PERMUTE_ITERS_GLOO = 64, 32   # bench_scaling.py's chains
WORLD_TIMEOUT_S = 600          # a world's processes are killed after this
JOIN_TIMEOUT_S = 60            # init_process_group's


def bench_config():
    """(cfg, ensembles a rank, frames a rank): one 24-CU EEP 3-A subchannel,
    2 x 4 (bench_scaling.py's _bench_config)."""
    cfg = SubchannelConfig(subch_id=1, start_cu=0, size_cu=24, profile=eep_profile(24, 3, 0))
    return cfg, 2, 4


def world_backend(n: int, dev: torch.device) -> str:
    """NCCL where each of n ranks has a card of its own, else gloo."""
    return "nccl" if dev.type == "cuda" and n <= torch.cuda.device_count() else "gloo"


def host_cores() -> list:
    """The cores this process may run on (its affinity mask where the OS
    has one)."""
    if hasattr(os, "sched_getaffinity"):
        return sorted(os.sched_getaffinity(0))
    return list(range(os.cpu_count() or 1))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def halo_ms(step, e_l: int, slice_bits: int, iters: int = PERMUTE_ITERS) -> float:
    """ms of one halo exchange (bench_scaling.py's _permute_microbench):
    iters dependent exchanges of an (e_l, 15, slice_bits) f32 block, each
    sending what the last received, after one warm exchange and a
    barrier; 0.0 with one time rank. Every rank of the world calls it."""
    import torch.distributed as dist

    if step.n_time < 2:
        return 0.0
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (e_l, TIME_INTERLEAVE_DEPTH - 1, slice_bits)).astype(np.float32)).to(step.device)
    x = step.wait_halo(step.post_halo(x))
    _sync(step.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        x = step.wait_halo(step.post_halo(x))
    _sync(step.device)
    return (time.perf_counter() - t0) / iters * 1e3


def worker(n: int, mesh_shape, reps: int, rank: int = 0, coordinator: str = "",
           device="cuda", backend: str = "", iters: int = PERMUTE_ITERS) -> dict:
    """One rank of a world of n (bench_scaling.py's worker): joins the world
    at coordinator (a fresh local port by default; backend: world_backend's
    by default), runs the step and halo_ms, prints "RESULT " + its JSON and
    returns it: bench_scaling.py's RESULT keys, plus rank, backend and
    cards (the cards the world's ranks use, 0 on the CPU)."""
    import torch.distributed as dist

    from tpudab_torch.parallel import ShardedReceiveStep, make_mesh

    dev = resolve_device(device)
    cards = 0
    if dev.type == "cuda":
        cards = min(n, torch.cuda.device_count())
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or world_backend(n, dev)
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        p = get_ofdm_params(1)
        cfg, e_per_shard, t_per_shard = bench_config()
        n_ens = mesh_shape[0] * e_per_shard
        t_total = mesh_shape[1] * t_per_shard
        rng = np.random.default_rng(0)
        frames = (rng.standard_normal((n_ens, t_total, p.nb_frame_length))
                  + 1j * rng.standard_normal((n_ens, t_total, p.nb_frame_length)))
        mesh = make_mesh(tuple(mesh_shape))
        out = {"n_devices": n, "mesh": list(mesh_shape), "ensembles": n_ens, "frames": t_total,
               "rank": rank, "backend": mesh.backend, "cards": cards}
        step = ShardedReceiveStep(mesh, 1, (cfg,), device=dev)
        fr, fi, fq = step.shard_inputs(frames, np.zeros(n_ens, np.float32))
        carry = step.init_carry(n_ens)
        carry, res = step(carry, fr, fi, fq)          # warm
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            carry, res = step(carry, fr, fi, fq)
        _sync(dev)
        out["step_ms"] = round((time.perf_counter() - t0) / reps * 1e3, 2)

        samples = n_ens * t_total * p.nb_frame_length
        per_dev = samples / (out["step_ms"] / 1e3) / n
        out["samples_per_s_per_device"] = round(per_dev)
        out["realtime_x_per_device"] = round(per_dev / SAMPLING_RATE, 2)
        out["collective_ms"] = round(halo_ms(step, e_per_shard, cfg.slice_bits, iters), 3)
        out["collective_fraction"] = round(out["collective_ms"] / out["step_ms"], 4)
    finally:
        dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return out


def run_world(n: int, worker_args, device: str, timeout: float = WORLD_TIMEOUT_S) -> list:
    """n processes of `python -m tpudab_torch.tools.bench_scaling
    <worker_args> --process-id r --coordinator ... --device device`, rank r
    pinned by taskset to the r-th of host_cores() (mod their count) where
    taskset exists. Returns every rank's RESULT, in rank order. If a rank
    fails or the world outlives timeout, every process is killed, the
    ranks' output goes to stderr and RuntimeError is raised."""
    cores = host_cores()
    pinned = shutil.which("taskset") is not None
    env = local_env(1 if pinned else max(1, len(cores) // n))
    coord = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as files:
        logs = [files.enter_context(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                for r in range(n)]
        procs = []
        try:
            for r in range(n):
                cmd = [sys.executable, "-m", "tpudab_torch.tools.bench_scaling", *worker_args,
                       "--process-id", str(r), "--coordinator", coord, "--device", device]
                if pinned:
                    cmd = ["taskset", "-c", str(cores[r % len(cores)])] + cmd
                procs.append(subprocess.Popen(cmd, stdout=logs[r], stderr=subprocess.STDOUT,
                                              env=env, cwd=ROOT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
    results = [next((json.loads(line[len("RESULT "):]) for line in out.splitlines()
                     if line.startswith("RESULT ")), None) for out in outs]
    if any(p.returncode for p in procs) or None in results:
        for r, out in enumerate(outs):
            sys.stderr.write(f"--- rank {r} of {n} (exit code {procs[r].returncode})\n{out}")
        raise RuntimeError(f"a worker of the {n}-rank world failed or the world outlived "
                           f"{timeout} s: exit codes {[p.returncode for p in procs]}")
    return results


def best_world(n: int, worker_args, device: str, trials: int, timeout: float) -> dict:
    """The best (least step_ms) of `trials` worlds of run_world, each
    world's result its slowest rank's RESULT."""
    def step_ms(r):
        return r["step_ms"]
    return min((max(run_world(n, worker_args, device, timeout), key=step_ms)
                for _ in range(trials)), key=step_ms)


def size_row(n: int, reps: int, trials: int, device: str,
             timeout: float = WORLD_TIMEOUT_S) -> dict:
    """The row of size n (best_world), with trials, cores_used and
    oversubscribed (more ranks than cores, or on the card than cards)."""
    shape = (1, 1) if n == 1 else default_mesh_shape(n)
    best = best_world(n, ["--worker", "--devices", str(n), "--mesh", f"{shape[0]},{shape[1]}",
                          "--reps", str(reps)], device, trials, timeout)
    cores = len(host_cores())
    pinned = shutil.which("taskset") is not None
    over_cards = device != "cpu" and n > torch.cuda.device_count()
    return {**best, "trials": trials, "cores_used": min(n, cores) if pinned else cores,
            "oversubscribed": n > cores or over_cards}


def gloo_row(reps: int, trials: int, device: str, timeout: float = WORLD_TIMEOUT_S) -> dict:
    """The two-process gloo row (bench_scaling.py's run_dcn_row): mesh
    (1, 2) on gloo (best_world)."""
    best = best_world(2, ["--dcn-worker", "--reps", str(reps)], device, trials, timeout)
    return {"n_processes": 2, "devices_per_process": 1, "transport": "gloo",
            "backend": best["backend"], "cards": best["cards"], "step_ms": best["step_ms"],
            "samples_per_s_per_device": best["samples_per_s_per_device"],
            "realtime_x_per_device": best["realtime_x_per_device"],
            "collective_ms": best["collective_ms"]}


def summary(results: list, dcn: dict, cores: int, pinned: bool, device: str) -> dict:
    """bench_scaling.py's summary (its keys and formulas) of the rows of
    SIZES and the two-process row, with `device`."""
    base = results[0]["samples_per_s_per_device"]
    honest = [r for r in results if not r["oversubscribed"]] or results[:1]
    eff_h = honest[-1]["samples_per_s_per_device"] / base
    eff_all = results[-1]["samples_per_s_per_device"] / base
    return {
        "metric": "weak_scaling_efficiency",
        "value": round(eff_h, 3),
        "unit": "fraction_of_linear",
        "vs_baseline": round(eff_h / 0.8, 3),       # target >= 0.80
        "host_cores": cores,
        "pinned": pinned,
        "efficiency_within_cores": round(eff_h, 3),
        "within_cores_devices": honest[-1]["n_devices"],
        "efficiency_8dev_oversubscribed": round(eff_all, 3),
        "collective_fraction_largest_honest": honest[-1]["collective_fraction"],
        "two_process_gloo": dcn,
        "two_process_gloo_efficiency": (
            round(dcn["samples_per_s_per_device"] / base, 3)
            if "samples_per_s_per_device" in dcn else None),
        "device": device,
        "results": results,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--dcn-worker", action="store_true")
    ap.add_argument("--devices", type=int, help="the world's ranks (--worker)")
    ap.add_argument("--mesh", type=str, help="ensemble,time (--worker)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", type=str, default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card is an error) or cpu, for rehearsal")
    ap.add_argument("--reps", type=int,
                    default=int(os.environ.get("TPUDAB_SCALING_REPS", "5")))
    ap.add_argument("--trials", type=int,
                    default=int(os.environ.get("TPUDAB_SCALING_TRIALS", "3")),
                    help="worlds a size; the best is kept")
    ap.add_argument("--out", type=str, default="", help="also write the summary here")
    args = ap.parse_args(argv)

    if args.worker:
        return worker(args.devices, [int(x) for x in args.mesh.split(",")], args.reps,
                      args.process_id, args.coordinator, args.device)
    if args.dcn_worker:
        return worker(2, (1, 2), args.reps, args.process_id, args.coordinator, args.device,
                      backend="gloo", iters=PERMUTE_ITERS_GLOO)

    dev = resolve_device(args.device)
    label = card(dev)
    if dev.type == "cuda":                 # build the kernels once, before the workers
        from tpudab_torch.ops._build import load_library
        load_library()
    results = []
    for n in SIZES:
        r = {**size_row(n, args.reps, args.trials, args.device), "device": label}
        results.append(r)
        print(json.dumps(r), flush=True)
    dcn = {**gloo_row(args.reps, args.trials, args.device), "device": label}
    print(json.dumps({"two_process_gloo": dcn}), flush=True)
    out = summary(results, dcn, len(host_cores()), shutil.which("taskset") is not None, label)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

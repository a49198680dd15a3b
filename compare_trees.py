"""Times the port's Viterbi traceback modes (X2's tbonly, X5), K1+K3 at
the host path's three shapes, K1+K2 at the step's two, the 13 int16 probe
ops beside torch.add, K5 at the step's shape, the six carve ablations (X7)
at their tool's, and the bench step, in the checkout given as the first
argument, on one NVIDIA GPU; one JSON line with the card's name and power
limit, and ptxas' registers and spill stores of each carve kernel. Two
checkouts are compared on one card by running it on each in turns
(A, B, B, A) in one command:

    python3 compare_trees.py /path/to/other/checkout; python3 compare_trees.py .

Each entry is (CUDA-event ms a call, profiler device ms a call); K5's
and X7's also hold the device ms of a call queued behind a spin kernel
(device_ms). The step is three CUDA-event means of 5 steps.
"""
import json
import os
import re
import subprocess
import sys
import time


def kernel_ms(fn, reps, name):
    """Mean profiler device ms per fn() call of the kernels named `name`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type == DeviceType.CUDA and name in k.key) / 1e3 / reps


def device_ms(fn, reps):
    """Mean device ms per fn() call, queued behind a spin kernel that
    outlasts the host's enqueue (chip_smoke.py::device_ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def carve_resources(log):
    """{kernel: [registers, spill store bytes]} of the carve kernels in
    ptxas' -v report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "carve" in m.group(1) else None
            if name:
                out[name] = [0, 0]
        elif name:
            for pattern, slot in ((r"Used (\d+) registers", 0), (r"(\d+) bytes spill stores", 1)):
                m = re.search(pattern, line)
                if m:
                    out[name][slot] = int(m.group(1))
    return out


def main(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import tpudab_torch
    from tpudab_torch.ops import _build

    if not tpudab_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {tpudab_torch.__file__}, not the checkout {tree}")
    from tpudab_torch.constants.puncture import FIC_PROFILE, eep_profile, get_uep_profile
    from tpudab_torch.fec.depuncture import depuncture_index, depuncture_t
    from tpudab_torch.ops.i16_probe import OPS, i16_probe_cuda
    from tpudab_torch.ops.viterbi import mother_to_t
    from tpudab_torch.ops.viterbi_cuda import (signs_on, viterbi_decode_bits_cuda,
                                               viterbi_decode_bytes_t_cuda)
    from tpudab_torch.ops.viterbi_exp import fwd_variant_cuda, traceback_bytes_cuda
    from tpudab_torch.tools._common import timer

    dev = torch.device("cuda", 0)
    cuda_ms = timer(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    _build.load_library()
    res = {"tree": tree, "card": card, "build_s": time.perf_counter() - t0,
           "carve_ptxas": carve_resources(_build.BuildInfo.log)}
    rng = np.random.default_rng(8)
    signs = signs_on(dev)

    soft = torch.from_numpy(rng.standard_normal((6144, 3456 + 6, 4), dtype=np.float32)).to(dev)
    decs, _ = fwd_variant_cuda(mother_to_t(soft, 256), signs, "full", 32)
    del soft
    want = traceback_bytes_cuda(decs, "shuffle")
    for mode in ("shuffle", "masked", "tree"):
        if not torch.equal(traceback_bytes_cuda(decs, mode), want):
            raise SystemExit(f"traceback {mode} differs from shuffle")
        f = lambda: traceback_bytes_cuda(decs, mode)
        res[f"tb_{mode}"] = (cuda_ms(f, 10), kernel_ms(f, 10, "viterbi_traceback_kernel"))

    for label, profile, b in (("fic", FIC_PROFILE, 64), ("msc", eep_profile(108, 3, 0), 64),
                              ("calibration", get_uep_profile(128, 3).to_profile(), 260)):
        n = profile.data_bits
        x = torch.from_numpy(rng.standard_normal((b, n + 6, 4), dtype=np.float32)).to(dev)
        f = lambda: viterbi_decode_bits_cuda(x, signs, n)
        res[f"k3_{label}"] = (cuda_ms(f, 10), kernel_ms(f, 10, "viterbi_bits_kernel"))

    for label, profile, b in (("msc", eep_profile(108, 3, 0), 12288), ("fic", FIC_PROFILE, 2048)):
        p = torch.from_numpy(rng.standard_normal((b, int(profile.mask().sum())), dtype=np.float32))
        soft_t = depuncture_t(p.to(dev, torch.bfloat16),
                              torch.tensor(depuncture_index(profile), device=dev))
        n = profile.data_bits
        f = lambda: viterbi_decode_bytes_t_cuda(soft_t, signs, n)
        res[f"k12_{label}"] = (cuda_ms(f, 10), kernel_ms(f, 10, "viterbi_kernel"))

    x = torch.from_numpy(np.random.default_rng(0).integers(-100, 100, (64, 256)).astype(np.int16)).to(dev)
    y = torch.from_numpy(np.random.default_rng(1).integers(-100, 100, (64, 256)).astype(np.int16)).to(dev)
    res["x4_call"] = {op: cuda_ms(lambda: i16_probe_cuda(x, y, op), 20) for op in OPS}
    res["x4_torch_add"] = cuda_ms(lambda: torch.add(x, y), 20)

    from tpudab_torch.ops.carve import carve_rotate_cuda
    from tpudab_torch.ops.carve_exp import carve_variant_cuda
    fr, fi = (torch.from_numpy(rng.standard_normal((512, 1536, 128), dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    freq = torch.from_numpy(rng.uniform(-2000.0, 2000.0, 512).astype(np.float32)).to(dev)
    f = lambda: carve_rotate_cuda(fr, fi, freq, with_sum=True)
    res["k5"] = (cuda_ms(f, 20), kernel_ms(f, 20, "carve_kernel"), device_ms(f, 10))
    fr, fi = (torch.from_numpy(rng.standard_normal((256, 1536, 128), dtype=np.float32)).to(dev)
              for _ in range(2))
    freq = freq[:256].contiguous()
    for label, fb, roll, rotate in (("fb4", 4, True, True), ("fb8", 8, True, True),
                                    ("fb16", 16, True, True), ("noroll", 8, False, True),
                                    ("norotate", 8, True, False), ("copy", 8, False, False)):
        f = lambda: carve_variant_cuda(fr, fi, freq, fb, roll, rotate)
        res[f"x7_{label}"] = (cuda_ms(f, 10), kernel_ms(f, 10, "carve"), device_ms(f, 10))
    del fr, fi

    from tpudab_torch.models.step import ReceiveStep
    from tpudab_torch.tools.bench import bench_capture, bench_subchannels
    frames, _ = bench_capture(16)
    step = ReceiveStep(1, bench_subchannels(), n_ensembles=32).to(dev)
    tiled = step.tile_frames(frames)
    re = torch.from_numpy(np.ascontiguousarray(tiled.real, np.float32)).to(torch.bfloat16)
    im = torch.from_numpy(np.ascontiguousarray(tiled.imag, np.float32)).to(torch.bfloat16)
    re, im = (t.to(dev).expand((32,) + t.shape).contiguous() for t in (re, im))
    freq = torch.zeros((), dtype=torch.float32, device=dev)
    state = {"carry": step.init_carry(dev)}

    def one_step():
        state["carry"], _ = step(state["carry"], re, im, freq)

    res["step_ms"] = [cuda_ms(one_step, 5) for _ in range(3)]
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1])

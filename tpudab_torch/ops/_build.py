"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The library is compiled on first use with nvcc for sm_90a (plain C
interface, no PyTorch headers, so a build takes seconds): one nvcc per
source, all started together, then one link, so a source added to csrc/
does not add its compile time to the others'. It is loaded with ctypes;
pointers and the CUDA stream go in as c_void_p. The file name holds a hash
of the sources and the flags, so a changed source builds anew. A failed
build raises. Nothing here runs at import time: the CPU tests import every
module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes. Each returns cudaGetLastError() as int,
# but tpudab_viterbi_resident_blocks, a count of blocks.
SIGNATURES = {
    "tpudab_viterbi_decode_bytes_t": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "tpudab_viterbi_resident_blocks": (_I, _I),
    "tpudab_viterbi_decode_bits": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "tpudab_deinterleave": (_P, _P, _I, _I, _I, _I, _P),
    "tpudab_deinterleave_depuncture_t": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _I, _I, _I, _I, _P),
    "tpudab_carve_rotate": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P),
    "tpudab_viterbi_fwd_variant": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "tpudab_viterbi_traceback": (_P, _P, _I, _I, _I, _I, _P),
    "tpudab_i16_probe": (_P, _P, _P, _I, _I, _I, _P),
    "tpudab_carve_variant": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _P),
    "tpudab_demod_demap": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tpudab_demod_norm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tpudab_demod_stats": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P),
    "tpudab_copy_h2d": (_P, _P, _P, _I, _P),
    "tpudab_channelise": (_P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P, _P, _L, _P, _L, _I, _L,
                          _P),
}


class BuildInfo:
    """What the last build did: seconds spent (0.0 when the library was
    already built) and nvcc's output, including ptxas' register report
    (kept beside the library, so that a later process reads it too)."""

    seconds = 0.0
    log = ""
    path = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build csrc/*.cu into _build/ (if this hash is not built yet) and load
    it with every entry point's argtypes declared."""
    so = BUILD_DIR / f"libtpudab_torch_{source_digest()}.so"
    BuildInfo.path = str(so)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        srcs = _sources()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            t0 = time.perf_counter()
            objs = [f"{tmp}/{p.stem}.o" for p in srcs]
            cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(p)] for o, p in zip(objs, srcs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            runs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
            if all(rc == 0 for *_, rc in runs):
                link = [_nvcc(), "-shared", "-o", f"{tmp}/lib.so", *objs]
                proc = subprocess.run(link, capture_output=True, text=True)
                runs.append((link, proc.stdout + proc.stderr, proc.returncode))
            BuildInfo.seconds = time.perf_counter() - t0
            BuildInfo.log = "".join(log for _, log, _ in runs)
            for cmd, log, rc in runs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
            so.with_suffix(".log").write_text(BuildInfo.log)
            os.replace(f"{tmp}/lib.so", so)
    elif so.with_suffix(".log").exists():
        BuildInfo.log = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def launch(fn, index: int, what: str, *args) -> None:
    """fn(*args, stream) on the current stream of CUDA device `index`
    (tensor.get_device()), then check(). Pointers go in as plain ints
    (tensor.data_ptr(); None for a null pointer), which the declared
    c_void_p argtypes take as they are; the stream as torch's raw handle,
    with no torch.cuda.Stream object built; a device guard is entered only
    when `index` is not the current device (the launch must run in its
    context)."""
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, what)

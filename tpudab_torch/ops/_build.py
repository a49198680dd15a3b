"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The library is compiled on first use with nvcc for sm_90a (plain C
interface, no PyTorch headers, so a build takes seconds) and loaded with
ctypes; pointers and the CUDA stream go in as c_void_p. The file name holds
a hash of the sources and the flags, so a changed source builds anew. A
failed build raises. Nothing here runs at import time: the CPU tests import
every module on machines without nvcc.
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

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes. Each returns cudaGetLastError() as int.
SIGNATURES = {
    "tpudab_viterbi_decode_bytes_t": (_P, _I, _P, _P, _P, _I, _I, _I, _P),
    "tpudab_deinterleave": (_P, _P, _I, _I, _I, _I, _P),
    "tpudab_carve_rotate": (_P, _P, _I, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P),
}


class BuildInfo:
    """What the last build did: seconds spent (0.0 when the library was
    already built) and nvcc's output, including ptxas' register report."""

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
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(p) for p in _sources()]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{BuildInfo.log}")
        os.replace(tmp, so)
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

"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (no fast-math) into
one shared library with a plain C interface, which :func:`load` opens with
``ctypes``.  The library goes to ``_build/<hash of the sources>/`` inside
the package (git-ignored), so a checkout builds everything from its own
sources: nothing is downloaded or prebuilt.  :func:`build_host` compiles the
host twin of a kernel with the system C++ compiler, for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


@dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built
    log: str               # compiler output (ptxas register/spill report)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(CSRC.glob("*.cuh")) + list(sources):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(cmd_head, flags, sources, out: Path) -> tuple[float, str]:
    """Compile into ``out`` unless it exists; atomic rename, so a build cut
    short leaves no half-written library behind."""
    if out.exists():
        return 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [*cmd_head, *flags, "-I", str(CSRC), "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.riccati_admm_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> Library:
    """Build (once per source hash) and load the CUDA kernels' library."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / _digest(sources, NVCC_FLAGS) / "libpympc_kernels.so"
    seconds, log = _compile([_nvcc()], NVCC_FLAGS, sources, out)
    return Library(_bind(ctypes.CDLL(str(out))), out, seconds, log)


def build_host(source: str, out_dir: Path) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` with the host C++ compiler into ``out_dir``
    and bind it like the CUDA library."""
    src = CSRC / source
    out = Path(out_dir) / f"{src.stem}_{_digest([src], HOST_FLAGS)}.so"
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    _compile([cxx], HOST_FLAGS, [src], out)
    return _bind(ctypes.CDLL(str(out)))

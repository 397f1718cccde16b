"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (no fast-math) into a
shared library of its own with a plain C interface, all sources at once in
parallel, and :func:`load` opens them with ``ctypes``.  The libraries go to
``_build/<hash of the source and headers>/`` inside the package
(git-ignored), so a checkout builds everything from its own sources:
nothing is downloaded or prebuilt.  :func:`build_host` compiles the host
twin of a kernel with the system C++ compiler, for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# Every C launcher of csrc/, with its argument types; each library binds the
# ones it exports.  Pointers and the stream are c_void_p, ints c_int.
SIGNATURES = {
    "riccati_admm_launch": ([_P] * 17 + [_I] * 3 + [_F] * 2 + [_P], _I),
    "riccati_admm_max_horizon": ([], _I),
    "riccati_admm_occupancy": ([_I, _P], _I),
    "admm_workspace_floats": ([_I] * 3, _L),
    "admm_max_n": ([], _I),
    "admm_invert_occupancy": ([_I, _P], _I),
    "admm_invert_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
    "admm_iterate_launch": ([_P] * 13 + [_I] * 4 + [_F] * 2 + [_P], _I),
    "admm_iterate_config": ([_I] * 3 + [_P], _I),
    "admm_fused_launch": ([_P] * 14 + [_I] * 4 + [_F] * 2 + [_I, _P], _I),
    "admm_full_launch": ([_P] * 11 + [_I] * 4 + [_F] * 2 + [_I] * 2 + [_F] * 2 + [_P], _I),
    "admm_fused_config": ([_I] * 3 + [_P], _I),
}


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
    for name, (argtypes, restype) in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def _build_one(src: Path) -> Library:
    out = BUILD_DIR / _digest([src], NVCC_FLAGS) / f"lib{src.stem}.so"
    seconds, log = _compile([_nvcc()], NVCC_FLAGS, [src], out)
    return Library(_bind(ctypes.CDLL(str(out))), out, seconds, log)


@functools.cache
def load_all() -> dict[str, Library]:
    """Build every ``csrc/*.cu`` (one nvcc each, all started together, once
    per source hash) and load them; keys are the source stems."""
    sources = sorted(CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(_build_one, sources))
    return {src.stem: lib for src, lib in zip(sources, libs)}


def load(name: str) -> Library:
    """The loaded library of ``csrc/<name>.cu`` (building them all at first use)."""
    return load_all()[name]


def build_host(source: str, out_dir: Path) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` with the host C++ compiler into ``out_dir``
    and bind it like the CUDA libraries."""
    src = CSRC / source
    out = Path(out_dir) / f"{src.stem}_{_digest([src], HOST_FLAGS)}.so"
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    _compile([cxx], HOST_FLAGS, [src], out)
    return _bind(ctypes.CDLL(str(out)))

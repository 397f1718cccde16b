"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (no fast-math) into a
shared library of its own with a plain C interface, and :func:`load` opens
it with ``ctypes`` the first time it is asked for; :func:`load_all` builds
every source at once, in parallel.  A library goes to ``_build/<hash>/``
inside the package (git-ignored), the hash taken over the flags, the source
and the headers it reaches through ``#include "..."``, so a checkout builds
from its own sources (nothing is downloaded or prebuilt) and a header's edit
rebuilds only the libraries that include it.  :func:`build_host` compiles a
host source with the system C++ compiler under the same hash rule: a
kernel's host twin for the CPU tests, and the C++ QP oracle
(``oracle/cpp.py``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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

_P, _I, _F, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double,
                      ctypes.c_longlong)
# Every C entry point of csrc/, with its argument types; each library binds
# the ones it exports.  Pointers and the stream are c_void_p, ints c_int.
SIGNATURES = {
    "qp_oracle_solve": ([_I] + [_P] * 3 + [_D] * 2 + [_I, _D] + [_P] * 2, _I),
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
    "condense_launch": ([_P] * 9 + [_I] * 2 + [_P], _I),
    "condense_max_horizon": ([], _I),
    "condense_occupancy": ([_I, _P], _I),
    "stamp_launch": ([_P, _I, _P, _I, _P, _I, _I, _I, _P], _I),
    "srb_observe_launch": ([_P] * 3 + [_F, _L, _P], _I),
    "ctrl_pre_launch": ([_P] * 11 + [_I] * 3 + [_L, _P], _I),
    "ctrl_post_launch": ([_P] * 9 + [_I] * 2 + [_L, _P], _I),
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


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _headers(src: Path) -> list[Path]:
    """The headers in ``csrc/`` that ``src`` reaches through
    ``#include "..."``, directly or through other headers."""
    seen, todo = set(), [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            h = CSRC / name
            if h.is_file() and h not in seen:
                seen.add(h)
                todo.append(h)
    return sorted(seen)


def _digest(src: Path, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in [src, *_headers(src)]:
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


@functools.cache
def load(name: str) -> Library:
    """The loaded library of ``csrc/<name>.cu``, built first if its hash
    directory lacks it (once a process)."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / _digest(src, NVCC_FLAGS) / f"lib{name}.so"
    seconds, log = _compile([_nvcc()], NVCC_FLAGS, [src], out)
    return Library(_bind(ctypes.CDLL(str(out))), out, seconds, log)


def load_all() -> dict[str, Library]:
    """:func:`load` of every ``csrc/*.cu``, all started together; keys are
    the source stems."""
    names = [src.stem for src in sorted(CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))


def build_host(source: str, out_dir: Path) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` with the host C++ compiler into ``out_dir``
    and bind it like the CUDA libraries."""
    src = CSRC / source
    out = Path(out_dir) / f"{src.stem}_{_digest(src, HOST_FLAGS)}.so"
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    _compile([cxx], HOST_FLAGS, [src], out)
    return _bind(ctypes.CDLL(str(out)))

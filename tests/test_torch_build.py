"""How the port's kernel libraries are built (``_build.py``), on the CPU:
each library's hash covers its source and the headers the source includes,
directly or through other headers, and no other; ``load`` builds the one
library it is asked for, once a process; ``load_all`` builds each source
once and returns what ``load`` returns; and ``build_host`` hashes a source
outside ``csrc/`` on the project header it includes.  nvcc is never run: a
recording stub stands in for the compiler and for ``ctypes.CDLL``; the host
build runs g++."""
import ctypes

import pytest

from pympc_quadruped_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary ``csrc/`` and ``_build/``, and ``load``'s cache cleared
    before and after."""
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.load.cache_clear()
    yield src
    _build.load.cache_clear()


@pytest.fixture
def compiled(monkeypatch):
    """The sources each stubbed compile was given, in order."""
    calls = []

    def compile_(cmd_head, flags, sources, out):
        calls.append([s.name for s in sources])
        return 1.0, "ptxas log"

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: type("Stub", (), {"path": path})())
    return calls


@pytest.mark.parametrize("edited,rebuilds", [("direct.cuh", True), ("nested.cuh", True),
                                             ("unrelated.cuh", False)])
def test_digest_follows_the_included_headers(csrc, edited, rebuilds):
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "direct.cuh"\n')
    (csrc / "direct.cuh").write_text('#pragma once\n  #  include "nested.cuh"\n')
    (csrc / "nested.cuh").write_text("#pragma once\nint nested;\n")
    (csrc / "unrelated.cuh").write_text("#pragma once\nint unrelated;\n")
    before = _build._digest(csrc / "k.cu", _build.NVCC_FLAGS)
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (_build._digest(csrc / "k.cu", _build.NVCC_FLAGS) != before) == rebuilds


@pytest.mark.parametrize("source,headers", [
    ("admm.cu", ["admm.cuh"]), ("admm_iterate.cu", ["admm.cuh"]),
    ("admm_fused.cu", ["admm.cuh"]), ("condense.cu", ["condense.cuh"]),
    ("riccati_admm.cu", ["riccati_admm.cuh"]), ("stamp.cu", []), ("qp_oracle.cc", []),
    ("ctrl_tick.cu", ["ctrl_tick.cuh"]), ("ctrl_tick_host.cpp", ["ctrl_tick.cuh"]),
])
def test_each_library_hashes_only_its_own_headers(source, headers):
    assert [h.name for h in _build._headers(_build.CSRC / source)] == headers


def test_load_builds_the_one_library_asked_for_once(csrc, compiled):
    for name in ("x", "y"):
        (csrc / f"{name}.cu").write_text(f"int {name};\n")
    lib = _build.load("x")
    assert compiled == [["x.cu"]]
    assert lib.path == (_build.BUILD_DIR / _build._digest(csrc / "x.cu", _build.NVCC_FLAGS)
                        / "libx.so")
    assert lib.lib.path == str(lib.path) and (lib.build_seconds, lib.log) == (1.0, "ptxas log")
    assert _build.load("x") is lib and compiled == [["x.cu"]]


def test_load_all_builds_each_source_once_and_returns_the_loads(csrc, compiled):
    for name in ("x", "y", "z"):
        (csrc / f"{name}.cu").write_text(f"int {name};\n")
    (csrc / "z.cuh").write_text("int header;\n")
    x = _build.load("x")
    libs = _build.load_all()
    assert sorted(map(tuple, compiled)) == [("x.cu",), ("y.cu",), ("z.cu",)]
    assert list(libs) == ["x", "y", "z"] and libs["x"] is x
    assert all(libs[name] is _build.load(name) for name in libs)
    assert _build.load_all() == libs and len(compiled) == 3


def test_build_host_follows_the_project_header_a_test_source_includes(csrc, tmp_path):
    outside = tmp_path / "tests"
    outside.mkdir()
    (outside / "lanes.cpp").write_text('#include "k.cuh"\n'
                                       'extern "C" int lanes_value() { return VALUE; }\n')
    (csrc / "k.cuh").write_text("#define VALUE 1\n")
    (csrc / "other.cuh").write_text("#define OTHER 1\n")
    out = tmp_path / "host"

    def build():
        lib = _build.build_host(str(outside / "lanes.cpp"), out)
        return lib.lanes_value(), sorted(p.name for p in out.glob("*.so"))

    first, built = build()
    assert first == 1 and len(built) == 1
    (csrc / "other.cuh").write_text("#define OTHER 2\n")
    assert build() == (1, built)
    (csrc / "k.cuh").write_text("#define VALUE 2\n")
    second, rebuilt = build()
    assert second == 2 and len(rebuilt) == 2 and built[0] in rebuilt

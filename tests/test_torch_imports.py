"""The port's import boundary: ``pympc_quadruped_tpu_torch`` and
``chip_smoke.py`` run where JAX is not installed, so none of their modules
may import ``jax`` or the JAX package, directly or through another module.

A fresh interpreter with ``sys.modules["jax"]`` and
``sys.modules["pympc_quadruped_tpu"]`` set to ``None`` (any import of them
then raises ``ImportError``) imports every module of the port and
``chip_smoke``; among them the parity solvers' ``ops.qp.admm`` and
``ops.qp.ipm``, ``utils.profiling``, ``utils.viz`` and the examples.

The machine with the card has no MuJoCo, matplotlib, imageio or PIL
either: the modules that use them import them inside the functions that
do.  A second interpreter with those four made unimportable imports every
module and ``chip_smoke``, and runs the single-robot controller adapter
and the batch recorder on the CPU.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["pympc_quadruped_tpu"] = None
import importlib, pkgutil
import pympc_quadruped_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "jaxlib", "pympc_quadruped_tpu")))
assert not leaked, leaked
for name in ("ops.qp.admm", "ops.qp.ipm", "utils.profiling", "utils.viz",
             "examples.mujoco_closed_loop", "examples.visualize", "examples.batch_viz"):
    assert port.__name__ + "." + name in names, name
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    # Every .py file of the package but its own __init__ is one module.
    port_dir = os.path.join(REPO, "pympc_quadruped_tpu_torch")
    expected = sum(f.endswith(".py") for _, _, files in os.walk(port_dir) for f in files) - 1
    assert int(res.stdout.split()[-1]) == expected


NO_VIEWERS = """
import sys
for blocked in ("mujoco", "matplotlib", "imageio", "PIL"):
    sys.modules[blocked] = None
import importlib, pkgutil
import numpy as np
import torch
import pympc_quadruped_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from pympc_quadruped_tpu_torch.examples.batch_viz import record_batch
from pympc_quadruped_tpu_torch.examples.mujoco_closed_loop import make_torch_controller
torch.set_num_threads(1)
step = make_torch_controller(10, device="cpu")
obs = {"pos": [0.0, 0.0, 0.38], "vel": [0.0] * 3, "quat": [1.0, 0.0, 0.0, 0.0],
       "omega": [0.0] * 3, "q": [0.0, 0.8, -1.6] * 4, "qdot": [0.0] * 12}
torques, forces = step(obs, 0)
assert torques.shape == forces.shape == (12,) and np.isfinite(torques).all()
frames = record_batch(3, 0.08, 40, device="cpu")
assert len(frames) == 2 and frames[-1][2].shape == (3, 12)
print("ok")
"""


def test_adapter_and_recorder_run_without_mujoco_or_plotting():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", NO_VIEWERS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.split()[-1] == "ok"


PORT = os.path.join(REPO, "pympc_quadruped_tpu_torch")


def imported_modules(path: str) -> set:
    """The absolute names a source file imports (``from a import b`` as
    ``a.b``, ``from . import x`` as the package's own ``x``)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    pkg = "pympc_quadruped_tpu_torch." + os.path.relpath(os.path.dirname(path), PORT).replace(
        os.sep, ".")
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.rsplit(".", node.level - 1)[0] if node.level > 1 else pkg
                mod = f"{base}.{node.module}" if node.module else base
                names.update(f"{mod}.{a.name}" for a in node.names)
            else:
                names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_oracle_imports_only_torch_numpy_and_build():
    """The golden model shares no code with the compute path it judges."""
    allowed = ("torch", "numpy", "pympc_quadruped_tpu_torch._build",
               "pympc_quadruped_tpu_torch.oracle")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(PORT, "oracle"))
                   for f in fs if f.endswith(".py"))
    assert {os.path.basename(f) for f in files} == {"__init__.py", "npref.py", "cpp.py"}
    for path in files:
        for name in imported_modules(path):
            top = name.split(".")[0]
            ok = top in sys.stdlib_module_names or top == "__future__" or any(
                name == a or name.startswith(a + ".") for a in allowed)
            assert ok, (path, name)


def test_compute_path_does_not_import_the_oracle():
    for sub in ("ops", "control", "env", "estimation", "parallel"):
        for d, _, fs in os.walk(os.path.join(PORT, sub)):
            for f in fs:
                if f.endswith(".py"):
                    path = os.path.join(d, f)
                    bad = [n for n in imported_modules(path)
                           if n.startswith("pympc_quadruped_tpu_torch.oracle") or ".oracle" in n]
                    assert not bad, (path, bad)


@pytest.mark.parametrize("module,forbidden", [
    ("_build.py", ("pympc_quadruped_tpu_torch",)),
    ("utils/profiling.py", ("pympc_quadruped_tpu_torch.env", "pympc_quadruped_tpu_torch.ops")),
])
def test_lower_layers_import_nothing_above_them(module, forbidden):
    """``_build.py`` loads alone by file path (the sweep's prebuild), and the
    tracing module sits below the loop and the solvers it traces."""
    bad = [n for n in imported_modules(os.path.join(PORT, module))
           if any(n == f or n.startswith(f + ".") for f in forbidden)]
    assert not bad, (module, bad)

"""The port's import boundary: ``pympc_quadruped_tpu_torch`` and
``chip_smoke.py`` run where JAX is not installed, so none of their modules
may import ``jax`` or the JAX package, directly or through another module.

A fresh interpreter with ``sys.modules["jax"]`` and
``sys.modules["pympc_quadruped_tpu"]`` set to ``None`` (any import of them
then raises ``ImportError``) imports every module of the port and
``chip_smoke``; among them the parity solvers' ``ops.qp.admm`` and
``ops.qp.ipm`` and ``utils.profiling``.
"""
import os
import subprocess
import sys

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
for name in ("ops.qp.admm", "ops.qp.ipm", "utils.profiling"):
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

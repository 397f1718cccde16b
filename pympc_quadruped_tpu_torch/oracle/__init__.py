"""Float64 golden implementation of the reference semantics, in PyTorch
(port of the JAX package's ``oracle/``).

It imports ``torch``, ``numpy`` and the package's ``_build`` only, and no
module of the compute path imports it: it is the independent yardstick
the tests, ``chip_smoke.py`` and the MuJoCo example's oracle controller
hold the port against.
"""

from pympc_quadruped_tpu_torch.oracle.npref import (
    OracleConfig,
    OracleController,
    OracleRobot,
    oracle_aliengo,
    oracle_a1,
    solve_qp_kkt,
)

__all__ = [
    "OracleConfig",
    "OracleController",
    "OracleRobot",
    "oracle_aliengo",
    "oracle_a1",
    "solve_qp_kkt",
]

"""pympc_quadruped_tpu_torch — the PyTorch + CUDA port of ``pympc_quadruped_tpu``.

Same module tree, names, parameter values, carries and batch-leading
layouts as the JAX package, which stays in the repository as the reference
the port is tested against (``tests/test_torch_*.py``).  This package
imports ``torch`` and numpy only, never JAX.

PyTorch idiom in place of the JAX one:

- flax ``struct`` pytrees are plain ``@dataclass``es of tensors
  (``dataclasses.replace`` for ``.replace``); :mod:`.tree` maps over them;
- ``vmap`` is an explicit leading scenario axis, ``lax.scan`` a Python loop;
- the 50 Hz solve gate is a host ``if`` on the shared Python-int tick;
- every function takes its device from its inputs, and every constructor
  (``aliengo()``, ``Gaits.*``, ``default_mpc_params()``, ``init_carry()``,
  the ``convert`` builders) builds on the card unless given ``device="cpu"``.

The closed-loop entry points are :func:`.env.srb_env.rollout` (the trunk
as one rigid body forced by the MPC's ground-reaction forces) and
:func:`.env.fullorder.rollout` (the 18-DoF articulated tree of
:mod:`.ops.rbd` driven by the controller's joint torques, with penalty
foot contact).  On the card each replays its non-solve tick from one
captured CUDA graph (:mod:`.env.graph_loop`) and runs the solve tick
eagerly.

The hand-written CUDA kernels are the counterparts of the JAX package's
Pallas kernels: the Riccati-ADMM solve (``csrc/riccati_admm.cu``, wrapper
:mod:`.ops.qp.riccati_cuda`) and the four condensed-ADMM kernels
(``csrc/admm.cu``, wrapper :mod:`.ops.qp.admm_cuda`).
"""

__version__ = "0.1.0"

import torch as _torch

# Control-grade matmul precision, package-wide: the counterpart of the JAX
# package's ``jax_default_matmul_precision="highest"`` pin.  On Hopper, TF32
# (f32 operands rounded to a 10-bit mantissa) plays the part the bf16 pass
# played on the TPU: fine for neural nets, a correctness bug for physics,
# kinematics and QP data.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from pympc_quadruped_tpu_torch.models.robots import RobotParams, aliengo, a1  # noqa: E402
from pympc_quadruped_tpu_torch.models.gaits import GaitParams, Gaits  # noqa: E402
from pympc_quadruped_tpu_torch.models.mpc import MpcParams, default_mpc_params  # noqa: E402

__all__ = [
    "RobotParams",
    "aliengo",
    "a1",
    "GaitParams",
    "Gaits",
    "MpcParams",
    "default_mpc_params",
]

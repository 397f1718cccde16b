from pympc_quadruped_tpu_torch.models.robots import RobotParams, aliengo, a1
from pympc_quadruped_tpu_torch.models.gaits import GaitParams, Gaits
from pympc_quadruped_tpu_torch.models.mpc import MpcParams, default_mpc_params
from pympc_quadruped_tpu_torch.models.command import Command

__all__ = [
    "RobotParams",
    "aliengo",
    "a1",
    "GaitParams",
    "Gaits",
    "MpcParams",
    "default_mpc_params",
    "Command",
]

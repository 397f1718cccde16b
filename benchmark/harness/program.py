"""The system under test: the port's closed loop, built from a
configuration file and the traffic's draws.

Everything the port is given here comes from the benchmark's own files
and the seed: the robot's parameters, the MPC's, the gait tables, the
commands and the initial states' jitter.  What the port derives from them
(its initial stance, its models, its QPs) is the port's; the reference
works it out again.  Besides the loop this module reads the port's state
and carry as flat dicts of rows (:func:`snapshot`) and records the inputs
of the solve that the solve tick hands the kernels (:class:`SolveProbe`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: The loop's warm-started solver presets, named as the port names them.
SOLVER_CFG_KEY = {"admm_fast": "admm_fast_cfg", "riccati": "riccati_cfg"}


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def robot_rows(cfg: dict, draws: dict) -> dict:
    """Per-row robot parameters as numpy arrays (the sweep's mass and
    inertia factors applied)."""
    r = cfg["robot"]
    B = len(draws["vx"])
    rows = {k: np.broadcast_to(np.asarray(v, np.float64), (B,) + np.shape(v)).copy()
            for k, v in r.items()}
    rows["mass"] = rows["mass"] * draws["mass_f"].astype(np.float64)
    rows["inertia"] = rows["inertia"] * draws["inertia_f"].astype(np.float64)[:, None, None]
    return rows


def objects(cfg: dict, draws: dict, device):
    """The port's (robot, mpc, gait, cmd, solver_cfg) of the drawn rows."""
    from pympc_quadruped_tpu_torch.models.command import Command
    from pympc_quadruped_tpu_torch.models.gaits import GaitParams
    from pympc_quadruped_tpu_torch.models.mpc import MpcParams
    from pympc_quadruped_tpu_torch.models.robots import RobotParams
    from pympc_quadruped_tpu_torch.ops.qp import admm_fast, riccati

    f32 = lambda v: _t(v, device)
    rows = robot_rows(cfg, draws)
    robot = RobotParams(**{k: f32(v.astype(np.float32)) for k, v in rows.items()})
    m = cfg["mpc"]
    mpc = MpcParams(horizon=m["horizon"], iterations_between_mpc=m["iterations_between_mpc"],
                    **{k: f32(m[k]) for k in ("dt_control", "dt_predict", "gravity",
                                              "friction_coef", "q_diag", "r_diag",
                                              "max_pos_error", "comp_saturation")})
    i32 = lambda v: _t(v, device, torch.int32)
    gait = GaitParams(num_segments=i32(draws["num_segments"]),
                      stance_offsets=i32(draws["stance_offsets"]),
                      stance_durations=i32(draws["stance_durations"]))
    vx = f32(draws["vx"])
    zero = torch.zeros_like(vx)
    cmd = Command(vel_base_des=torch.stack([vx, zero, zero], -1), yaw_turn_rate=zero)
    preset = {"admm_fast": admm_fast.AdmmFastConfig,
              "riccati": riccati.RiccatiConfig}[cfg["solver"]].inloop()
    solver_cfg = {SOLVER_CFG_KEY[cfg["solver"]]: preset._replace(**cfg["solver_cfg"])}
    return robot, mpc, gait, cmd, solver_cfg


def build(cfg: dict, mix: dict, draws: dict, num_ticks: int, device):
    """The port's ``RolloutLoop`` of these robots over ``num_ticks`` ticks."""
    from pympc_quadruped_tpu_torch.env import fullorder, mjcf, srb_env

    f32 = lambda v: _t(v, device)
    robot, mpc, gait, cmd, solver_cfg = objects(cfg, draws, device)
    solver = cfg["solver"]
    auto_reset = mix["auto_reset"]
    if cfg["plant"] == "srb":
        s0 = srb_env.default_init_state(robot)
        s0 = dataclasses.replace(s0, pos=s0.pos + f32(draws["dpos"]),
                                 vel=s0.vel + f32(draws["dvel"]))
        return srb_env.RolloutLoop(robot, mpc, gait, cmd, num_ticks, init_state=s0,
                                   solver=solver, auto_reset=auto_reset, solver_cfg=solver_cfg)
    L = cfg["links"]
    link = lambda e: mjcf.LinkInertial(e["mass"], tuple(e["com"]), tuple(e["diag"]))
    spec = mjcf.MjcfSpec(
        name=cfg["name"], trunk_inertial=link(L["trunk"]), hip=link(L["hip"]),
        thigh=link(L["thigh"]), calf=link(L["calf"]), trunk_box=tuple(L["trunk_box"]),
        hip_range=tuple(L["hip_range"]),
        thigh_range=None if L["thigh_range"] is None else tuple(L["thigh_range"]),
        calf_range=tuple(L["calf_range"]), foot_radius=L["foot_radius"],
        joint_damping=L["joint_damping"], joint_armature=L["joint_armature"])
    cp = fullorder.ContactParams(**{k: f32(v) for k, v in cfg["contact"].items()})
    s0 = fullorder.default_init_state(robot, cp.foot_radius)
    s0 = dataclasses.replace(s0, pos=s0.pos + f32(draws["dpos"]), q=s0.q + f32(draws["dq"]),
                             u=s0.u + f32(draws["du"]))
    return fullorder.RolloutLoop(robot, mpc, gait, cmd, num_ticks, cp=cp, state0=s0,
                                 spec=spec, solver=solver, auto_reset=auto_reset,
                                 solver_cfg=solver_cfg)


def flat(tree, prefix: str = "") -> dict:
    """A dataclass tree's tensor leaves by dotted field path."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flat(getattr(tree, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: tree}


def snapshot(loop, rows: torch.Tensor) -> dict:
    """Copies of the loop's state and carry at ``rows``, enqueued on the
    card's stream (no host read): {"state": {...}, "carry": {...}}."""
    take = lambda d: {k: v.index_select(0, rows) for k, v in d.items()}
    return {"state": take(flat(loop.buf.state)), "carry": take(flat(loop.buf.carry))}


class SolveProbe:
    """Records, when armed, the rows ``rows`` of the operands that the solve
    tick hands its solver: the masked condensed (H, g) of ``admm_fast``, or
    the prediction model (Ad, Bd) of ``riccati``.  It wraps the solver's
    entry in the port's module, the name the controller calls."""

    ARGS = {"admm_fast": ("H", "g"), "riccati": ("Ad", "Bd")}

    def __init__(self, solver: str, rows: torch.Tensor):
        from pympc_quadruped_tpu_torch.ops.qp import admm_fast, riccati

        self.module = {"admm_fast": admm_fast, "riccati": riccati}[solver]
        self.names = self.ARGS[solver]
        self.rows = rows
        self.armed = False
        self.record = None
        self.calls = 0
        self._inner = self.module.solve_batch
        self.module.solve_batch = self._wrapped

    def _wrapped(self, *args, **kwargs):
        self.calls += 1
        if self.armed:
            self.record = {n: a.index_select(0, self.rows) for n, a in zip(self.names, args)}
        return self._inner(*args, **kwargs)

    def take(self):
        out, self.record = self.record, None
        return out

    def close(self):
        self.module.solve_batch = self._inner

"""Closed-loop Aliengo trot in MuJoCo 3, driven by the port's controller
(port of ``examples/mujoco_closed_loop.py``).

The counterpart of the reference's primary entry point (ref
``scripts/mujoco_aliengo.py:157-240``), headless: the MuJoCo model
generated from the robot's parameters (:mod:`..env.mjcf`), the nominal
stance reset (q = (0, 0.8, -1.6) x 4 at the desired height, ref :32-39), a
ground-truth state feed (ref :59-99) or IMU and encoders through the
Kalman filter, and TROTTING10 at v_x = 1.2 m/s (ref :176-180).  The
controller (``--device cpu`` on a machine without a card) is either

- ``--controller torch`` (the default): ``controller.step_batch`` at B=1
  on the card, the port's compute path; or
- ``--controller oracle``: the float64 golden controller
  (:mod:`..oracle.npref`), which shares no code with that path (the JAX
  example's default).

    python -m pympc_quadruped_tpu_torch.examples.mujoco_closed_loop --seconds 5
    python -m pympc_quadruped_tpu_torch.examples.mujoco_closed_loop --controller oracle \\
        --device cpu --seconds 5
    python -m pympc_quadruped_tpu_torch.examples.mujoco_closed_loop --device cpu \\
        --gait-plan trotting16:1200,jumping16:2480,trotting16 --horizon 16 --vx 0.4

``--record trace.npz`` writes the JAX example's keys (``forces``,
``torques``, ``obs_*``), so either side's ``viz.animate_trot`` reads either
trace.  MuJoCo and the image libraries are imported inside the functions
that use them: the controller adapter runs where they are not installed.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

#: Keys of the controller's observation dict, in kin.RobotObs order.
OBS_KEYS = ("pos", "vel", "quat", "omega", "q", "qdot")
NOMINAL_Q = (0.0, 0.8, -1.6)


def import_mujoco():
    """The ``mujoco`` module.  Its bindings pick the GL backend when first
    imported: EGL unless ``MUJOCO_GL`` says otherwise, which renders
    headless (``--render``) and is harmless otherwise."""
    os.environ.setdefault("MUJOCO_GL", "egl")
    import mujoco

    return mujoco


def reset_nominal(model, data, height):
    mujoco = import_mujoco()
    mujoco.mj_resetData(model, data)
    data.qpos[:3] = [0.0, 0.0, height]
    data.qpos[3:7] = [1.0, 0.0, 0.0, 0.0]
    data.qpos[7:] = np.tile(NOMINAL_Q, 4)
    data.qvel[:] = 0.0
    mujoco.mj_forward(model, data)


def read_obs(model, data):
    """Ground-truth observation, as the reference feeds it (ref :59-99):
    world base position and velocity, sensor quaternion, body-frame gyro,
    joint positions and velocities."""
    mujoco = import_mujoco()
    trunk = model.body("trunk").id
    vel6 = np.zeros(6)
    mujoco.mj_objectVelocity(model, data, mujoco.mjtObj.mjOBJ_BODY, trunk, vel6, 0)
    return {
        "pos": data.xpos[trunk].copy(),
        "vel": vel6[3:6].copy(),
        "quat": data.sensordata[0:4].copy(),
        "omega": data.sensordata[4:7].copy(),
        "q": data.sensordata[10:22].copy(),
        "qdot": data.sensordata[22:34].copy(),
    }


def read_raw_sensors(data):
    """IMU and encoders only, the reference's realistic input mode (ref
    ``get_simulated_sensor_data``, scripts/mujoco_aliengo.py:101-118):
    framequat, gyro, accelerometer, 12 jointpos, 12 jointvel, 4 touch."""
    return {
        "quat": data.sensordata[0:4].copy(),
        "gyro": data.sensordata[4:7].copy(),
        "accel": data.sensordata[7:10].copy(),
        "q": data.sensordata[10:22].copy(),
        "qdot": data.sensordata[22:34].copy(),
        "touch": data.sensordata[34:38].copy(),
    }


def _robot(name: str, device):
    from pympc_quadruped_tpu_torch.models import a1, aliengo

    return aliengo(device=device) if name == "aliengo" else a1(device=device)


def _host_rows(device, *arrays) -> list:
    """Host arrays as float32 (1, n) tensors on ``device``, in one copy."""
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays])
    t = torch.from_numpy(flat).to(device)[None]
    return list(torch.split(t, [int(np.size(a)) for a in arrays], dim=-1))


def make_kf_estimator(robot_name, init_pos, device="cuda"):
    """The two-stage filter (:mod:`..estimation.kf`) fed by raw sensors, at
    B=1 on ``device``: returns ``estimate(raw, tick)`` -> the controller's
    observation dict.  The foot-fixed measurements are gated by measured
    contact (the MJCF's touch sensors), not by the gait plan: a planned
    stance foot that is airborne would anchor the velocity to a moving
    foot."""
    from pympc_quadruped_tpu_torch import tree
    from pympc_quadruped_tpu_torch.estimation import kf
    from pympc_quadruped_tpu_torch.ops import kin

    robot = tree.tile(_robot(robot_name, device), 1)
    # MuJoCo's feet are spheres: a stance foot's centre rests one radius
    # above the ground (-touchdown_z).
    prm = dataclasses.replace(kf.KfParams.default(device=device),
                              contact_height=-robot.touchdown_z[0])
    q0 = torch.tensor(NOMINAL_Q, dtype=torch.float32, device=device).repeat(4, 1)[None]
    p_bf, _ = kin.leg_forward_kinematics(robot, q0)
    (pos0,) = _host_rows(device, init_pos)
    state = {"kf": kf.KfState.init(pos0, pos0[:, None, :] + p_bf)}

    def estimate(raw, tick):
        contact = (np.asarray(raw["touch"]) > 0.5).astype(np.float32)
        gyro, accel, qj, qdj, touch = _host_rows(
            device, raw["gyro"], raw["accel"], raw["q"], raw["qdot"], contact)
        st = kf.update(state["kf"], robot, gyro, accel, qj, qdj, touch, prm)
        state["kf"] = st
        est = torch.cat([st.x[0, 0:6], st.quat[0]]).double().cpu().numpy()
        return {"pos": est[0:3], "vel": est[3:6], "quat": est[6:10],
                "omega": raw["gyro"], "q": raw["q"], "qdot": raw["qdot"]}

    return estimate


def make_torch_controller(horizon, robot_name="aliengo", vx=1.2, yaw_rate=0.0,
                          gait_name="trotting10", gait_plan=None, device="cuda"):
    """The port's controller at B=1 on ``device`` (``controller.step_batch``
    with the default solver): returns ``step(obs, tick)`` -> (torques (12,),
    forces (12,)) as host float32 arrays.

    ``gait_plan`` = [(gait_name, until_tick), ...] switches gaits live:
    every gait of the plan is built once, and the tick picks which one the
    step reads, so the whole controller carry crosses a switch, as in the
    JAX example's traced gait argument."""
    from pympc_quadruped_tpu_torch import tree
    from pympc_quadruped_tpu_torch.control import controller as ctl
    from pympc_quadruped_tpu_torch.models import Command, Gaits, default_mpc_params
    from pympc_quadruped_tpu_torch.ops import kin

    mpc = default_mpc_params(horizon, device=device)
    robot = tree.tile(_robot(robot_name, device), 1)
    command = dataclasses.replace(
        Command.trot_forward(vx, device=device),
        yaw_turn_rate=torch.tensor(yaw_rate, dtype=torch.float32, device=device))
    cmd = tree.tile(command, 1)
    if gait_plan is None:
        gait_plan = [(gait_name, None)]
    plan_gaits = [tree.tile(Gaits.by_name(g, device=device), 1) for g, _ in gait_plan]
    plan_until = [u for _, u in gait_plan]
    state = {"carry": tree.tile(ctl.init_carry(mpc.horizon, device=device), 1)}

    def gait_at(tick):
        for g, until in zip(plan_gaits, plan_until):
            if until is None or tick < until:
                return g
        return plan_gaits[-1]

    def step(obs, tick):
        o = kin.RobotObs(*_host_rows(device, *(obs[k] for k in OBS_KEYS)))
        state["carry"], out = ctl.step_batch(robot, mpc, gait_at(tick), cmd, state["carry"],
                                             o, tick)
        res = torch.cat([out.torques[0], out.contact_forces[0]]).cpu().numpy()
        return res[:12], res[12:]

    return step


def make_oracle_controller(horizon, robot_name="aliengo", vx=1.2, yaw_rate=0.0,
                           gait_name="trotting10", device="cuda"):
    """The float64 golden controller (``oracle.npref.OracleController``) on
    ``device``: returns ``step(obs, tick)`` -> (torques (12,), forces (12,))
    as host float64 arrays."""
    from pympc_quadruped_tpu_torch.oracle import npref

    robot = npref.oracle_aliengo(device) if robot_name == "aliengo" else npref.oracle_a1(device)
    ctrl = npref.OracleController(robot, npref.OracleConfig(horizon=horizon, device=device),
                                  npref.OracleGait.by_name(gait_name, device))

    def step(obs, tick):
        out = ctrl.step(obs, [vx, 0.0, 0.0], yaw_rate, tick)
        res = torch.cat([out["torques"], out["forces"]]).cpu().numpy()
        return res[:12], res[12:]

    return step


def check_gait_plan(gait_plan, horizon):
    """The flight-aware reference trajectory is exact only when the horizon
    covers the gait period: a phased gait with more segments than the
    horizon would have its planned-gait table truncated."""
    from pympc_quadruped_tpu_torch.models import Gaits

    for name, _ in gait_plan:
        g = Gaits.by_name(name, device="cpu")
        segs = int(g.num_segments)
        # All-stance gaits (standing) truncate exactly.
        all_stance = bool((g.stance_durations >= segs).all())
        if segs > horizon and not all_stance:
            raise ValueError(
                f"--gait-plan gait '{name}' has {segs} segments but --horizon is "
                f"{horizon}; the planned-gait table would be truncated (use --horizon {segs})"
            )


def run(controller="torch", seconds=5.0, horizon=10, record=None, verbose=True,
        robot="aliengo", vx=None, xml=None, sensors="truth", yaw_rate=0.0,
        render=None, render_fps=30, gait="trotting10", view=False,
        gait_plan=None, warmup_ticks=0, device="cuda"):
    """Run the closed loop for ``seconds`` and return the result dict
    (``completed``, ``final_x``, ``final_y``, ``final_yaw``,
    ``mean_vx_last_2s``, ``mean_height_last_2s``, ``wall_s``, ``sim_s``).

    ``render``: path of an offscreen-rendered GIF (``mujoco.Renderer`` with
    a trunk-tracking camera; needs a headless GL backend such as EGL).
    ``view``: a live window (``mujoco.viewer.launch_passive``; needs a
    display).  ``warmup_ticks``: a fresh controller first stands (the
    STANDING gait at zero command) for that many ticks, the reference's
    unused ``initialize_robot`` (ref mujoco_aliengo.py:121-155)."""
    if controller not in ("torch", "oracle"):
        raise ValueError(f"unknown controller {controller!r}: 'torch' or 'oracle'")
    if gait_plan is not None and controller != "torch":
        raise ValueError("--gait-plan needs --controller torch")
    mujoco = import_mujoco()
    from pympc_quadruped_tpu_torch.env import mjcf

    if vx is None:
        # Reference commands: Aliengo at 1.2 (ref mujoco_aliengo.py:179),
        # A1 at 1.4 (ref isaacgym_a1.py:98).
        vx = 1.2 if robot == "aliengo" else 1.4
    if xml is not None:
        model = mujoco.MjModel.from_xml_path(xml)
    else:
        model = mujoco.MjModel.from_xml_string(mjcf.model_xml(robot))
    data = mujoco.MjData(model)
    height = 0.38 if robot == "aliengo" else 0.3
    reset_nominal(model, data, height)
    mujoco.mj_step(model, data)  # settle one step, like the reference (ref :167)

    if gait_plan is not None:
        check_gait_plan(gait_plan, horizon)
    if controller == "oracle":
        step_fn = make_oracle_controller(horizon, robot, vx, yaw_rate, gait, device=device)
    else:
        step_fn = make_torch_controller(horizon, robot, vx, yaw_rate, gait, gait_plan=gait_plan,
                                        device=device)
    trunk = model.body("trunk").id
    estimator = None
    if sensors == "raw":
        estimator = make_kf_estimator(robot, data.xpos[trunk], device=device)

    n_ticks = int(seconds * 1000)
    log = {"pos": [], "vel": [], "obs": [], "forces": [], "torques": []}
    renderer, frames, frame_every = None, [], max(1, 1000 // render_fps)
    if render is not None:
        renderer = mujoco.Renderer(model, 480, 640)
        cam = mujoco.MjvCamera()
        cam.type = mujoco.mjtCamera.mjCAMERA_TRACKING
        cam.trackbodyid = trunk
        cam.distance, cam.elevation, cam.azimuth = 1.6, -18.0, 120.0
    viewer = None
    if view:
        from mujoco import viewer as mj_viewer

        viewer = mj_viewer.launch_passive(model, data)
    if warmup_ticks:
        make = make_oracle_controller if controller == "oracle" else make_torch_controller
        warm_fn = make(horizon, robot, 0.0, 0.0, "standing", device=device)
        for tick in range(int(warmup_ticks)):
            torques, _ = warm_fn(read_obs(model, data), tick)
            data.ctrl[:] = torques
            mujoco.mj_step(model, data)
        if verbose:
            print(f"warm-up done ({warmup_ticks} standing ticks, height {data.qpos[2]:.3f})")
    t_start = time.time()
    for tick in range(n_ticks):
        if estimator is not None:
            obs = estimator(read_raw_sensors(data), tick)
            obs["true_pos"] = data.xpos[trunk].copy()
        else:
            obs = read_obs(model, data)
        torques, forces = step_fn(obs, tick)
        data.ctrl[:] = torques
        mujoco.mj_step(model, data)

        if record is not None:
            log["obs"].append(obs)
            log["forces"].append(forces.copy())
            log["torques"].append(torques.copy())
        if renderer is not None and tick % frame_every == 0:
            renderer.update_scene(data, camera=cam)
            frames.append(renderer.render().copy())
        if viewer is not None:
            if not viewer.is_running():
                if verbose:
                    print("viewer closed; stopping run")
                break
            viewer.sync()
        if tick % 1000 == 0 and verbose:
            print(f"t={tick / 1000:.1f}s pos=({data.qpos[0]:+.2f},{data.qpos[1]:+.2f},"
                  f"{data.qpos[2]:.3f}) vx={obs['vel'][0]:+.2f}")
        log["pos"].append(data.qpos[:3].copy())
        log["vel"].append(obs["vel"].copy())
        if data.qpos[2] < 0.12:
            if verbose:
                print(f"FELL at t={tick / 1000:.2f}s")
            break

    wall = time.time() - t_start
    if viewer is not None:
        viewer.close()
    if renderer is not None:
        renderer.close()
        write_gif(render, frames, render_fps, verbose)
    pos = np.array(log["pos"])
    vel = np.array(log["vel"])
    n = len(pos)
    qw, qx, qy, qz = data.qpos[3:7]
    final_yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    tail = slice(-2000, None) if n > 2000 else slice(None)
    result = {
        "completed": n == n_ticks,
        "final_x": float(pos[-1, 0]),
        "final_y": float(pos[-1, 1]),
        "final_yaw": float(final_yaw),
        "mean_vx_last_2s": float(vel[tail, 0].mean()),
        "mean_height_last_2s": float(pos[tail, 2].mean()),
        "wall_s": wall,
        "sim_s": n / 1000.0,
    }
    if verbose:
        print(result)
    if record is not None and n > 0:
        obs_arr = {k: np.stack([o[k] for o in log["obs"]]) for k in log["obs"][0]}
        np.savez_compressed(
            record,
            forces=np.stack(log["forces"]),
            torques=np.stack(log["torques"]),
            **{f"obs_{k}": v for k, v in obs_arr.items()},
        )
        if verbose:
            print(f"recorded {n} ticks -> {record}")
    return result


def write_gif(path, frames, fps, verbose=True):
    """RGB frames (H, W, 3) -> an endlessly looping GIF, through PIL."""
    if not frames:
        if verbose:
            print(f"no frames captured; skipping GIF write to {path}")
        return
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    if verbose:
        print(f"rendered {len(imgs)} frames -> {path}")


def parse_gait_plan(text):
    """'name:until_tick,name:until_tick,name' -> [(name, until or None), ...]."""
    plan = []
    for part in text.split(","):
        name, _, until = part.partition(":")
        plan.append((name, int(until) if until else None))
    return plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--controller", choices=["torch", "oracle"], default="torch",
                    help="torch: the port's controller (the default); oracle: the float64 "
                         "golden controller")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--record", default=None)
    ap.add_argument("--robot", choices=["aliengo", "a1"], default="aliengo")
    ap.add_argument("--vx", type=float, default=None)
    ap.add_argument("--yaw-rate", type=float, default=0.0, dest="yaw_rate")
    ap.add_argument("--xml", default=None, help="external MJCF instead of the generated one")
    ap.add_argument("--sensors", choices=["truth", "raw"], default="truth",
                    help="raw = IMU + encoders through the two-stage KF (no ground truth)")
    ap.add_argument("--render", default=None,
                    help="write an offscreen-rendered GIF of the run here")
    ap.add_argument("--gait-plan", default=None, dest="gait_plan",
                    help="live gait switching: 'name:until_tick,name:until_tick,name', "
                         "e.g. 'trotting16:1200,jumping16:2480,trotting16'")
    ap.add_argument("--view", action="store_true",
                    help="live window (mujoco.viewer.launch_passive; needs a display)")
    ap.add_argument("--warmup-ticks", type=int, default=0, dest="warmup_ticks",
                    help="standing-MPC ticks before walking (the reference's "
                         "initialize_robot uses 800)")
    ap.add_argument("--gait", default="trotting10",
                    help="any library gait: trotting10/16, pacing10/16, bounding8, "
                         "jumping16, standing")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    plan = parse_gait_plan(args.gait_plan) if args.gait_plan else None
    run(args.controller, args.seconds, args.horizon, args.record, robot=args.robot,
        vx=args.vx, xml=args.xml, sensors=args.sensors, yaw_rate=args.yaw_rate,
        render=args.render, gait=args.gait, view=args.view, gait_plan=plan,
        warmup_ticks=args.warmup_ticks, device=args.device)


if __name__ == "__main__":
    main()

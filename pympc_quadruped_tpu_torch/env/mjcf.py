"""Programmatic MJCF generation (port of ``env/mjcf.py``).

The MuJoCo model of each robot is generated from the same
:class:`~..models.robots.RobotParams` the controller reads, plus a
per-link inertial spec (:class:`MjcfSpec`); :func:`..env.fullorder.rbd_model`
reads the same spec, so the articulated dynamics, the controller's
kinematics and the MuJoCo model are one model.  The generator reads the
port's tensors on the host as Python floats and imports no MuJoCo: it
returns XML text, the same text as the JAX package's generator.

Layout (what ``examples/mujoco_closed_loop.py`` relies on): a free-joint
body ``trunk`` with an ``imu`` site; 12 hinge joints and 12 unit-gear
motors in FL, FR, RL, RR x (hip, thigh, calf) order; sensordata framequat
(0:4), gyro (4:7), accelerometer (7:10), 12 jointpos (10:22), 12 jointvel
(22:34), 4 touch (34:38).  :func:`build_mjcf_grid` writes a render-only
scene of ``n`` instances (``examples/batch_viz.py``).

Leg-link masses carry the reference MJCF's 10x lightening with the URDF
rotational inertias (ref ``aliengo.xml:57`` mass 0.1993 against
``aliengo.urdf`` FL_hip 1.993): light legs are what the massless-leg SRB
controller assumes.  The foot sphere's radius is ``-touchdown_z``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pympc_quadruped_tpu_torch.models.robots import LEG_NAMES, RobotParams, a1, aliengo


@dataclass(frozen=True)
class LinkInertial:
    mass: float
    com: tuple   # (3,) in the link frame
    diag: tuple  # (3,) diagonal inertia (principal, link axes)


@dataclass(frozen=True)
class MjcfSpec:
    """Everything the model generator needs beyond ``RobotParams``."""

    name: str
    trunk_inertial: LinkInertial
    hip: LinkInertial
    thigh: LinkInertial
    calf: LinkInertial          # includes the foot
    trunk_box: tuple            # (3,) half-sizes of the trunk collision box
    hip_range: tuple            # hinge limits [rad]
    thigh_range: tuple | None
    calf_range: tuple
    foot_radius: float
    joint_damping: float = 0.01
    joint_armature: float = 0.01
    friction: tuple = (1.0, 0.3, 0.3)
    timestep: float = 0.001


def aliengo_spec() -> MjcfSpec:
    """Aliengo inertials (ref aliengo.urdf link inertials, legs 10x lighter)."""
    return MjcfSpec(
        name="aliengo",
        trunk_inertial=LinkInertial(
            9.042, (0.008465, 0.004045, -0.000763), (0.033260, 0.161172, 0.174604)
        ),
        hip=LinkInertial(
            0.1993, (-0.022191, 0.015144, -1.5e-05), (0.002904, 0.004908, 0.005587)
        ),
        thigh=LinkInertial(
            0.0639, (-0.005607, -0.003877, -0.048199), (0.005667, 0.005847, 0.000370)
        ),
        calf=LinkInertial(
            0.0267, (0.002781, 6.3e-05, -0.164), (0.006341, 0.006355, 3.92e-05)
        ),
        trunk_box=(0.18, 0.075, 0.056),
        hip_range=(-1.2217, 1.2217),
        thigh_range=None,
        calf_range=(-2.7751, -0.6458),
        foot_radius=0.0255,
    )


def a1_spec() -> MjcfSpec:
    """A1 inertials (ref a1.urdf link inertials, legs 10x lighter)."""
    return MjcfSpec(
        name="a1",
        trunk_inertial=LinkInertial(
            4.713, (0.012731, 0.002186, 0.000515), (0.016840, 0.056579, 0.064714)
        ),
        hip=LinkInertial(
            0.0696, (-0.003311, 0.000635, 3.1e-05), (0.000469, 0.000807, 0.000553)
        ),
        thigh=LinkInertial(
            0.1013, (-0.003237, -0.022327, -0.027326), (0.005529, 0.005139, 0.001368)
        ),
        calf=LinkInertial(
            0.0166, (0.006435, 0.0, -0.110), (0.002998, 0.003014, 3.24e-05)
        ),
        trunk_box=(0.1335, 0.097, 0.057),
        hip_range=(-0.8029, 0.8029),
        thigh_range=(-1.0472, 4.1888),
        calf_range=(-2.6965, -0.9163),
        foot_radius=0.0255,
    )


_SPECS = {"aliengo": aliengo_spec, "a1": a1_spec}
_PARAMS = {"aliengo": aliengo, "a1": a1}


def _host(x) -> np.ndarray:
    """A tensor (on any device), an array or numbers, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fmt(vals) -> str:
    return " ".join(f"{float(v):.6g}" for v in np.atleast_1d(_host(vals)))


def _leg_xml(spec: MjcfSpec, robot: RobotParams, leg: int, prefix: str = "") -> str:
    """One leg subtree: hip -> thigh -> calf(+foot), FL/FR/RL/RR mirrored."""
    name = prefix + LEG_NAMES[leg]
    hip_pos = _host(robot.hip_offset)[leg]
    hip_len = float(_host(robot.hip_len)[leg])          # signed: +y left legs
    l_thigh = float(_host(robot.l_thigh))
    l_calf = float(_host(robot.l_calf))
    flip = hip_len < 0

    def inertial(link: LinkInertial) -> str:
        com = np.asarray(link.com, np.float64).copy()
        if flip:
            com[1] = -com[1]
        return (
            f'<inertial pos="{_fmt(com)}" mass="{link.mass:.6g}" '
            f'diaginertia="{_fmt(link.diag)}"/>'
        )

    hip_rng = _fmt(spec.hip_range)
    thigh_lim = (
        f' limited="true" range="{_fmt(spec.thigh_range)}"'
        if spec.thigh_range is not None
        else ""
    )
    calf_rng = _fmt(spec.calf_range)
    r = spec.foot_radius
    return f"""
      <body name="{name}_hip" pos="{_fmt(hip_pos)}">
        {inertial(spec.hip)}
        <joint name="{name}_hip_joint" axis="1 0 0" limited="true" range="{hip_rng}"/>
        <geom type="cylinder" size="0.046 0.02" pos="0 {hip_len:.6g} 0"
              quat="0.707107 0.707107 0 0" contype="0" conaffinity="0"/>
        <body name="{name}_thigh" pos="0 {hip_len:.6g} 0">
          {inertial(spec.thigh)}
          <joint name="{name}_thigh_joint" axis="0 1 0"{thigh_lim}/>
          <geom type="box" size="{l_thigh / 2:.6g} 0.017 0.02"
                pos="0 0 {-l_thigh / 2:.6g}" quat="0.707107 0 0.707107 0"/>
          <body name="{name}_calf" pos="0 0 {-l_thigh:.6g}">
            {inertial(spec.calf)}
            <joint name="{name}_calf_joint" axis="0 1 0" limited="true" range="{calf_rng}"/>
            <geom type="box" size="{l_calf / 2:.6g} 0.011 0.009"
                  pos="0 0 {-l_calf / 2:.6g}" quat="0.707107 0 0.707107 0"/>
            <geom name="{name.lower()}_foot" type="sphere" size="{r:.6g}"
                  pos="0 0 {-l_calf:.6g}"/>
            <site name="{name.lower()}_tc" type="sphere" size="{r + 0.001:.6g}"
                  pos="0 0 {-l_calf:.6g}"/>
          </body>
        </body>
      </body>"""


def _joint_lines(fmt: str) -> str:
    return "\n        ".join(fmt.format(n=n, j=j) for n in LEG_NAMES
                              for j in ("hip", "thigh", "calf"))


def build_mjcf(robot: RobotParams, spec: MjcfSpec) -> str:
    """Full MJCF document string for ``mujoco.MjModel.from_xml_string``."""
    legs = "".join(_leg_xml(spec, robot, leg) for leg in range(4))
    jp = _joint_lines('<jointpos name="{n}_{j}_pos" joint="{n}_{j}_joint"/>')
    jv = _joint_lines('<jointvel name="{n}_{j}_vel" joint="{n}_{j}_joint"/>')
    touch = "\n        ".join(
        f'<touch name="{n.lower()}_touch" site="{n.lower()}_tc"/>' for n in LEG_NAMES
    )
    motors = _joint_lines('<motor name="{n}_{j}" gear="1" joint="{n}_{j}_joint"/>')
    ti = spec.trunk_inertial
    h0 = float(_host(robot.base_height_des))
    return f"""<mujoco model="{spec.name}_generated">
  <compiler angle="radian"/>
  <option timestep="{spec.timestep:.6g}"/>
  <default>
    <joint damping="{spec.joint_damping:.6g}" armature="{spec.joint_armature:.6g}"/>
    <geom contype="1" conaffinity="1" friction="{_fmt(spec.friction)}"
          margin="0.001" rgba="0.5 0.6 0.7 1"/>
  </default>
  <worldbody>
    <light pos="0 0 3" dir="0 0 -1" directional="true"/>
    <geom name="floor" type="plane" size="0 0 1" condim="3" rgba="0.9 0.9 0.9 1"/>
    <camera name="track" mode="trackcom" pos="0 -2.3 1.6" xyaxes="1 0 0 0 0.707 0.707"/>
    <body name="trunk" pos="0 0 {h0 + 0.22:.6g}">
      <inertial pos="{_fmt(ti.com)}" mass="{ti.mass:.6g}" diaginertia="{_fmt(ti.diag)}"/>
      <joint type="free" armature="0" damping="0"/>
      <geom type="box" size="{_fmt(spec.trunk_box)}" rgba="0.2 0.2 0.2 1"/>
      <site name="imu" pos="0 0 0"/>
      {legs}
    </body>
  </worldbody>
  <actuator>
        {motors}
  </actuator>
  <sensor>
        <framequat name="Body_Quat" objtype="site" objname="imu"/>
        <gyro name="Body_Gyro" site="imu"/>
        <accelerometer name="Body_Acc" site="imu"/>
        {jp}
        {jv}
        {touch}
  </sensor>
</mujoco>
"""


def model_xml(name: str = "aliengo") -> str:
    """Generated MJCF for a named robot ("aliengo" or "a1")."""
    return build_mjcf(_PARAMS[name](device="cpu"), _SPECS[name]())


def write_model(path: str, name: str = "aliengo") -> str:
    xml = model_xml(name)
    with open(path, "w") as f:
        f.write(xml)
    return path


def build_mjcf_grid(robot: RobotParams, spec: MjcfSpec, n: int,
                    spacing: float = 1.2) -> str:
    """Render-only MJCF with ``n`` robot instances in a square grid: one
    free-joint + 12-joint body per instance (names prefixed ``r<i>_``), no
    actuators, sensors or contacts.  Recorded trajectories are replayed
    into it by writing each instance's qpos (``examples/batch_viz.py``)."""
    cols = int(math.ceil(math.sqrt(n)))
    h0 = float(_host(robot.base_height_des))
    ti = spec.trunk_inertial
    bodies = []
    for i in range(n):
        gx, gy = (i % cols) * spacing, (i // cols) * spacing
        legs = "".join(
            _leg_xml(spec, robot, leg, prefix=f"r{i}_") for leg in range(4)
        )
        bodies.append(f"""
    <body name="r{i}_trunk" pos="{gx:.6g} {gy:.6g} {h0:.6g}">
      <inertial pos="{_fmt(ti.com)}" mass="{ti.mass:.6g}" diaginertia="{_fmt(ti.diag)}"/>
      <joint type="free" armature="0" damping="0"/>
      <geom type="box" size="{_fmt(spec.trunk_box)}" rgba="0.2 0.2 0.2 1"/>
      {legs}
    </body>""")
    ext = (int(math.ceil(n / cols)) + 2) * spacing
    return f"""<mujoco model="{spec.name}_grid{n}">
  <compiler angle="radian"/>
  <option timestep="{spec.timestep:.6g}"/>
  <default>
    <joint damping="0" armature="0"/>
    <geom contype="0" conaffinity="0" friction="{_fmt(spec.friction)}"
          margin="0.001" rgba="0.5 0.6 0.7 1"/>
  </default>
  <worldbody>
    <light pos="{ext / 2:.6g} {ext / 2:.6g} 4" dir="0 0 -1" directional="true"/>
    <geom name="floor" type="plane" size="0 0 1" condim="3" rgba="0.9 0.9 0.9 1"/>
    <camera name="grid" pos="{ext * 0.55:.6g} {-ext * 0.7:.6g} {ext * 0.75:.6g}"
            xyaxes="0.8 0.6 0 -0.3 0.4 0.87"/>
    {''.join(bodies)}
  </worldbody>
</mujoco>
"""


def grid_model_xml(name: str, n: int, spacing: float = 1.2) -> str:
    """Generated render-only grid MJCF for a named robot."""
    return build_mjcf_grid(_PARAMS[name](device="cpu"), _SPECS[name](), n, spacing)

"""Per-link inertial specs of the generated robot models (port of the data
part of ``env/mjcf.py``).

The JAX module generates the MuJoCo model (MJCF) of each robot from its
``RobotParams`` plus the inertial spec below; :func:`..env.fullorder.rbd_model`
reads the same spec, so the articulated dynamics and the MuJoCo model are
one model.  Only the specs are ported: :class:`LinkInertial`,
:class:`MjcfSpec`, :func:`aliengo_spec` and :func:`a1_spec`.  The XML
generator (``build_mjcf``, ``model_xml`` and the terrain grids) is not: the
port runs no MuJoCo, and its tests build the MuJoCo model with the JAX
package's generator.

Leg-link masses carry the reference MJCF's 10x lightening with the URDF
rotational inertias (ref ``aliengo.xml:57`` mass 0.1993 against
``aliengo.urdf`` FL_hip 1.993): light legs are what the massless-leg SRB
controller assumes.
"""
from __future__ import annotations

from dataclasses import dataclass


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

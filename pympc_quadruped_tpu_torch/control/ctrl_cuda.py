"""Wrapper of the hand-written CUDA kernels of the controller's per-robot
tick (``csrc/ctrl_tick.cu``, arithmetic in ``csrc/ctrl_tick.cuh``).

=====================  ================  =======================================
entry                  kernel            plain counterpart (kept in its module)
=====================  ================  =======================================
:func:`srb_observe`    ``srb_observe``   ``env.srb_env.observe``
:func:`ctrl_pre`       ``ctrl_pre``      ``control.controller._pre_solve``
:func:`ctrl_post`      ``ctrl_post``     ``control.controller._post_solve``
=====================  ================  =======================================

None replaces a TPU kernel: the JAX package leaves this code to XLA's
fusion.  Each entry returns what its plain counterpart returns, to a few
float32 ulps (the kernels contract products and sums into FMAs).  The
callers launch them where :func:`engages` holds: every tensor on a CUDA
device and every floating-point one float32; otherwise (the CPU, float64)
they run the plain functions.  A launch that fails raises.

Operands have a leading scenario axis B (the MPC's shared 0-d tensors
aside).  Each row must be contiguous and rows may not overlap: a view of a
wider tensor's columns is read in place, an expanded view raises (a loop
makes its parameters contiguous once, when it is built).  Outputs are new
contiguous tensors.  The launch goes on the current stream, with no
synchronisation, and reads a tensor tick on the device, so it can be
captured in a CUDA graph.  ``lib`` launches another binding of the same C
launchers (the CPU tests pass the host build, ``csrc/ctrl_tick_host.cpp``).
:data:`LAUNCHES` counts the CUDA launches of each kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from pympc_quadruped_tpu_torch import _build
from pympc_quadruped_tpu_torch.control.refmpc import MpcCarry
from pympc_quadruped_tpu_torch.control.swing import SwingCarry
from pympc_quadruped_tpu_torch.ops import kin

#: CUDA launches of each kernel since import (or since a caller reset them).
LAUNCHES = {"srb_observe": 0, "ctrl_pre": 0, "ctrl_post": 0}


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _leaves(o)


def engages(*operands) -> bool:
    """Whether the kernels run for these operands (tensors, or dataclasses
    and tuples of them): every tensor on a CUDA device and every
    floating-point tensor float32."""
    for t in _leaves(operands):
        if not t.is_cuda or (t.is_floating_point() and t.dtype != torch.float32):
            return False
    return True


def _rows(name, t, B, shape, device, dtype=torch.float32):
    """(pointer, floats between rows) of a (B, *shape) operand whose rows
    are contiguous and do not overlap."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != (B,) + shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(B,) + shape}")
    width, expected = math.prod(shape), 1
    for size, stride in zip(reversed(shape), reversed(t.stride()[1:])):
        if size > 1 and stride != expected:
            raise ValueError(f"{name}: each row must be contiguous")
        expected *= size
    row = t.stride(0) if B > 1 else width
    if row < width:
        raise ValueError(f"{name}: rows overlap (stride {row} < {width}); an expanded "
                         "view must be made contiguous first")
    return t.data_ptr(), row


def _whole(name, t, B, shape, device, dtype):
    """Pointer of a contiguous (B, *shape) operand read by index."""
    ptr, row = _rows(name, t, B, shape, device, dtype)
    if B > 1 and row != math.prod(shape):
        raise ValueError(f"{name}: must be contiguous")
    return ptr


def _scalar(name, t, device):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.dim() != 0:
        raise TypeError(f"{name}: expected a 0-d float32 tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    return t.data_ptr()


def _library(device, lib):
    """(library, stream) to launch with."""
    if lib is not None:
        stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None
        return lib, stream
    if device.type != "cuda":
        raise ValueError(f"ctrl_cuda: the kernels run on a CUDA device, not {device}; "
                         "the plain functions serve the rest")
    return _build.load("ctrl_tick").lib, torch.cuda.current_stream(device).cuda_stream


def _run(device, name, fn, *args) -> None:
    """Call a C launcher; raise on a non-zero return and count the launch
    when it went to the card."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            rc = fn(*args)
    else:
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    if device.type == "cuda":
        LAUNCHES[name] += 1


def _fields(ins, B, device):
    """ctypes arrays of the float inputs' pointers and row strides."""
    ptrs, strides = zip(*(_rows(n, t, B, s, device) for n, t, s in ins))
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(strides))(*strides)


def _outputs(shapes, B, device):
    outs = [torch.empty((B,) + s, dtype=torch.float32, device=device) for s in shapes]
    return outs, (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))


def srb_observe(robot, state, lib=None) -> kin.RobotObs:
    """``env.srb_env.observe(robot, state)`` in one launch: q and qdot from
    the rigid-body state (``state``: an ``SrbState``); the other fields are
    the state's own tensors."""
    dev = state.pos.device
    B = state.pos.shape[0]
    lib, stream = _library(dev, lib)
    ins, strides = _fields([
        ("pos", state.pos, (3,)), ("quat", state.quat, (4,)), ("vel", state.vel, (3,)),
        ("omega_body", state.omega_body, (3,)), ("foot_pos", state.foot_pos, (4, 3)),
        ("foot_vel", state.foot_vel, (4, 3)), ("hip_offset", robot.hip_offset, (4, 3)),
        ("hip_len", robot.hip_len, (4,)), ("l_thigh", robot.l_thigh, ()),
        ("l_calf", robot.l_calf, ()),
    ], B, dev)
    (q, qdot), outs = _outputs([(12,), (12,)], B, dev)
    _run(dev, "srb_observe", lib.srb_observe_launch, ins, strides, outs,
         kin._COS_KNEE_MAX, B, stream)
    return kin.RobotObs(pos_base=state.pos, lin_vel_base=state.vel, quat_base=state.quat,
                        ang_vel_base=state.omega_body, q=q, qdot=qdot)


def _tick(tick, device):
    """(device pointer or None, host int) of a Python-int or 0-d int32 tick."""
    if isinstance(tick, torch.Tensor):
        if tick.dtype != torch.int32 or tick.dim() != 0:
            raise TypeError("tick: expected a 0-d int32 tensor or an int")
        if tick.device != device:
            raise ValueError(f"tick: on {tick.device}, expected {device}")
        return tick.data_ptr(), 0
    tick = int(tick)
    if not -2**31 <= tick < 2**31:
        raise ValueError(f"tick {tick} is outside int32")
    return None, tick


def _gait(gait, B, dev, offsets=True):
    i32 = torch.int32
    out = [_whole("num_segments", gait.num_segments, B, (), dev, i32)]
    if offsets:
        out.append(_whole("stance_offsets", gait.stance_offsets, B, (4,), dev, i32))
    out.append(_whole("stance_durations", gait.stance_durations, B, (4,), dev, i32))
    return out


def ctrl_pre(robot, mpc, gait, cmd, mpc_carry: MpcCarry, obs: kin.RobotObs, tick, lib=None):
    """``controller._pre_solve`` in one launch: returns (KinState,
    swing_states (B,4), gait table (B,4h), x_t (B,13), the MPC carry with
    ``integrate_desired``'s fields, vel_des_world (B,3)); the KinState's
    base position and velocities are the observation's own tensors."""
    dev = obs.q.device
    B, h = obs.q.shape[0], mpc.horizon
    lib, stream = _library(dev, lib)
    ins, strides = _fields([
        ("quat_base", obs.quat_base, (4,)), ("pos_base", obs.pos_base, (3,)),
        ("lin_vel_base", obs.lin_vel_base, (3,)), ("ang_vel_base", obs.ang_vel_base, (3,)),
        ("q", obs.q, (12,)), ("qdot", obs.qdot, (12,)),
        ("hip_offset", robot.hip_offset, (4, 3)), ("hip_len", robot.hip_len, (4,)),
        ("l_thigh", robot.l_thigh, ()), ("l_calf", robot.l_calf, ()),
        ("vel_base_des", cmd.vel_base_des, (3,)), ("yaw_turn_rate", cmd.yaw_turn_rate, ()),
        ("xpos_des", mpc_carry.xpos_des, ()), ("ypos_des", mpc_carry.ypos_des, ()),
    ], B, dev)
    outs, ptrs = _outputs([(3, 3), (3,), (4, 3), (4, 3), (4, 3), (4, 3), (4, 3), (4, 3, 3),
                           (4,), (4 * h,), (13,), (), (), (), (3,)], B, dev)
    R, rpy, p_bf, pw, feet, rel, thighs, J, swing_states, table, x_t, xpos, ypos, yaw, vdw = outs
    first = torch.empty((B,), dtype=torch.bool, device=dev)
    tick_dev, tick_host = _tick(tick, dev)
    _run(dev, "ctrl_pre", lib.ctrl_pre_launch, ins, strides, ptrs, *_gait(gait, B, dev),
         _whole("first_run", mpc_carry.first_run, B, (), dev, torch.bool), first.data_ptr(),
         _scalar("dt_control", mpc.dt_control, dev), _scalar("gravity", mpc.gravity, dev),
         tick_dev, tick_host, h, mpc.iterations_between_mpc, B, stream)
    ks = kin.KinState(
        R_base=R, rpy_base=rpy, pos_base=obs.pos_base, lin_vel_base=obs.lin_vel_base,
        ang_vel_base=obs.ang_vel_base, base_pos_base_feet=p_bf, pos_base_feet=pw,
        pos_feet=feet, base_vel_base_feet=rel, base_pos_base_thighs=thighs, jac_feet=J,
    )
    carry = dataclasses.replace(mpc_carry, xpos_des=xpos, ypos_des=ypos, yaw_des=yaw,
                                first_run=first)
    return ks, swing_states, table, x_t, carry, vdw


def ctrl_post(robot, mpc, gait, cmd, ks: kin.KinState, swing_carry: SwingCarry,
              swing_states, forces, lib=None):
    """``controller._post_solve``'s ``swing.update_swing`` and
    ``legctrl.leg_torques`` in one launch: returns (SwingCarry',
    pos_targets (B,4,3), vel_targets (B,4,3), torques (B,12))."""
    dev = forces.device
    B = forces.shape[0]
    lib, stream = _library(dev, lib)
    ins, strides = _fields([
        ("R_base", ks.R_base, (3, 3)), ("pos_base", ks.pos_base, (3,)),
        ("lin_vel_base", ks.lin_vel_base, (3,)), ("pos_feet", ks.pos_feet, (4, 3)),
        ("base_pos_base_thighs", ks.base_pos_base_thighs, (4, 3)),
        ("base_pos_base_feet", ks.base_pos_base_feet, (4, 3)),
        ("base_vel_base_feet", ks.base_vel_base_feet, (4, 3)), ("jac_feet", ks.jac_feet, (4, 3, 3)),
        ("remaining_swing_time", swing_carry.remaining_swing_time, (4,)),
        ("footpos_init", swing_carry.footpos_init, (4, 3)),
        ("footpos_final", swing_carry.footpos_final, (4, 3)),
        ("swing_states", swing_states, (4,)), ("contact_forces", forces, (12,)),
        ("vel_base_des", cmd.vel_base_des, (3,)), ("yaw_turn_rate", cmd.yaw_turn_rate, ()),
        ("kp_swing", robot.kp_swing, (3,)), ("kd_swing", robot.kd_swing, (3,)),
        ("touchdown_z", robot.touchdown_z, ()), ("swing_height", robot.swing_height, ()),
    ], B, dev)
    outs, ptrs = _outputs([(4,), (4, 3), (4, 3), (4, 3), (4, 3), (12,)], B, dev)
    remaining, init, final, pos_t, vel_t, torques = outs
    first = torch.empty((B, 4), dtype=torch.bool, device=dev)
    _run(dev, "ctrl_post", lib.ctrl_post_launch, ins, strides, ptrs,
         *_gait(gait, B, dev, offsets=False),
         _whole("is_first_swing", swing_carry.is_first_swing, B, (4,), dev, torch.bool),
         first.data_ptr(), _scalar("dt_control", mpc.dt_control, dev),
         _scalar("gravity", mpc.gravity, dev), mpc.iterations_between_mpc,
         int(bool(mpc.ground_adaptive_height)), B, stream)
    new_carry = SwingCarry(is_first_swing=first, remaining_swing_time=remaining,
                           footpos_init=init, footpos_final=final)
    return new_carry, pos_t, vel_t, torques

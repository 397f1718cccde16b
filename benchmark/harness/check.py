"""Whether what the timed path produced is correct.

The window's loop is a closed loop, so each tick's answer is the next
state of every robot and of its controller.  The harness keeps, for a
sample of the window's control periods and of the robots drawn from the
seed, the port's state and carry before the period's solve tick (s0),
after it (s1) and after the first replayed tick (s2), and the operands
that the solve tick handed the solver.  The reference
(:mod:`benchmark.reference`) follows the port step by step from the port's
own state: it cannot replay 4096 robots for the window, and a closed loop
that forks by rounding never meets again.  It judges:

- ``start``: the port's initial state against the reference's, made from
  the same draws;
- ``qp_data``: the solver's operands (the condensed H and g, or the
  prediction model Ad and Bd) against the reference's from s0;
- ``cost_excess`` and ``cone_violation``: the forces the port applied and
  planned (s1's held forces and warm start) on the reference's float64 QP
  of that tick: their cost over the optimum's, and how far they leave the
  friction pyramid.  An answer whose optimum the reference cannot certify
  (KKT residual over :data:`CERTIFIED`) is left out and counted.  Two correct solvers of this ill-conditioned QP can
  differ by tens of percent in a force at equal cost, so the forces are
  judged on the QP's invariants, not elementwise;
- ``solve_step``: s1 against the reference's tick from s0 under the
  port's forces;
- ``replay_step``: s2 against the reference's tick from s1.

Each step's error is the worst over leaves of max |port - reference| over
the reference's own change of that leaf in the tick (:func:`leaf_err`), so
a step that returns its input unchanged reads about 1.  The articulated
plant's penalty contact switches on where a foot touches the ground, and
its damper's force jumps there; a foot within rounding of the switch may
take either side in float32, so the port's step there is judged against
the nearer of the reference's two sides.  Whether a row
diverged in a tick (the port then resets it) is judged too: the port's flag
against the reference's own tick from the same state under the reference's
own answer.  An answer where both diverge is left out and counted
(``excluded_share``); one where only one side diverges reads ``state`` inf,
so a kernel that returns non-finite values on a few rows fails the run.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import closed_loop as ref
from benchmark.reference import qp as refqp
from benchmark.reference import rbd as refrbd
from benchmark.reference.precision import F64, TF32, Precision

#: The largest KKT residual at which the reference's optimum judges a solve.
CERTIFIED = 1e-6

NUMBERS = ("qp_data", "cost_excess", "state", "excluded_share")
#: Read beside the numbers, for the record; no limit.
DIAGNOSTICS = ("start", "solve_step", "replay_step", "cone_violation", "diverged_apart")


def inputs(prec: Precision, cfg: dict, robot_rows: dict, draws: dict, rows: np.ndarray, device):
    """The reference's (mpc, robot, gait, cmd, model, contact) for ``rows``,
    from the configuration and the draws alone."""
    # The configuration's float32 values, as the port is handed them.
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32)[rows], device=device).to(prec.dtype)
    robot = {k: t(v) for k, v in robot_rows.items()}
    m = dict(cfg["mpc"])
    gait = {k: torch.as_tensor(draws[k][rows], device=device)
            for k in ("num_segments", "stance_offsets", "stance_durations")}
    vx = t(draws["vx"])
    cmd = {"vel": torch.stack([vx, torch.zeros_like(vx), torch.zeros_like(vx)], -1),
           "yaw_rate": torch.zeros_like(vx)}
    model = contact = None
    if cfg["plant"] == "fullorder":
        model = refrbd.model_from_spec(robot, cfg["links"], prec.dtype, device)
        contact = {k: float(v) for k, v in cfg["contact"].items()}
    return m, robot, gait, cmd, model, contact


def initial_state(prec, cfg, mix, robot, draws, rows, device):
    """The nominal stance of each row plus its drawn jitter."""
    t = lambda v: torch.as_tensor(np.asarray(v)[rows], dtype=prec.dtype, device=device)
    R_ = len(rows)
    q0 = torch.as_tensor(mix["init"]["nominal_q"], dtype=prec.dtype, device=device)
    q0 = q0.repeat(4).expand(R_, 12)
    p_bf, _ = ref.leg_fk(robot, q0.reshape(R_, 4, 3))
    quat = torch.tensor([1.0, 0, 0, 0], dtype=prec.dtype, device=device).expand(R_, 4)
    if cfg["plant"] == "srb":
        pos = torch.zeros(R_, 3, dtype=prec.dtype, device=device)
        pos[:, 2] = robot["base_height_des"]
        feet = pos[:, None, :] + p_bf
        feet = torch.cat([feet[..., :2], torch.zeros_like(feet[..., 2:])], -1)
        return dict(pos=pos + t(draws["dpos"]), quat=quat, vel=t(draws["dvel"]),
                    omega_body=torch.zeros_like(pos), foot_pos=feet,
                    foot_vel=torch.zeros_like(feet))
    z0 = -p_bf[..., 2].amin(-1) + cfg["contact"]["foot_radius"]
    pos = torch.stack([torch.zeros_like(z0), torch.zeros_like(z0), z0], -1)
    return dict(pos=pos + t(draws["dpos"]), quat=quat, u=t(draws["du"]), q=q0 + t(draws["dq"]))


def _to(d: dict, prec: Precision) -> dict:
    return {k: (v.to(prec.dtype) if v.is_floating_point() else v) for k, v in d.items()}


def leaf_err(got: dict, want: dict, before: dict) -> torch.Tensor:
    """Per row, the worst over leaves of max |got - want| over the leaf's
    scale, max(|want - before|, 1e-2 |want|, 1e-9) over all rows: the
    tick's change of the leaf, or a hundredth of its size for a leaf that
    barely moves in a tick, where float32 rounding of the value itself is
    a large share of the change (a quaternion, or a foot velocity that is
    a difference over 1 ms).  A boolean leaf reads 1 in a row where it
    differs; a value that is not finite reads inf."""
    worst = None
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            e = (g != w).reshape(len(w), -1).any(-1).double()
        else:
            g, w, b = g.double(), w.double(), before[k].double()
            scale = max(float((w - b).abs().max()), 1e-2 * float(w.abs().max()), 1e-9)
            e = (g - w).abs().reshape(len(w), -1).amax(-1) / scale
        e = torch.where(torch.isfinite(e), e, torch.full_like(e, float("inf")))
        worst = e if worst is None else torch.maximum(worst, e)
    return worst


def rel_max(a, b) -> torch.Tensor:
    """Per row max |a - b| over max |b|."""
    a, b = a.double().reshape(len(a), -1), b.double().reshape(len(b), -1)
    e = (a - b).abs().amax(-1) / b.abs().amax(-1).clamp(min=1e-30)
    return torch.where(torch.isfinite(e), e, torch.full_like(e, float("inf")))


def control_outputs(prec, cfg, setup, slot, solver):
    """What the reference computed in ``prec`` returns in the port's place
    for ``slot``: the solver's operands, the forces and plan of the exact
    optimum of its own QP, and its own steps from s0 and s1."""
    m, robot, gait, cmd, model, contact = setup
    kw = dict(model=model, contact=contact, knee_cos_max=cfg.get("knee_cos_max"))
    s0s, s0c = _to(slot["s0"]["state"], prec), _to(slot["s0"]["carry"], prec)
    probe = ref.tick(prec, cfg["plant"], m, robot, gait, cmd, s0s, s0c, slot["t"],
                     forces=torch.zeros_like(s0c["mpc.contact_forces"]), **kw)["qp"]
    U, _ = refqp.optimum(probe["H"], probe["g"], probe["table"], m["friction_coef"],
                         robot["fz_max"])
    U = (U * probe["mv"]).to(prec.dtype)
    a = ref.tick(prec, cfg["plant"], m, robot, gait, cmd, s0s, s0c, slot["t"],
                 forces=U[:, :12], **kw)
    carry1 = dict(a["carry"], **{"mpc.qp_primal": U})
    s1 = {"state": a["state"], "carry": carry1}
    b = ref.tick(prec, cfg["plant"], m, robot, gait, cmd, _to(slot["s1"]["state"], prec),
                 _to(slot["s1"]["carry"], prec), slot["t"] + 1, **kw)
    names = ("H", "g") if solver == "admm_fast" else ("Ad", "Bd")
    return {"qp": {n: probe[n] for n in names}, "s1": s1,
            "s2": {"state": b["state"], "carry": b["carry"]},
            "bad": torch.stack([a["diverged"], b["diverged"]])}


def step_err(got: dict, ticks: list, before: dict, skip: tuple) -> torch.Tensor:
    """Per row, :func:`leaf_err` of the port's state and carry after a tick
    against the nearest of the reference's ``ticks`` (one tick, or its two
    sides of the contact switch), leaving out the carry's ``skip``."""
    errs = [leaf_err(got, {**t["state"], **{k: v for k, v in t["carry"].items()
                                             if k not in skip}}, before) for t in ticks]
    return torch.stack(errs).amin(0)


def judge(cfg: dict, mix: dict, solver: str, robot_rows: dict, draws: dict, rows: np.ndarray,
          start: dict, slots: list, device, control: Precision | None = None) -> dict:
    """Per-answer numbers for the port's outputs in ``slots`` or, with
    ``control``, for the reference computed in that precision put in the
    port's place: "start" (R,); "qp_data", "cost_excess", "solve_step",
    "replay_step" and "cone_violation", each (slots, R); and "kept" (slots,
    R), False where an answer is not judged; "diverged_apart" (slots, R), 1
    where only one of the port and the reference diverged in a tick."""
    setup = inputs(F64, cfg, robot_rows, draws, rows, device)
    m, robot, gait, cmd, model, contact = setup
    kw = dict(model=model, contact=contact, knee_cos_max=cfg.get("knee_cos_max"))
    s_ref = initial_state(F64, cfg, mix, robot, draws, rows, device)
    if control is not None:
        csetup = inputs(control, cfg, robot_rows, draws, rows, device)
        start = initial_state(control, cfg, mix, csetup[1], draws, rows, device)
    zero = {k: torch.zeros_like(v) for k, v in s_ref.items()}
    out = {"start": leaf_err(start, s_ref, zero)}
    per = {k: [] for k in ("qp_data", "cost_excess", "kept") + DIAGNOSTICS[1:]}
    skip = ("mpc.qp_primal", "mpc.qp_dual", "mpc.contact_forces")
    for slot in slots:
        got = control_outputs(control, cfg, csetup, slot, solver) if control is not None else {
            "qp": slot["qp"], "s1": slot["s1"], "s2": slot["s2"], "bad": slot["bad"]}
        s0s, s0c = _to(slot["s0"]["state"], F64), _to(slot["s0"]["carry"], F64)
        # The port's applied forces and its plan past the first step.
        c1 = got["s1"]["carry"]
        U = torch.cat([c1["mpc.contact_forces"], c1["mpc.qp_primal"][:, 12:]], -1).double()
        a = ref.tick(F64, cfg["plant"], m, robot, gait, cmd, s0s, s0c, slot["t"],
                     forces=c1["mpc.contact_forces"].double(), **kw)
        s1s, s1c = _to(slot["s1"]["state"], F64), _to(slot["s1"]["carry"], F64)
        b = ref.tick(F64, cfg["plant"], m, robot, gait, cmd, s1s, s1c, slot["t"] + 1, **kw)
        sides_a, sides_b = [a], [b]
        if cfg["plant"] == "fullorder":
            sides_a.append(ref.tick(F64, cfg["plant"], m, robot, gait, cmd, s0s, s0c, slot["t"],
                                    forces=c1["mpc.contact_forces"].double(), other_side=True,
                                    **kw))
            sides_b.append(ref.tick(F64, cfg["plant"], m, robot, gait, cmd, s1s, s1c,
                                    slot["t"] + 1, other_side=True, **kw))
        qp = a["qp"]
        U_star, cert = refqp.optimum(qp["H"], qp["g"], qp["table"], m["friction_coef"],
                                     robot["fz_max"])
        # Whether each row diverged in the solve tick and in the replayed
        # tick: the port's flags (it resets such a row) against the
        # reference's from the same states, the solve tick's under the
        # reference's own optimum.  Where both diverge the answer is left
        # out; where one side alone does, the port's step is wrong.
        own = ref.tick(F64, cfg["plant"], m, robot, gait, cmd, s0s, s0c, slot["t"],
                       forces=(U_star * qp["mv"])[:, :12], **kw)
        ref_bad = torch.stack([own["diverged"], b["diverged"]])
        both = (got["bad"] & ref_bad).any(0)
        apart = (got["bad"] != ref_bad) & ~both
        per["kept"].append(~both & (cert < CERTIFIED))
        per["diverged_apart"].append(apart.any(0).double())
        far = torch.tensor(float("inf"), dtype=torch.float64, device=apart.device)
        per["qp_data"].append(torch.stack([rel_max(mine, qp[n]) for n, mine in got["qp"].items()]
                                          ).amax(0))
        q_star = refqp.cost(qp["H"], qp["g"], U_star)
        excess = (refqp.cost(qp["H"], qp["g"], U) - q_star) / (q_star.abs() + 1.0)
        per["cost_excess"].append(torch.where(torch.isfinite(excess), excess,
                                              torch.full_like(excess, float("inf"))))
        cone = refqp.cone_violation(U, qp["table"], m["friction_coef"], robot["fz_max"])
        per["cone_violation"].append(torch.where(torch.isfinite(cone), cone,
                                                 torch.full_like(cone, float("inf"))))
        per["solve_step"].append(torch.where(
            apart[0], far, step_err({**got["s1"]["state"], **got["s1"]["carry"]}, sides_a,
                                    {**s0s, **s0c}, skip)))
        per["replay_step"].append(torch.where(
            apart[1], far, step_err({**got["s2"]["state"], **got["s2"]["carry"]}, sides_b,
                                    {**s1s, **s1c}, skip[:2])))
    for k, v in per.items():
        out[k] = torch.stack(v) if v else torch.zeros(0, len(rows), device=device)
    return out


def summary(per: dict, limits: dict) -> tuple[dict, int, int]:
    """(numbers, attempted, failed).  ``state`` is, per answer, the worst of
    its row's start, its solve tick's step and its replayed tick's step;
    each number is its worst over the judged answers, ``excluded_share``
    the share of answers not judged; :data:`DIAGNOSTICS` and the median
    cost excess ride along under ``diag``.  An answer (a row of a checked
    period) fails where any of its numbers is over its limit."""
    kept = per["kept"]
    per = dict(per, state=torch.maximum(torch.maximum(per["solve_step"], per["replay_step"]),
                                        per["start"][None].expand_as(per["solve_step"])))
    numbers, diag = {}, {"start": float(per["start"].max())}
    bad = torch.zeros_like(kept)
    for k in ("qp_data", "cost_excess", "state") + DIAGNOSTICS[1:]:
        v = per[k][kept]
        value = float(v.max()) if v.numel() else 0.0
        (numbers if k in NUMBERS else diag)[k] = value
        if k in NUMBERS and limits.get(k) is not None:
            bad |= kept & ~(per[k] <= limits[k])
    v = per["cost_excess"][kept]
    diag["cost_excess_median"] = float(v.median()) if v.numel() else 0.0
    numbers["excluded_share"] = float((~kept).double().mean()) if kept.numel() else 0.0
    numbers["diag"] = diag
    return numbers, int(kept.numel()), int(bad.sum())


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or not finite, fails."""
    report = {k: {"value": numbers[k], "limit": limits.get(k)} for k in NUMBERS}
    ok = all(r["limit"] is not None and math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in report.values())
    return ok, report


__all__ = ["judge", "verdict", "NUMBERS", "TF32", "F64"]

"""The port's single-card ``parallel/sweep.py`` against the JAX package.

``mixed_gait_batch`` equal to JAX's; a mixed-gait batch's rows bitwise equal
to uniform batches' rows (tests/test_gait_sweep.py:51-76: no leakage
between scenarios); ``randomized_robots`` inside [exp(-scale), exp(scale)]
and deterministic per seed; ``gait_sweep``'s per-gait reduction against
JAX's on the same metrics (both rollouts replaced by one set of numbers);
``rollout_sweep`` and ``solve_sweep_step`` against what they reduce and
call.  The sharded sweeps are tests/test_torch_parallel.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pympc_quadruped_tpu.env import srb_env as jenv
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.parallel import sweep as jsweep

from pympc_quadruped_tpu_torch import convert, engine, tree
from pympc_quadruped_tpu_torch.env import srb_env
from pympc_quadruped_tpu_torch.models import aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.parallel import sweep

torch.set_num_threads(1)
NAMES = ["trotting10", "pacing10", "bounding8"]
A = convert.as_arrays


def test_mixed_gait_batch_matches_jax():
    B = 7
    g_j, c_j, ids_j = jsweep.mixed_gait_batch(NAMES, B)
    g, c, ids = sweep.mixed_gait_batch(NAMES, B, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    for name in ("num_segments", "stance_offsets", "stance_durations"):
        got, want = getattr(g, name), np.asarray(getattr(g_j, name))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(c.vel_base_des.numpy(), np.asarray(c_j.vel_base_des))
    np.testing.assert_array_equal(c.yaw_turn_rate.numpy(), np.asarray(c_j.yaw_turn_rate))
    assert sweep.GAIT_SWEEP_VX == jsweep.GAIT_SWEEP_VX


def test_mixed_batch_matches_uniform_batch():
    """Row i of the mixed batch is bitwise row i of a same-shaped batch that
    runs only that gait."""
    mpc = default_mpc_params(10, device="cpu")
    B = len(NAMES)
    robot_b = tree.tile(aliengo("cpu"), B)
    gait_b, cmd_b, _ = sweep.mixed_gait_batch(NAMES, B, device="cpu")
    (mixed, _), _ = srb_env.rollout(robot_b, mpc, gait_b, cmd_b, 200, auto_reset=False)
    for i, name in enumerate(NAMES):
        g_u, c_u, _ = sweep.mixed_gait_batch([name], B, device="cpu")
        (uniform, _), _ = srb_env.rollout(robot_b, mpc, g_u, c_u, 200, auto_reset=False)
        assert torch.equal(mixed.pos[i], uniform.pos[i]), name


def test_randomized_robots_bounded_and_seeded():
    robot = aliengo("cpu")
    gen = lambda s: torch.Generator().manual_seed(s)
    r1 = sweep.randomized_robots(robot, 64, gen(3), mass_scale=0.2, inertia_scale=0.1)
    r2 = sweep.randomized_robots(robot, 64, gen(3), mass_scale=0.2, inertia_scale=0.1)
    r3 = sweep.randomized_robots(robot, 64, gen(4), mass_scale=0.2, inertia_scale=0.1)
    tree.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), r1, r2)
    assert not torch.equal(r1.mass, r3.mass)
    mf = r1.mass / robot.mass
    inf = r1.inertia / robot.inertia
    assert float(mf.min()) >= np.exp(-0.2) * (1 - 1e-6) and float(mf.max()) <= np.exp(0.2) * (1 + 1e-6)
    assert float(inf.min()) >= np.exp(-0.1) * (1 - 1e-6) and float(inf.max()) <= np.exp(0.1) * (1 + 1e-6)
    assert float(mf.std()) > 0.0
    # One factor per scenario scales the whole inertia matrix.
    torch.testing.assert_close(inf, inf[:, :1, :1].expand_as(inf))
    torch.testing.assert_close(r1.l_thigh, robot.l_thigh.expand(64))


def test_gait_sweep_reduction_matches_jax(monkeypatch):
    """Both packages' ``gait_sweep`` reduce the same (fake) rollout result:
    survival (a fall, an upright dip and a divergence among the scenarios),
    tail tracking error and forward displacement per gait."""
    B, T = 8, 40          # JAX shards the batch over the 8 CPU devices of tests/conftest.py
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(B, 3)).astype(np.float32)
    pos[:, 2] = 0.38
    pos[1, 2] = 0.05                                   # fallen
    metrics = {"vel_err": rng.uniform(0, 0.3, (T, B)).astype(np.float32),
               "height": np.full((T, B), 0.38, np.float32),
               "upright": np.full((T, B), 0.99, np.float32),
               "diverged": np.zeros((T, B), bool)}
    metrics["upright"][-3, 4] = 0.5                    # tipped in the tail
    metrics["diverged"][5, 2] = True                   # diverged early
    robot_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), jaliengo())
    state_j = jax.vmap(jenv.default_init_state)(robot_j).replace(pos=jnp.asarray(pos))

    def fake_jax(*a, **k):
        return (state_j, None), {k_: jnp.asarray(v) for k_, v in metrics.items()}

    def fake_port(*a, **k):
        return (convert.srb_state(A(state_j), device="cpu"), None), {
            k_: torch.tensor(v) for k_, v in metrics.items()}

    monkeypatch.setattr(jsweep.srb_env, "rollout", fake_jax)
    monkeypatch.setattr(sweep.srb_env, "rollout", fake_port)
    _, want = jsweep.gait_sweep(robot_j, JMpcParams(horizon=10), NAMES, T)
    _, got = sweep.gait_sweep(convert.robot_params(A(robot_j), device="cpu"),
                              default_mpc_params(10, device="cpu"), NAMES, T)
    assert set(got) == set(want)
    for name in NAMES:
        assert set(got[name]) == set(want[name])
        for k, v in want[name].items():
            np.testing.assert_allclose(got[name][k], v, rtol=1e-6, err_msg=f"{name} {k}")
    np.testing.assert_allclose(got["pacing10"]["survival_frac"], 1 / 3)  # 1 fell, 4 tipped
    assert got["bounding8"]["survival_frac"] == 0.5       # scenario 2 diverged


def test_rollout_sweep_summarizes_its_rollout():
    mpc = default_mpc_params(10, device="cpu")
    B, T = 3, 80
    robot_b = tree.tile(aliengo("cpu"), B)
    gait_b, cmd_b, _ = sweep.mixed_gait_batch(NAMES, B, device="cpu")
    state, summary = sweep.rollout_sweep(robot_b, mpc, gait_b, cmd_b, T)
    (state_r, _), m = srb_env.rollout(robot_b, mpc, gait_b, cmd_b, T)
    assert torch.equal(state.pos, state_r.pos)
    tail = m["vel_err"][-T // 4:]
    # Means are float64 sums divided once (mesh.global_mean), then float32.
    assert float(summary["mean_vel_err"]) == float(tail.double().mean().float())
    assert float(summary["max_vel_err"]) == float(tail.max())
    assert float(summary["survival_frac"]) == 1.0


def test_solve_sweep_step_is_the_engine_solve():
    B, h = 3, 10
    rng = np.random.default_rng(1)
    robot = tree.tile(aliengo("cpu"), B)
    mpc = default_mpc_params(h, device="cpu")
    x_t = torch.tensor(rng.normal(scale=0.1, size=(B, 13)), dtype=torch.float32)
    x_t[:, 5] += 0.38
    x_t[:, 12] = -9.81
    yaw = x_t[:, 2].clone()
    feet = torch.tensor([[0.24, 0.13, -0.38], [0.24, -0.13, -0.38],
                         [-0.24, 0.13, -0.38], [-0.24, -0.13, -0.38]]).expand(B, 4, 3)
    X_ref = x_t[:, None, :].expand(B, h, 13).clone()
    table = torch.ones(B, 4 * h)
    for solver in ("admm", "riccati"):
        U, diag = sweep.solve_sweep_step(robot, mpc, x_t, yaw, feet, X_ref, table,
                                         solver=solver, return_diagnostics=True)
        U_e = engine.solve_scenarios(robot, mpc, x_t, yaw, feet, X_ref, table, solver=solver)
        assert torch.equal(U, U_e) and tuple(U.shape) == (B, 12)
        assert isinstance(diag, dict)

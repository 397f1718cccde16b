"""The port's distributed sweep (``parallel/{mesh,launch,checkpoint}.py``,
the mesh-aware ``parallel/sweep.py`` and ``examples/sweep.py``) on the CPU.

- One process: every placement is the identity; a size-2 mesh's rows and
  JAX's ``ValueError`` on a batch that does not divide.
- Two gloo ranks (tests/_torch_multihost_worker.py, spawned once with a
  free port and a 420 s timeout, as tests/test_multihost.py does):
  ``per_host_batch`` and its error; the collectives; the sharded
  ``solve_sweep_step`` against the unsharded solve (``riccati`` at
  tests/test_sharding.py:37's atol 1e-5, ``admm`` at
  tests/_multihost_worker.py's bars) and against JAX's on the QP
  invariants; ``rollout_sweep`` and ``gait_sweep`` summaries identical on
  both ranks and equal to one process's, and ``gait_sweep``'s reduction of
  one fake rollout against JAX's; a checkpoint of sharded rows and a
  replicated tick.
- ``SweepCheckpointer``: tests/test_env_aux.py:107-127's round trip, a
  step without its commit marker, ``keep``, another world size, and
  another tool's step directories, which it neither reads nor removes;
  the steps it keeps after ``close()`` against the JAX package's (orbax)
  for 1-8 saves at ``keep`` 1-4, async or not, and over two ranks, the
  newest read back bitwise, and ``keep=0`` refused.
- The spans and counters of ``parallel/`` (``launch.join``,
  ``mesh.reduce``, ``ckpt.*``; utils/profiling.py), in one process and
  on two ranks, on and off, and in a ``torch.profiler``'s host events.
- The entry point (``python -m pympc_quadruped_tpu_torch.examples.sweep
  --device cpu``): tests/test_sweep_resume.py:49 and :81 (kill after one
  chunk, resume in a fresh process, final checkpoint bitwise a straight
  run's; the resumed displacement beyond one chunk's reach), and an
  estimator sweep over two ranks (torch's launcher variables) bitwise the
  one-process run, so each rank's sensor noise is its rows' noise.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pympc_quadruped_tpu import engine as jengine
from pympc_quadruped_tpu.env import srb_env as jenv
from pympc_quadruped_tpu.models.mpc import MpcParams as JMpcParams
from pympc_quadruped_tpu.models.robots import aliengo as jaliengo
from pympc_quadruped_tpu.parallel import sweep as jsweep
from pympc_quadruped_tpu.parallel.checkpoint import SweepCheckpointer as JSweepCheckpointer

from pympc_quadruped_tpu_torch import tree
from pympc_quadruped_tpu_torch.models import aliengo, default_mpc_params
from pympc_quadruped_tpu_torch.parallel import launch, mesh as mesh_lib, sweep
from pympc_quadruped_tpu_torch.parallel.checkpoint import SweepCheckpointer, read_step
from pympc_quadruped_tpu_torch.utils import profiling
from _torch_multihost_worker import (KEEP, NAMES, SAVES, SWEEP_B, SWEEP_SOLVER, SWEEP_T,
                                     TRACED)
from test_torch_condense import jax_build_qp, qp_inputs
from test_torch_qp_parity import FZ_MAX, _cone_violation, _cost, _support

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
NPROCS, SOLVE_B, SOLVE_H = 2, 8, 10
#: The fake rollout result of tests/test_torch_sweep.py's reduction test.
FAKE_B, FAKE_T = 8, 40
#: f64 relative cost difference of two solves of one QP
#: (tests/test_admm_fast.py:102, tests/test_torch_admm.py).
COST_BAR = 2e-5
CPU = torch.device("cpu")


def _fake_rollout_data():
    """tests/test_torch_sweep.py's fake rollout: a fall, an upright dip in
    the tail and an early divergence among 8 scenarios."""
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(FAKE_B, 3)).astype(np.float32)
    pos[:, 2] = 0.38
    pos[1, 2] = 0.05
    metrics = {"vel_err": rng.uniform(0, 0.3, (FAKE_T, FAKE_B)).astype(np.float32),
               "height": np.full((FAKE_T, FAKE_B), 0.38, np.float32),
               "upright": np.full((FAKE_T, FAKE_B), 0.99, np.float32),
               "diverged": np.zeros((FAKE_T, FAKE_B), bool)}
    metrics["upright"][-3, 4] = 0.5
    metrics["diverged"][5, 2] = True
    return pos, metrics


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of one two-process run of the worker."""
    d = tmp_path_factory.mktemp("ranks")
    x_t, yaw, feet, X_ref, table = qp_inputs(SOLVE_B, SOLVE_H, 21)
    pos, metrics = _fake_rollout_data()
    np.savez(d / "inputs.npz", x_t=x_t, yaw=yaw, feet=feet, X_ref=X_ref, table=table,
             h=SOLVE_H, pos=pos, **metrics)
    port = launch.free_port()
    launch.run_ranks([([sys.executable, WORKER, str(r), str(NPROCS), str(port), str(d)],
                       launch.launcher_env()) for r in range(NPROCS)], timeout=420)
    return [torch.load(d / f"result_{r}.pt", weights_only=True) for r in range(NPROCS)]


# ---------------------------------------------------------------------------
# (a) mesh and launch in one process
# ---------------------------------------------------------------------------

def test_one_process_placement_is_identity(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert launch.init_distributed(device="cpu") is None
    mesh = launch.global_data_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, CPU)
    assert mesh.backend is None
    assert mesh_lib.data_mesh("cpu") == mesh
    robot = tree.tile(aliengo("cpu"), 5)
    for fn in (mesh_lib.shard_batch, mesh_lib.shard_global_batch, mesh_lib.replicate):
        placed = fn(robot, mesh)
        tree.tree_map(lambda a, b: (a is b) or pytest.fail(f"{fn.__name__} copied a leaf"),
                      placed, robot)
    assert launch.per_host_batch(7) == 7
    x = torch.arange(5.0)
    assert mesh_lib.global_sum(x, mesh) is x
    assert float(mesh_lib.global_max(x, mesh)) == 4.0
    assert float(mesh_lib.global_mean(x, mesh)) == 2.0


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_mesh_keeps_its_rows(rank):
    """Rank r of 2 keeps rows [r*B/2, (r+1)*B/2) of every batched leaf; an
    unbatched leaf of the tree (mpc's horizon) passes through."""
    mesh = mesh_lib.DataMesh(None, rank, 2, CPU)
    robot = tree.tile(aliengo("cpu"), 8)
    robot.mass = robot.mass * torch.arange(1.0, 9.0)
    part = mesh_lib.shard_global_batch(robot, mesh)
    assert torch.equal(part.mass, robot.mass[4 * rank:4 * rank + 4])
    assert torch.equal(part.inertia, robot.inertia[4 * rank:4 * rank + 4])
    assert mesh_lib.batch_sharding(mesh).rows(8) == slice(4 * rank, 4 * rank + 4)
    mpc = mesh_lib.replicate(default_mpc_params(10, device="cpu"), mesh)
    assert mpc.horizon == 10


def test_indivisible_batch_raises_the_jax_error():
    mesh = mesh_lib.DataMesh(None, 0, 2, CPU)
    with pytest.raises(ValueError, match="^batch 7 not divisible by 2 hosts$"):
        mesh_lib.shard_global_batch(torch.zeros(7, 3), mesh)


def test_init_distributed_needs_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no coordinator"):
        launch.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_two_ranks_launch_and_reduce(ranks):
    """Each rank joined a gloo group of 2 and holds 4 of 8 scenarios;
    ``per_host_batch`` and ``shard_global_batch`` raise JAX's texts; sums,
    max and mean over both ranks' shards."""
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * r for r in range(NPROCS)]
    for r, res in enumerate(ranks):
        assert (res["backend"], res["rank"], res["size"]) == ("gloo", r, NPROCS)
        assert res["per_host_batch"] == 4
        assert res["per_host_error"] == "global batch 7 not divisible by 2 hosts"
        assert res["shard_error"] == "batch 7 not divisible by 2 hosts"
        np.testing.assert_array_equal(res["sum"]["x"].numpy(), x[0] + x[1])
        assert int(res["sum"]["n"]) == 3 and res["sum"]["n"].dtype == torch.int64
        assert float(res["max"]) == 15.0
        assert float(res["mean"]) == float(np.mean(np.concatenate(x)))


# ---------------------------------------------------------------------------
# (b) the sharded solve
# ---------------------------------------------------------------------------

def _sharded(ranks, key):
    return torch.cat([res[key] for res in ranks])


@pytest.mark.parametrize("solver", ["admm", "riccati"])
def test_sharded_solve_matches_unsharded(ranks, solver):
    """The ranks' rows against the unsharded solve of the same 8 scenarios.

    ``riccati``: tests/test_sharding.py:37's atol 1e-5 (measured: bitwise).
    ``admm``: the plain path multiplies (B, m) by the cone pattern as one
    GEMM whose blocking follows B, so 4 rows and 8 round differently, and
    fixed-iteration ADMM carries that along the QP's weak directions
    (measured: 48 of 96 elements differ, by up to 1.09e-3 N; support by up
    to 3.1e-4 N).  It is held to tests/_multihost_worker.py's bars:
    elementwise < 2.0 N, each step's total vertical support < 0.5 N and the
    global mean |U| within 0.01 of the unsharded one."""
    U = _sharded(ranks, f"U_{solver}")
    for res in ranks:
        U_full = res[f"U_full_{solver}"]
        assert U.shape == U_full.shape == (SOLVE_B, 12)
        if solver == "riccati":
            np.testing.assert_allclose(U.numpy(), U_full.numpy(), rtol=0, atol=1e-5)
        else:
            assert float((U - U_full).abs().max()) < 2.0
            assert np.all(np.abs(_support(U, 1) - _support(U_full, 1)) < 0.5)
        assert abs(float(res[f"mean_abs_{solver}"]) - float(U_full.abs().mean())) < 0.01


@pytest.mark.parametrize("solver", ["admm", "riccati"])
def test_sharded_solve_matches_jax_on_invariants(ranks, solver):
    """The ranks' solve against JAX's on the same seeded inputs, on the QP's
    invariants (tests/test_torch_admm.py, tests/test_torch_qp_parity.py):
    the whole horizon's f64 cost within COST_BAR of the JAX engine's, cone
    rows within 1e-3 fz_max and swing forces exactly 0, and the first step
    (the whole horizon's) on JAX's ``sweep.solve_sweep_step``'s cone and
    swing bars.  No per-force bar: with ``admm`` JAX's own jitted sweep
    step and its eager engine call differ by up to 2.4 N in one force at
    equal cost (the QP's weak directions)."""
    arrays = qp_inputs(SOLVE_B, SOLVE_H, 21)
    robot_j, mpc_j = jaliengo(), JMpcParams(horizon=SOLVE_H)
    j_args = tuple(map(jnp.asarray, arrays))
    U_j1 = np.asarray(jsweep.solve_sweep_step(robot_j, mpc_j, *j_args, solver=solver))
    U_jh = np.asarray(jengine.solve_scenarios(robot_j, mpc_j, *j_args, solver=solver,
                                              return_full_horizon=True))
    first = arrays[4][:, :4]
    for V in (U_j1, U_jh[:, :12]):
        assert np.all(_cone_violation(V, first, 1) < 1e-3 * FZ_MAX)
        assert np.all(V.reshape(SOLVE_B, 4, 3)[first == 0] == 0.0)
    U, U_h = _sharded(ranks, f"U_{solver}"), _sharded(ranks, f"U_horizon_{solver}")
    assert torch.equal(U, U_h[:, :12])
    Hj, gj, mvj = jax_build_qp(arrays, SOLVE_H)
    c, c_j = _cost(Hj, gj, U_h), _cost(Hj, gj, U_jh)
    assert np.all(np.abs(c - c_j) / (np.abs(c_j) + 1.0) < COST_BAR), (c, c_j)
    assert np.all(_cone_violation(U_h, arrays[4], SOLVE_H) < 1e-3 * FZ_MAX)
    assert torch.all(U_h[torch.tensor(np.asarray(mvj)) == 0] == 0.0)


# ---------------------------------------------------------------------------
# (c) the sharded sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rollout_sweep", "gait_sweep"])
def test_sharded_sweep_matches_one_process(ranks, fn):
    """Both ranks return the same summary, equal to one process's, and each
    rank's final states are its rows of the one-process run, all bit for
    bit.  The sweeps run ``riccati``, whose CPU solve is the same for 3
    rows as for 6 (test_sharded_solve_matches_unsharded); the default
    ``admm_fast``'s plain path is not, so its sharded rows would differ in
    the last bits and the summaries with them."""
    mpc = default_mpc_params(10, device="cpu")
    robot = tree.tile(aliengo("cpu"), SWEEP_B)
    if fn == "rollout_sweep":
        gait_b, cmd_b, _ = sweep.mixed_gait_batch(NAMES, SWEEP_B, device="cpu")
        state, want = sweep.rollout_sweep(robot, mpc, gait_b, cmd_b, SWEEP_T,
                                          solver=SWEEP_SOLVER)
        key = "rollout"
    else:
        state, want = sweep.gait_sweep(robot, mpc, NAMES, SWEEP_T, solver=SWEEP_SOLVER)
        key = "gait"
    assert torch.equal(_sharded(ranks, f"{key}_pos"), state.pos)
    for res in ranks:
        got = res[f"{key}_summary"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            if fn == "rollout_sweep":
                assert torch.equal(got[k], v), (k, got[k], v)
            else:
                assert got[k] == v, (k, got[k], v)
    if fn == "gait_sweep":
        for name in NAMES:
            assert want[name]["survival_frac"] == 1.0


def test_sharded_gait_sweep_reduction_matches_jax(ranks, monkeypatch):
    """JAX's ``gait_sweep`` over the fake rollout (sharded over this
    process's 8 CPU devices) against the port's over 2 ranks."""
    pos, metrics = _fake_rollout_data()
    robot_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (FAKE_B,) + jnp.shape(x)), jaliengo())
    state_j = jax.vmap(jenv.default_init_state)(robot_j).replace(pos=jnp.asarray(pos))
    monkeypatch.setattr(jsweep.srb_env, "rollout", lambda *a, **k: (
        (state_j, None), {k_: jnp.asarray(v) for k_, v in metrics.items()}))
    _, want = jsweep.gait_sweep(robot_j, JMpcParams(horizon=10), NAMES, FAKE_T)
    for res in ranks:
        got = res["fake_per_gait"]
        assert got.keys() == want.keys()
        for name in NAMES:
            for k, v in want[name].items():
                np.testing.assert_allclose(got[name][k], v, rtol=1e-6, err_msg=f"{name} {k}")
        np.testing.assert_allclose(got["pacing10"]["survival_frac"], 1 / 3)
        assert got["bounding8"]["survival_frac"] == 0.5
    assert ranks[0]["fake_per_gait"] == ranks[1]["fake_per_gait"]


# ---------------------------------------------------------------------------
# (d) SweepCheckpointer
# ---------------------------------------------------------------------------

def _roundtrip_state():
    return {
        "env_pos": torch.arange(12.0).reshape(4, 3),
        "tick": torch.tensor(7, dtype=torch.int32),
        "rng": torch.Generator().manual_seed(3).get_state(),
    }


def test_sweep_checkpoint_roundtrip(tmp_path):
    state = _roundtrip_state()
    ckpt = SweepCheckpointer(str(tmp_path / "ck"), keep=2)
    assert ckpt.restore_or(state)[0] == 0
    assert ckpt.latest_step is None
    ckpt.save(5, state)
    ckpt.wait()
    step, restored = ckpt.restore_or(tree.tree_map(torch.zeros_like, state))
    assert step == 5 == ckpt.latest_step
    for k in state:
        assert restored[k].dtype == state[k].dtype
        assert torch.equal(restored[k], state[k]), k
    ckpt.close()


def test_checkpoint_two_ranks(ranks):
    """tests/_multihost_worker.py:248-272: sharded rows and a replicated
    count saved by 2 ranks come back on each rank; an async save then
    commits step 2 and ``keep=1`` prunes step 1."""
    for res in ranks:
        assert res["ckpt_step"] == 1 and int(res["ckpt_count"]) == 7
        assert torch.equal(res["ckpt_U"], res["U_admm"])
        assert res["ckpt_step2"] == 2 and int(res["ckpt_count2"]) == 8
        assert torch.equal(res["ckpt_U2"], res["U_admm"] + 1.0)
        assert res["ckpt_steps"] == [2]


def test_checkpoint_ignores_an_unfinished_step(tmp_path):
    """A step whose commit marker is missing (a kill during its save) is not
    the latest; the next save removes it."""
    d = tmp_path / "ck"
    ckpt = SweepCheckpointer(str(d), keep=3, async_save=False)
    state = _roundtrip_state()
    ckpt.save(1, state)
    os.makedirs(d / "2")
    torch.save({"env_pos": torch.ones(4, 3)}, d / "2" / "rank0-of-1.pt")
    assert ckpt.latest_step == 1
    step, restored = ckpt.restore_or(tree.tree_map(torch.zeros_like, state))
    assert step == 1 and torch.equal(restored["env_pos"], state["env_pos"])
    ckpt.save(3, state)
    assert sorted(os.listdir(d)) == ["1", "3"]
    assert json.loads((d / "3" / "commit").read_text()) == {"step": 3, "world_size": 1}
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save(3, state)


def test_checkpoint_keeps_the_newest(tmp_path):
    ckpt = SweepCheckpointer(str(tmp_path / "ck"), keep=2)
    state = _roundtrip_state()
    for step in range(1, 5):
        state["tick"] = state["tick"] + 1
        ckpt.save(step, state)
    ckpt.close()
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    step, restored = ckpt.restore_or(tree.tree_map(torch.zeros_like, state))
    assert step == 4 and int(restored["tick"]) == 11


def test_checkpoint_refuses_another_world_size(tmp_path):
    """A step saved by 2 ranks is not restored by one process (no
    resharding); a state of another structure is refused too."""
    d = tmp_path / "ck"
    SweepCheckpointer(str(d), async_save=False).save(1, _roundtrip_state())
    with pytest.raises(ValueError, match="does not match the state's structure"):
        SweepCheckpointer(str(d)).restore_or({"env_pos": torch.zeros(4, 3)})
    meta = json.loads((d / "1" / "commit").read_text())
    (d / "1" / "commit").write_text(json.dumps({**meta, "world_size": NPROCS}))
    with pytest.raises(ValueError, match="saved by 2 ranks; this run has 1"):
        SweepCheckpointer(str(d)).restore_or(_roundtrip_state())


def test_checkpoint_leaves_foreign_steps_alone(tmp_path):
    """Step directories that hold another tool's files (an orbax step, say)
    are neither the latest step, nor pruned, nor written into."""
    d = tmp_path / "ck"
    for step in (1, 9):
        os.makedirs(d / str(step))
        (d / str(step) / "_CHECKPOINT_METADATA").write_text("{}")
        (d / str(step) / "commit").write_text("{}")
    ckpt = SweepCheckpointer(str(d), keep=1, async_save=False)
    state = _roundtrip_state()
    assert ckpt.latest_step is None and ckpt.restore_or(state)[0] == 0
    for step in (2, 3):
        ckpt.save(step, state)
    ckpt.close()
    assert sorted(os.listdir(d)) == ["1", "3", "9"]
    assert sorted(os.listdir(d / "9")) == ["_CHECKPOINT_METADATA", "commit"]
    assert ckpt.latest_step == 3 and read_step(str(d))[0] == 3
    with pytest.raises(ValueError, match="not a SweepCheckpointer's"):
        ckpt.save(9, state)


def _jax_kept(directory, saves: int, keep, async_save: bool = True) -> list[int]:
    """The steps the JAX package's checkpointer (orbax's ``max_to_keep``)
    leaves after saves 1..``saves`` and a close."""
    ckpt = JSweepCheckpointer(str(directory), keep=keep, async_save=async_save)
    for step in range(1, saves + 1):
        ckpt.save(step, {"x": jnp.arange(4.0) + step})
    ckpt.close()
    return sorted(int(p) for p in os.listdir(directory) if p.isdigit())


def _assert_bitwise(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("async_save", [True, False])
@pytest.mark.parametrize("keep", [1, 2, 3, 4])
@pytest.mark.parametrize("saves", [1, 2, 3, 5, 8])
def test_checkpoint_keeps_what_jax_keeps(tmp_path, saves, keep, async_save):
    """After ``close()`` the ``min(keep, saves)`` newest steps are left,
    each whole and committed, as the JAX package's checkpointer leaves
    them, and nothing else; the newest reads back bitwise."""
    d = tmp_path / "ck"
    ckpt = SweepCheckpointer(str(d), keep=keep, async_save=async_save)
    state = _roundtrip_state()
    for step in range(1, saves + 1):
        state = dict(state, env_pos=state["env_pos"] + 1.5, tick=state["tick"] + 1)
        ckpt.save(step, state)
    ckpt.close()
    want = _jax_kept(tmp_path / "jax", saves, keep, async_save)
    assert want == list(range(saves - min(keep, saves) + 1, saves + 1))
    assert sorted(os.listdir(d), key=int) == [str(s) for s in want]
    for s in want:
        assert sorted(os.listdir(d / str(s))) == ["commit", "rank0-of-1.pt"]
    step, files = read_step(str(d))
    assert step == saves == ckpt.latest_step
    _assert_bitwise(files[0], tree.flatten(state))


def test_checkpoint_keep_none_keeps_every_step(tmp_path):
    ckpt = SweepCheckpointer(str(tmp_path / "ck"), keep=None)
    for step in range(1, 6):
        ckpt.save(step, _roundtrip_state())
    ckpt.close()
    assert sorted(os.listdir(tmp_path / "ck"), key=int) == ["1", "2", "3", "4", "5"]
    assert _jax_kept(tmp_path / "jax", 5, None) == [1, 2, 3, 4, 5]


def test_checkpoint_refuses_keep_below_one(tmp_path):
    """orbax's ``max_to_keep`` is None or a positive count."""
    with pytest.raises(ValueError, match="at least 1, not 0"):
        SweepCheckpointer(str(tmp_path / "ck"), keep=0)


def test_checkpoint_two_ranks_keeps_what_jax_keeps(ranks, tmp_path):
    """Two gloo ranks, ``keep=3``, 5 async saves: the steps JAX keeps, each
    with both ranks' files and its commit marker; each rank's rows of the
    newest read back bitwise."""
    want = _jax_kept(tmp_path, SAVES, KEEP)
    assert want == [3, 4, 5]
    for res in ranks:
        assert res["keep_files"] == {s: ["commit", "rank0-of-2.pt", "rank1-of-2.pt"]
                                     for s in want}
        assert res["keep_newest"] == SAVES and int(res["keep_tick"]) == SAVES
        _assert_bitwise({"U": res["keep_U"]}, {"U": res["U_admm"] + SAVES})


def _parallel_traced() -> dict:
    snap = profiling.snapshot()
    return {"spans": {k: c for k, c in snap["spans"].items() if k.startswith(TRACED)},
            "counters": {k: v for k, v in snap["counters"].items() if k.startswith(TRACED)}}


def _save_three(directory) -> None:
    """3 async saves at ``keep=2`` and a close: the close prunes step 1."""
    ckpt = SweepCheckpointer(str(directory), keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, _roundtrip_state())
    ckpt.close()


def test_checkpoint_and_reductions_trace_one_process(tmp_path):
    """One process: ``ckpt.save`` with its three children each save,
    ``ckpt.join`` and ``ckpt.prune`` once more from ``close()`` with no
    parent, every sample outside a loop (-1); the counters; no
    ``mesh.reduce`` without a group; nothing at all when disabled."""
    profiling.reset()
    try:
        mesh = launch.global_data_mesh("cpu")
        assert float(mesh_lib.global_mean(torch.arange(4.0), mesh)) == 1.5
        _save_three(tmp_path / "on")
        got = _parallel_traced()
        spans = got["spans"]
        assert set(spans) == {"ckpt.save", "ckpt.copy", "ckpt.join", "ckpt.prune"}
        assert spans["ckpt.save"]["parent"] == [None] * 3
        assert spans["ckpt.copy"]["parent"] == ["ckpt.save"] * 3
        for name in ("ckpt.join", "ckpt.prune"):
            assert spans[name]["parent"] == ["ckpt.save"] * 3 + [None]
        for c in spans.values():
            assert (c["loop"] == -1).all() and (c["tick"] == -1).all()
            assert np.isnan(c["device_ms"]).all() and (c["host_ns"] > 0).all()
        saves = spans["ckpt.save"]
        children = sum(spans[n]["host_ns"][:3] for n in ("ckpt.copy", "ckpt.join", "ckpt.prune"))
        assert (saves["host_ns"] - saves["self_ns"] == children).all()
        counters = got["counters"]
        assert counters.pop("ckpt.write_ns") > 0
        assert counters == {"ckpt.saves": 3, "ckpt.pruned": 1}
        assert sorted(os.listdir(tmp_path / "on")) == ["2", "3"]

        profiling.reset()
        profiling.set_enabled(False)
        mesh_lib.global_mean(torch.arange(4.0), mesh)
        _save_three(tmp_path / "off")
        assert _parallel_traced() == {"spans": {}, "counters": {}}
        assert sorted(os.listdir(tmp_path / "off")) == ["2", "3"]
    finally:
        profiling.set_enabled(True)
        profiling.reset()


def test_checkpoint_spans_reach_the_profiler(tmp_path):
    """Outside a loop's tick a span checks for a profiler itself, so the
    save's spans are host events of its trace (level 2)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _save_three(tmp_path / "ck")
    names = {e.name for e in prof.events()}
    assert {"ckpt.save", "ckpt.copy", "ckpt.join", "ckpt.prune"} <= names


def test_two_ranks_trace_join_reduce_and_save(ranks):
    """Two gloo ranks: ``launch.join`` once; one ``global_mean`` is one
    ``mesh.reduce`` of one float64; 5 saves and a close as in one process,
    rank 0 alone pruning (steps 1 and 2); nothing when disabled."""
    for r, res in enumerate(ranks):
        assert res["join_traced"] == {"spans": {"launch.join": [None]}, "counters": {}}
        spans, counters = res["keep_traced"]["spans"], dict(res["keep_traced"]["counters"])
        assert spans["mesh.reduce"] == [None]
        assert spans["ckpt.save"] == [None] * SAVES
        assert spans["ckpt.copy"] == ["ckpt.save"] * SAVES
        assert spans["ckpt.join"] == spans["ckpt.prune"] == ["ckpt.save"] * SAVES + [None]
        assert counters.pop("ckpt.write_ns") > 0
        assert counters == {"mesh.collectives": 1, "mesh.reduce_bytes": 8, "ckpt.saves": SAVES,
                            **({"ckpt.pruned": 2} if r == 0 else {})}
        assert res["keep_off_traced"] == {"spans": {}, "counters": {}}


# ---------------------------------------------------------------------------
# (e) the entry point: kill and resume, and a sharded estimator sweep
# ---------------------------------------------------------------------------

SWEEP_ARGS = ["--device", "cpu", "--batch", "4", "--seconds", "0.3", "--chunk-ticks", "100"]


def run_sweep(ckpt_dir, extra=(), nprocs=1):
    """The entry point as ``nprocs`` processes (torch's launcher variables
    when more than one); returns rank 0's output."""
    cmd = [sys.executable, "-m", "pympc_quadruped_tpu_torch.examples.sweep",
           "--ckpt-dir", str(ckpt_dir), *SWEEP_ARGS, *extra]
    port = launch.free_port() if nprocs > 1 else None
    return launch.run_ranks([(cmd, launch.launcher_env(port, r, nprocs)) for r in range(nprocs)],
                            timeout=600)[0]


def restore_latest(ckpt_dir):
    """The newest committed step and its leaves, each rank's rows
    concatenated (0-d leaves from rank 0, after checking the ranks agree)."""
    step, parts = read_step(ckpt_dir)
    flat = {}
    for k, v in parts[0].items():
        if v.dim() == 0:
            assert all(torch.equal(p[k], v) for p in parts), k
            flat[k] = v
        else:
            flat[k] = torch.cat([p[k] for p in parts])
    return step, flat


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume")
    out_a = run_sweep(d / "straight")                                 # 3 chunks
    out_b1 = run_sweep(d / "resumed", ["--stop-after-chunks", "1"])   # stopped after 1
    out_b2 = run_sweep(d / "resumed")                                 # a fresh process resumes
    return d, out_a, out_b1, out_b2


def test_kill_resume_bitwise(resumed_runs):
    d, out_a, out_b1, out_b2 = resumed_runs
    assert "chunks=3/3" in out_a and "chunks=1/3" in out_b1
    assert "resuming at chunk 1 (tick 100)" in out_b2 and "chunks=3/3" in out_b2
    step_a, flat_a = restore_latest(d / "straight")
    step_b, flat_b = restore_latest(d / "resumed")
    assert step_a == step_b == 3
    assert set(flat_a) == set(flat_b)
    assert int(flat_a["tick"]) == 300
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k


def test_resume_threads_state_not_restarts(resumed_runs):
    """The resumed chunks continue from the walked-forward state: the final
    x displacement is ~3 chunks of travel, not one chunk from the origin."""
    d = resumed_runs[0]
    _, flat = restore_latest(d / "resumed")
    x = flat["env/pos"][:, 0]
    assert float(x.mean()) > 0.12, x


def test_sharded_estimator_sweep_matches_unsharded(tmp_path):
    """An estimator sweep over two ranks ends bitwise where the one-process
    run ends: each rank's sensor noise is its rows' noise in the global
    batch, and its randomized robots are its rows of the global draw."""
    extra = ["--estimator", "--seconds", "0.2"]
    out2 = run_sweep(tmp_path / "two", extra, nprocs=2)
    out1 = run_sweep(tmp_path / "one", extra)
    assert "devices=2 hosts=2 batch=4 rank=0 backend=gloo" in out2
    _, flat2 = restore_latest(tmp_path / "two")
    _, flat1 = restore_latest(tmp_path / "one")
    assert set(flat1) == set(flat2) and int(flat1["tick"]) == 200
    for k in flat1:
        assert torch.equal(flat1[k], flat2[k]), k
    # Both print the same global per-chunk summaries.
    tail = lambda out: [l for l in out.splitlines() if l.startswith("  ")]
    assert tail(out2) == tail(out1) and any("mean_est_vel_err" in l for l in tail(out1))

"""The traffic generator: a seed fixes the inputs."""
import numpy as np
import pytest

from benchmark.harness import manifest
from benchmark.traffic import generator

MIXES = ["trot16-jitter", "mixgait10-jitter"]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    mix = manifest.load_json("traffic", name)
    a, b = generator.draw(mix, 64, 2**40 + 3), generator.draw(mix, 64, 2**40 + 3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_inputs(name):
    mix = manifest.load_json("traffic", name)
    a, b = generator.draw(mix, 64, 5), generator.draw(mix, 64, 6)
    assert not np.array_equal(a["dpos"], b["dpos"])


@pytest.mark.parametrize("name", MIXES)
def test_draws_within_the_mix(name):
    mix = manifest.load_json("traffic", name)
    d = generator.draw(mix, 300, 2**33 + 11)
    lo, hi = mix["speed"]
    assert (d["vx"] >= np.float32(lo)).all() and (d["vx"] <= np.float32(hi)).all()
    assert set(d["gait_id"]) <= set(range(len(mix["gait_mix"])))
    if len(mix["gait_mix"]) > 1:
        assert len(set(d["gait_id"])) == len(mix["gait_mix"])
    assert (~d["dpos"].any(-1)).sum() == 1
    assert abs(d["dpos"][1:, :2]).max() <= mix["init"]["pos_xy"]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_runs_the_same_robots(name):
    mix = manifest.load_json("traffic", name)
    a, b = generator.draw(mix, 128, 7), generator.draw(mix, 128, 2**40 + 9)
    for k in a:
        key = lambda d: sorted(map(tuple, np.asarray(d[k]).reshape(128, -1).tolist()))
        assert key(a) == key(b)


def test_sweep_mix_draws_the_global_pool():
    """The sweep's mix: each gait at its own speed (``GAIT_SWEEP_VX``), mass
    and inertia log-uniform in exp(+-0.2), and a global pool of which rank
    r keeps rows [n r, n (r + 1)): the ranks' rows together are the pool."""
    mix = manifest.load_json("traffic", "sweep3-dr")
    d = generator.draw(mix, 64, 2**40 + 21)
    names = mix["gait_mix"]
    assert set(d["gait_id"]) == set(range(len(names)))
    for i, name in enumerate(names):
        assert (d["vx"][d["gait_id"] == i] == np.float32(mix["speed_by_gait"][name])).all()
        assert (d["num_segments"][d["gait_id"] == i] == mix["gaits"][name]["num_segments"]).all()
    s = mix["mass_inertia_log_spread"]
    for k in ("mass_f", "inertia_f"):
        assert (np.abs(np.log(d[k])) <= s + 1e-6).all() and d[k].std() > 0.05
    rows = [{k: v[16 * r:16 * (r + 1)] for k, v in d.items()} for r in range(4)]
    for k in d:
        np.testing.assert_array_equal(np.concatenate([r[k] for r in rows]), d[k])

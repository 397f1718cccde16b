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

"""The benchmark's traffic generator: failure schedules with the stated
counts, the checked failures by kind, token batches from the seed."""
import numpy as np
import pytest

from perfbench.tests import _tiny  # noqa: F401  (paths)
from perfbench.lib import traffic as TF

BIG = 2 ** 31 + 987654321


def test_cadence_one_failure_every_period():
    churn = {"pattern": "cadence", "period": 16, "offset": 8,
             "stages": "interior"}
    assert TF.failure_walls(churn, 96) == [8, 24, 40, 56, 72, 88]
    sched = TF.churn_schedule(churn, 6, 96, BIG)
    assert len(sched) == 6
    assert all(len(sched.at(w)) == 1 for w in (8, 24, 40, 56, 72, 88))
    assert all(1 <= s <= 4 for s in sched.stages())
    assert sched.at(0) == [] and sched.at(9) == []


def test_burst_four_consecutive_every_32():
    churn = {"pattern": "burst", "period": 32, "offset": 16, "burst": 4,
             "stages": "all"}
    walls = TF.failure_walls(churn, 96)
    assert walls == [16, 17, 18, 19, 48, 49, 50, 51, 80, 81, 82, 83]
    sched = TF.churn_schedule(churn, 8, 96, BIG)
    # one stage a step: no two stages, adjacent or not, fail together
    assert all(len(sched.at(w)) == 1 for w in walls)
    assert len(sched) == 12 and set(sched.stages()) <= set(range(8))


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_every_seed_loses_the_same_stages(seed):
    churn = {"pattern": "cadence", "period": 16, "offset": 8,
             "stages": "all"}
    stages = TF.churn_schedule(churn, 8, 8 * 16, seed).stages()
    assert sorted(stages) == list(range(8))


def test_the_count_does_not_depend_on_the_seed():
    churn = {"pattern": "burst", "period": 32, "offset": 16, "burst": 4,
             "stages": "all"}
    counts = {len(TF.churn_schedule(churn, 8, 96, s)) for s in range(20)}
    assert counts == {12}


def test_checked_failures_by_kind():
    for seed in range(30):
        sched = TF.check_schedule([[1, "edge"], [2, "interior"]], 8, seed)
        (edge,), (interior,) = sched.at(1), sched.at(2)
        assert edge in (0, 7) and 1 <= interior <= 6
        sched = TF.check_schedule([[1, "interior"], [2, "interior"]], 6,
                                  seed)
        a, b = sched.at(1)[0], sched.at(2)[0]
        assert a != b and {a, b} <= {1, 2, 3, 4}


def test_tokens_follow_the_seed_and_every_row_differs():
    a = TF.TokenStream(1000, 4, 64, BIG)
    b = TF.TokenStream(1000, 4, 64, BIG)
    c = TF.TokenStream(1000, 4, 64, BIG + 1)
    for i in range(3):
        np.testing.assert_array_equal(a.batch_at(i)["tokens"],
                                      b.batch_at(i)["tokens"])
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              c.batch_at(0)["tokens"])
    rows = np.concatenate([a.batch_at(i)["tokens"] for i in range(3)])
    assert len({r.tobytes() for r in rows}) == len(rows)
    batch = a.batch_at(0)
    assert batch["tokens"].dtype == np.int32
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])
    assert batch["tokens"].max() < 1000


def test_the_stream_refuses_a_batch_beyond_its_run():
    it = TF.iterate(TF.TokenStream(50, 1, 4, 1), 5, 2)
    next(it), next(it)
    with pytest.raises(RuntimeError):
        next(it)

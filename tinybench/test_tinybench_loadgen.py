"""The traffic and the end-to-end statistics: all work over all time, the
tail over all queries."""

import importlib

import numpy as np
import pytest

from tinybench import layout, loadgen


class FakeClock:
    """Host nanoseconds that move only when a call says so."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


def _run(durations_ms, rows=4, seconds=1.0):
    clock = FakeClock()
    pool = np.zeros((64, 2), np.int8)
    it = iter(durations_ms)

    def call(x):
        clock.t += int(next(it) * 1e6)
        return x

    return loadgen.closed_loop(call, lambda y: np.asarray(y), pool, rows,
                               seconds, clock=clock)


def test_the_rate_is_all_work_over_all_time():
    rec = _run([10.0] * 200)
    # 100 calls of 4 rows fill the second: 400 inferences a second
    assert rec.calls == 100 and rec.elapsed_s == pytest.approx(1.0)
    offline = layout.scenario("offline")
    assert offline.metrics(rec)["offline_qps"]["value"] == pytest.approx(400)


def test_a_stalled_call_lowers_the_rate_though_the_median_call_stays():
    steady = _run([10.0] * 200)
    stalled = _run([10.0] * 10 + [300.0] + [10.0] * 200)
    offline = layout.scenario("offline")
    q0 = offline.metrics(steady)["offline_qps"]["value"]
    q1 = offline.metrics(stalled)["offline_qps"]["value"]
    assert np.median(stalled.latencies_s()) == np.median(
        steady.latencies_s())
    assert q1 < 0.75 * q0


def test_p90_is_over_all_queries():
    # 100 queries: 89 of 1 ms and 11 of 5 ms; a median over chunks of ten
    # would read 1 ms, the 90th percentile of all queries is 5 ms
    rec = _run([1.0] * 89 + [5.0] * 11, rows=1, seconds=0.144)
    assert rec.calls == 100
    single = layout.scenario("singlestream")
    p90 = single.metrics(rec)["singlestream_p90_ms"]["value"]
    assert p90 == pytest.approx(5.0)
    assert loadgen.nearest_rank(list(range(1, 11)), 0.9) == 9
    assert loadgen.nearest_rank([3.0], 0.9) == 3.0


def test_the_loop_walks_the_pool_in_consecutive_slices():
    rec = _run([1.0] * 40, rows=16, seconds=0.0055)
    assert rec.first == [0, 16, 32, 48, 0, 16]
    with pytest.raises(ValueError):
        _run([1.0], rows=5)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40])
def test_the_pool_is_a_function_of_the_seed(seed):
    a = loadgen.make_pool(seed, 32, (4, 4, 3))
    b = loadgen.make_pool(seed, 32, (4, 4, 3))
    assert a.dtype == np.int8 and a.shape == (32, 4, 4, 3)
    assert np.array_equal(a, b)
    assert a.min() >= -127 and a.max() <= 127
    assert not np.array_equal(a, loadgen.make_pool(seed + 1, 32, (4, 4, 3)))


def test_the_scenarios_are_modules_of_their_own():
    for name in layout.names("scenarios", ".py"):
        if name == "__init__":
            continue
        mod = layout.scenario(name)
        assert callable(mod.metrics) and callable(mod.describe)
    assert importlib.util.find_spec("tinybench.loadgen") is not None

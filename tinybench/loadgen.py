"""The one traffic generator: a seeded sample pool and a closed loop.

As MLPerf's LoadGen holds its sample library, the pool is
``pool_samples`` int8 input codes in [-127, 127] in host memory (numpy),
drawn from the seed. The loop is one caller: it hands ``rows_per_call``
consecutive samples to the system, waits for their logits on the host,
and sends the next call at once, until the window's deadline. A mix file
(``traffic/<mix>.json``) sets the rows a call, the pool and the sample
sizes; the scenario (``scenarios/<name>.py``) reduces the loop's records
to its end-to-end metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

#: Seed stream of the pool, apart from the weights' (``graphs/``).
POOL_STREAM = 1


def make_pool(seed: int, samples: int, shape: Sequence[int]) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        POOL_STREAM]))
    return rng.integers(-127, 128, (int(samples), *shape), dtype=np.int8)


@dataclasses.dataclass
class Records:
    """What one closed loop did: per call, the pool index of its first
    row; when it was sent, when the system's call returned and when the
    logits were on the host, in host-clock nanoseconds; the logits."""

    rows_per_call: int
    start_ns: int
    first: List[int] = dataclasses.field(default_factory=list)
    sent_ns: List[int] = dataclasses.field(default_factory=list)
    return_ns: List[int] = dataclasses.field(default_factory=list)
    done_ns: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.done_ns)

    @property
    def rows(self) -> int:
        return self.calls * self.rows_per_call

    @property
    def elapsed_s(self) -> float:
        """From the window's start to the last logits on the host."""
        if not self.done_ns:
            return 0.0
        return (self.done_ns[-1] - self.start_ns) / 1e9

    def latencies_s(self) -> np.ndarray:
        return (np.asarray(self.done_ns, np.int64)
                - np.asarray(self.sent_ns, np.int64)) / 1e9

    def parts(self, n: int = 5) -> List[np.ndarray]:
        """The calls' indices in each n-th of the window, by sending time
        (to see whether a run drifts)."""
        t = np.asarray(self.sent_ns, np.int64) - self.start_ns
        span = max(int(self.done_ns[-1] - self.start_ns), 1)
        return [np.flatnonzero((t * n) // span == k) for k in range(n)]


def _no_span(name: str):
    return contextlib.nullcontext()


def closed_loop(call: Callable, fetch: Callable, pool: np.ndarray,
                rows: int, seconds: float, first: int = 0,
                clock: Callable[[], int] = time.perf_counter_ns,
                span: Callable = _no_span,
                max_calls: Optional[int] = None) -> Records:
    """Send calls of ``rows`` consecutive pool samples, each after the
    last one's logits reached the host, until ``seconds`` have passed
    (or ``max_calls`` calls); ``call`` is the system's entry, ``fetch``
    brings its output to the host. Python's garbage collector is off
    while the loop runs, so that the loop's own bookkeeping does not
    pause the system under test."""
    n = pool.shape[0]
    if n % rows:
        raise ValueError(f"a pool of {n} samples does not split into "
                         f"calls of {rows} rows")
    collecting = gc.isenabled()
    gc.disable()
    try:
        return _loop(call, fetch, pool, rows, seconds, first, clock, span,
                     max_calls)
    finally:
        if collecting:
            gc.enable()


def _loop(call, fetch, pool, rows, seconds, first, clock, span, max_calls):
    n = pool.shape[0]
    rec = Records(rows_per_call=rows, start_ns=clock())
    deadline = rec.start_ns + int(seconds * 1e9)
    lo = (first * rows) % n
    while True:
        t0 = clock()
        if t0 >= deadline or (max_calls is not None
                              and rec.calls >= max_calls):
            break
        with span("loadgen"):
            x = pool[lo:lo + rows]
        with span("call"):
            y = call(x)
        t1 = clock()
        with span("copy_out"):
            h = fetch(y)
        t2 = clock()
        rec.first.append(lo)
        rec.sent_ns.append(t0)
        rec.return_ns.append(t1)
        rec.done_ns.append(t2)
        rec.logits.append(h)
        lo = (lo + rows) % n
    return rec


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank over all values: the
    smallest value that at least a share q of them do not exceed."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        raise ValueError("no values")
    return float(v[max(0, math.ceil(q * v.size) - 1)])

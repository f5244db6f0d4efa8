"""Injectable clocks for the serve runtime.

The port of ``repro.serve.clock``. Every serve component reads time
through one of these objects, so the whole server — batching deadlines,
SLO estimates, sliding-window metrics, trace replay — runs identically
under the real clock and under a test-controlled manual clock.
``SystemClock`` reads and sleeps through ``repro_torch.obs.timer``, the
one timer the port reads (a test that installs a fake timer controls a
``SystemClock`` router too); ``ManualClock`` is the reference's.
"""

from __future__ import annotations

from repro_torch.obs import timer as obs_timer


class SystemClock:
    """The real monotonic clock, read through ``obs.timer``."""

    def now(self) -> float:
        return obs_timer.now()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            obs_timer.sleep(seconds)


class ManualClock:
    """Deterministic clock: time moves only when told to.

    ``sleep`` advances instead of blocking, so trace replay under a
    ManualClock is an exact discrete-event simulation — every latency the
    metrics report is reproducible arithmetic, not wall-clock noise.
    """

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        # typed, not a bare assert: sleeping a negative duration would
        # silently run time backwards under ``python -O``
        if seconds < 0:
            raise ValueError(f"cannot sleep a negative duration: {seconds}")
        self.t += seconds

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot advance time backwards: {seconds}")
        self.t += seconds

"""The one injectable timer every measurement in ``src/repro_torch`` reads.

A copy of ``repro.obs.timer``. Everything in the port times itself through
``obs.timer.now()`` (``tests/test_torch_port_rules.py`` checks that no other
module of the port calls the ``time`` module's clock), and a test swaps the
process-wide timer for a manual clock:

    from repro_torch.obs import timer
    with timer.fake(manual_clock) as clock:
        ...            # every now()/sleep() in repro_torch reads the fake

Device work is asynchronous: a caller that times CUDA work synchronises
before it reads ``now()`` again.

``now()`` is a monotonic high-resolution stamp for measuring durations;
``walltime()`` is the epoch stamp for provenance metadata (checkpoint
manifests, bench artifacts) — the two must never be mixed.
"""

from __future__ import annotations

import contextlib
import time as _time
from typing import Iterator, Optional


class PerfTimer:
    """The real timer: ``perf_counter`` durations, real sleeps."""

    def now(self) -> float:
        return _time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)

    def walltime(self) -> float:
        return _time.time()


_TIMER: object = PerfTimer()


def get_timer() -> object:
    return _TIMER


def set_timer(timer: Optional[object]) -> object:
    """Install a timer object (``now()``/``sleep()``); returns the previous
    one so callers can restore it. ``None`` restores the real timer."""
    global _TIMER
    old = _TIMER
    _TIMER = timer if timer is not None else PerfTimer()
    return old


@contextlib.contextmanager
def fake(timer: object) -> Iterator[object]:
    """Scoped timer swap: install ``timer`` for the block, restore after.
    The fixture-shaped entry point for deterministic-clock tests."""
    old = set_timer(timer)
    try:
        yield timer
    finally:
        set_timer(old)


def now() -> float:
    """Monotonic seconds from the installed timer (durations only)."""
    return _TIMER.now()


def sleep(seconds: float) -> None:
    _TIMER.sleep(seconds)


def walltime() -> float:
    """Epoch seconds (provenance stamps). Falls back to the real clock when
    the installed timer has no ``walltime`` (manual clocks measure
    durations, not dates)."""
    wt = getattr(_TIMER, "walltime", None)
    return wt() if wt is not None else _time.time()

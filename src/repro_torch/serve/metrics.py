"""Sliding-window serving metrics: latency percentiles, throughput, shed
rate, and the batch-occupancy histogram.

A copy of ``repro.serve.metrics``: the arithmetic stays in Python floats
and numpy float64, so ``MetricsSnapshot.row()`` equals the reference's.

The router records three event kinds — admissions/sheds, wave dispatches,
and request completions — against an injectable clock. ``snapshot`` prunes
everything older than the window and reports the numbers the SLO story is
judged on: p50/p90/p99 latency, completion throughput, the fraction of
offered load that was shed, and how full the dispatched waves were (the
dynamic batcher's efficiency: occupancy 1.0 means every wave left full,
low occupancy means deadline flushes dominate).

All accounting is exact arithmetic over recorded timestamps — under a
``ManualClock`` every reported percentile is reproducible to the bit,
which is what the hand-simulated-trace tests check.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MetricsSnapshot:
    """One window's worth of serving numbers (latencies in ms)."""

    window_s: float
    n_completed: int
    n_shed: int
    n_admitted: int
    p50_ms: float
    p90_ms: float
    p99_ms: float
    throughput_qps: float
    shed_rate: float
    n_waves: int
    mean_occupancy: float                 # mean n_valid / micro_batch
    occupancy_hist: Dict[int, int]        # n_valid -> wave count
    #: median measured wave service time (submit -> completion) across the
    #: window's waves; 0.0 when no wave carried a measurement. The number
    #: the lane's EWMA placement estimate converges to.
    wave_service_p50_ms: float = 0.0
    #: fault kind -> count in the window (retried timeouts, integrity
    #: violations, crashed submissions...) — the chaos observability story
    fault_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: shed reason -> count ("slo" admission sheds, "no_replica",
    #: "retries_exhausted")
    shed_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict[str, object]:
        return {
            "completed": self.n_completed, "shed": self.n_shed,
            "p50_ms": round(self.p50_ms, 4), "p90_ms": round(self.p90_ms, 4),
            "p99_ms": round(self.p99_ms, 4),
            "qps": round(self.throughput_qps, 1),
            "shed_rate": round(self.shed_rate, 4),
            "waves": self.n_waves,
            "occupancy": round(self.mean_occupancy, 3),
            "wave_service_p50_ms": round(self.wave_service_p50_ms, 4),
            "faults": dict(self.fault_counts),
            "shed_reasons": dict(self.shed_reasons),
        }


class ServeMetrics:
    """Event recorder with a time-based sliding window."""

    def __init__(self, window_s: float = 30.0, start_t: float = 0.0):
        self.window_s = float(window_s)
        self.start_t = float(start_t)
        #: timestamp of the first recorded event of any kind — the
        #: throughput window opens here, not at recorder creation (a
        #: recorder idling long before traffic must not dilute qps)
        self.first_event_t: Optional[float] = None
        self._completions: Deque[Tuple[float, float]] = collections.deque()
        self._admits: Deque[float] = collections.deque()
        self._sheds: Deque[Tuple[float, str]] = collections.deque()
        #: (t, kind) per observed fault event (timeout, integrity, ...)
        self._faults: Deque[Tuple[float, str]] = collections.deque()
        #: (t, n_valid, micro_batch, service_s or None) per dispatched wave
        self._waves: Deque[Tuple[float, int, int, Optional[float]]] = \
            collections.deque()

    def _mark(self, now: float) -> None:
        if self.first_event_t is None:
            self.first_event_t = float(now)

    # -- event recorders ---------------------------------------------------
    def record_admit(self, now: float) -> None:
        self._mark(now)
        self._admits.append(now)

    def record_shed(self, now: float, reason: str = "slo") -> None:
        """One rejected request; ``reason`` distinguishes admission sheds
        ("slo", the default every legacy caller gets) from failure-path
        sheds ("no_replica", "retries_exhausted")."""
        self._mark(now)
        self._sheds.append((now, str(reason)))

    def record_fault(self, now: float, kind: str) -> None:
        """One observed fault event (a wave timeout, a corrupt output, a
        crashed/failed submission) — counted per kind in the window.
        Faults are *not* sheds: a retried wave that eventually lands shows
        up here but never in the shed rate."""
        self._mark(now)
        self._faults.append((now, str(kind)))

    def record_completion(self, now: float, latency_s: float) -> None:
        self._mark(now)
        self._completions.append((now, latency_s))

    def record_wave(self, now: float, n_valid: int, micro_batch: int,
                    service_s: Optional[float] = None) -> None:
        """One dispatched wave; ``service_s`` is its measured submit ->
        completion time when the caller settles completions (the router's
        completion callback does; legacy callers may omit it)."""
        self._mark(now)
        self._waves.append((now, int(n_valid), int(micro_batch),
                            None if service_s is None else float(service_s)))

    # -- window accounting -------------------------------------------------
    def _prune(self, now: float) -> None:
        """Drop events strictly older than ``now - window_s``.

        The boundary is **inclusive**: an event stamped *exactly* at
        ``now - window_s`` stays in the window (the comparison is ``<``,
        not ``<=``). Under a manual clock events routinely land exactly on
        window edges, so the tie direction is part of the contract the
        exact-accounting tests rely on — don't flip it.
        """
        cutoff = now - self.window_s
        while self._completions and self._completions[0][0] < cutoff:
            self._completions.popleft()
        while self._admits and self._admits[0] < cutoff:
            self._admits.popleft()
        while self._sheds and self._sheds[0][0] < cutoff:
            self._sheds.popleft()
        while self._faults and self._faults[0][0] < cutoff:
            self._faults.popleft()
        while self._waves and self._waves[0][0] < cutoff:
            self._waves.popleft()

    def snapshot(self, now: float) -> MetricsSnapshot:
        self._prune(now)
        lats = np.asarray([l for _, l in self._completions]) * 1e3
        if lats.size:
            p50, p90, p99 = (float(np.percentile(lats, q))
                             for q in (50, 90, 99))
        else:
            p50 = p90 = p99 = 0.0
        # the throughput window only opens as far back as traffic has
        # existed: the denominator starts at the FIRST recorded event, not
        # at recorder creation. A server that came up long before its
        # first request (or spent its cold start shedding everything —
        # sheds mark the window open too, since shedding time is serving
        # time) used to have ``span`` pinned at the recorder lifetime,
        # diluting qps once completions finally arrived.
        opened = self.first_event_t if self.first_event_t is not None else now
        span = max(min(now - opened, self.window_s), 1e-9)
        offered = len(self._admits) + len(self._sheds)
        hist: Dict[int, int] = {}
        occ = 0.0
        services = []
        for _, n_valid, mb, service_s in self._waves:
            hist[n_valid] = hist.get(n_valid, 0) + 1
            occ += n_valid / max(mb, 1)
            if service_s is not None:
                services.append(service_s)
        wave_p50 = (float(np.percentile(np.asarray(services) * 1e3, 50))
                    if services else 0.0)
        faults: Dict[str, int] = {}
        for _, kind in self._faults:
            faults[kind] = faults.get(kind, 0) + 1
        reasons: Dict[str, int] = {}
        for _, reason in self._sheds:
            reasons[reason] = reasons.get(reason, 0) + 1
        return MetricsSnapshot(
            window_s=self.window_s,
            n_completed=len(self._completions),
            n_shed=len(self._sheds),
            n_admitted=len(self._admits),
            p50_ms=p50, p90_ms=p90, p99_ms=p99,
            throughput_qps=len(self._completions) / span,
            shed_rate=len(self._sheds) / offered if offered else 0.0,
            n_waves=len(self._waves),
            mean_occupancy=occ / len(self._waves) if self._waves else 0.0,
            occupancy_hist=hist,
            wave_service_p50_ms=wave_p50,
            fault_counts=faults,
            shed_reasons=reasons,
        )

"""Traffic-trace generators for the serve runtime.

A copy of ``repro.serve.traffic`` (numpy only): the same seeds give the
same arrays.

MLPerf's Server scenario drives submissions with Poisson arrivals; real
fleets see burstier processes. This module generates arrival-time traces
for the router/bench under four regimes:

  * ``poisson_trace``  — memoryless arrivals at a fixed rate (the MLPerf
    Server baseline; what M/D/1 queueing math assumes).
  * ``mmpp_trace``     — Markov-modulated Poisson (bursty): the rate
    switches between states with exponentially distributed dwell times, so
    the trace alternates calm and burst phases. Burstiness is what
    exercises the dynamic batcher's deadline flush and the SLO shedder.
  * ``diurnal_trace``  — inhomogeneous Poisson with a sinusoidal rate ramp
    (the daily load curve squeezed to seconds), generated by Lewis-Shedler
    thinning so the process is exact, not binned.
  * ``replay_trace``   — a recorded trace (any sorted timestamp array),
    so production captures replay through the same machinery.

Every generator is a pure function of its seed: same arguments, same
trace, on any machine — the property the deterministic router tests and
the benchmark's reproducibility both rest on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Trace:
    """An arrival-time trace: sorted seconds from t=0, plus provenance."""

    kind: str
    arrivals: np.ndarray                  # (n,) float64, non-decreasing
    meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        a = np.asarray(self.arrivals, np.float64).reshape(-1)
        if a.size and (np.any(np.diff(a) < 0) or a[0] < 0):
            raise ValueError("trace arrivals must be sorted and >= 0")
        object.__setattr__(self, "arrivals", a)

    @property
    def n(self) -> int:
        return int(self.arrivals.size)

    @property
    def span_s(self) -> float:
        return float(self.arrivals[-1]) if self.n else 0.0

    @property
    def offered_qps(self) -> float:
        return self.n / max(self.span_s, 1e-9)

    def scaled(self, factor: float) -> "Trace":
        """Same arrival pattern at ``factor`` times the rate (timestamps
        divided by factor) — how the bench sweeps offered load fractions
        without changing the randomness."""
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        return Trace(kind=self.kind, arrivals=self.arrivals / factor,
                     meta={**self.meta, "scaled": factor})


def poisson_trace(qps: float, n: int, seed: int = 0) -> Trace:
    """Homogeneous Poisson arrivals: i.i.d. exponential inter-arrivals."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, int(n)))
    return Trace(kind="poisson", arrivals=arrivals,
                 meta={"qps": float(qps), "seed": int(seed)})


def mmpp_trace(qps_states: Sequence[float], dwell_s: float, n: int,
               seed: int = 0) -> Trace:
    """Markov-modulated Poisson: cycle through rate states, exponential
    dwell in each, Poisson arrivals at the state's rate while dwelling.

    With two states (e.g. ``(50, 500)``) this is the classic bursty MMPP-2:
    long quiet stretches punctuated by arrival storms whose *within-burst*
    rate far exceeds the long-run average — the inter-arrival coefficient
    of variation exceeds 1 (Poisson's CV), which is the burstiness signal
    the tests assert.
    """
    rates = [float(q) for q in qps_states]
    if not rates or any(q <= 0 for q in rates):
        raise ValueError(f"qps_states must be positive, got {qps_states}")
    if dwell_s <= 0:
        raise ValueError(f"dwell_s must be > 0, got {dwell_s}")
    rng = np.random.default_rng(seed)
    arrivals = []
    t, state = 0.0, 0
    while len(arrivals) < n:
        dwell = rng.exponential(dwell_s)
        # Poisson arrivals inside [t, t + dwell) at this state's rate
        tt = t + rng.exponential(1.0 / rates[state])
        while tt < t + dwell and len(arrivals) < n:
            arrivals.append(tt)
            tt += rng.exponential(1.0 / rates[state])
        t += dwell
        state = (state + 1) % len(rates)
    return Trace(kind="mmpp", arrivals=np.asarray(arrivals),
                 meta={"qps_states": rates, "dwell_s": float(dwell_s),
                       "seed": int(seed)})


def diurnal_trace(qps_low: float, qps_high: float, period_s: float, n: int,
                  seed: int = 0) -> Trace:
    """Inhomogeneous Poisson with a raised-cosine rate ramp.

    rate(t) = low + (high - low) * (1 - cos(2*pi*t/period)) / 2 — starts at
    the trough, peaks mid-period. Exact via Lewis-Shedler thinning: draw
    candidates at the peak rate, accept each with probability
    rate(t)/peak.
    """
    if not (0 < qps_low <= qps_high):
        raise ValueError(f"need 0 < qps_low <= qps_high, "
                         f"got {qps_low}, {qps_high}")
    if period_s <= 0:
        raise ValueError(f"period_s must be > 0, got {period_s}")
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    while len(arrivals) < n:
        t += rng.exponential(1.0 / qps_high)
        rate = qps_low + (qps_high - qps_low) \
            * (1.0 - np.cos(2.0 * np.pi * t / period_s)) / 2.0
        if rng.uniform() * qps_high < rate:
            arrivals.append(t)
    return Trace(kind="diurnal", arrivals=np.asarray(arrivals),
                 meta={"qps_low": float(qps_low), "qps_high": float(qps_high),
                       "period_s": float(period_s), "seed": int(seed)})


def replay_trace(arrivals: Sequence[float], kind: str = "replay",
                 meta: Optional[Dict] = None) -> Trace:
    """Wrap a recorded timestamp array (normalized to start at t=0)."""
    a = np.sort(np.asarray(arrivals, np.float64).reshape(-1))
    if a.size:
        a = a - a[0]
    return Trace(kind=kind, arrivals=a, meta=dict(meta or {}))


#: Generator registry (bench/CLI lookup by name).
GENERATORS = {
    "poisson": poisson_trace,
    "mmpp": mmpp_trace,
    "diurnal": diurnal_trace,
}

"""Scripted replica simulator: exact discrete-event fakes for the router.

The port of ``repro.serve.sim``, the same fakes: a router test runs the
same script through the reference and the port.

``ScriptedWaveModel`` speaks the executor's ``submit_wave_async``
protocol against a ``ManualClock``: submitting a wave *schedules* its
completion (``ready_t = max(now, busy_until) + service_s``) without
advancing the clock, the way a real device runs a wave in the background
(a CUDA stream). Each instance serializes its own waves (one device,
one pipeline); instances built by a pool factory are independent,
so waves on different replicas overlap and an N-replica pool behaves as N
parallel servers with deterministic, hand-checkable timing.

Fault injection rides the same protocol: give the model (or
``scripted_pool``) a ``serve.faults.FaultPlan`` and scheduled faults fire
deterministically at submit time — a crash refuses the wave (and every
wave until the outage ends), a transient error refuses just this one, a
slowdown stretches the service time, a timeout schedules a wave that
never completes (``ready_t = inf`` — the response is lost but the device
itself recovers), and ``corrupt_output`` poisons the payload past the
integrity guard's proven bound. Because the plan is consulted on the
manual clock, a chaos run replays byte-identically.

Three consumers:

  * the router tests — every expected latency is worked out by hand
    against these fakes, not by re-running the router;
  * the deterministic chaos suite;
  * ``repro_torch.bench.serve_bench`` — the replica-scaling sweep anchors
    ``service_s`` to a *measured* wave service time per model family and
    sweeps replica count as a discrete-event simulation (one card is
    measured, so multi-card scaling is not; the simulation isolates the
    router/engine scheduling from the device count).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.serve.faults import (
    FaultPlan,
    ReplicaCrashed,
    TransientSubmitError,
    WaveTimeout,
)
from repro_torch.serve.replica import ReplicaPool


class ScriptedWaveHandle:
    """In-flight wave on the manual clock: knows its completion instant up
    front; ``wait`` advances the clock there (no-op when reaped late). A
    lost wave (``ready_t = inf`` — injected timeout) refuses to block:
    waiting on it would advance the clock to infinity, so ``wait`` raises
    ``WaveTimeout`` instead — the typed fast-fail that keeps even a
    deadline-less blocking drain from hanging."""

    def __init__(self, clock, ready_t: float, y, mask):
        self.clock = clock
        self.ready_t = ready_t
        self.done_t = None
        self._y, self._mask = y, mask

    def wait(self):
        if not math.isfinite(self.ready_t):
            raise WaveTimeout(
                "scripted wave never completes (injected timeout)")
        self.clock.advance(max(self.ready_t - self.clock.now(), 0.0))
        self.done_t = self.ready_t
        return self._y, self._mask


class ScriptedWaveModel:
    """``submit_wave_async`` fake with the executor's padding contract:
    waves complete ``service_s`` after the instance frees up, scheduled on
    (not advancing) the manual clock. ``service_s`` may be a float or a
    callable of the 1-based wave index (heterogeneous service times).
    Outputs identify their input row (sum of codes) so results trace
    back.

    ``plan`` injects faults (``serve.faults.FaultPlan``); specs keyed by
    ``wave=`` count 1-based *submission attempts* on this replica
    (``n_attempts`` — refused submissions included), while ``calls``
    keeps its historical meaning of accepted waves only.
    """

    def __init__(self, clock, service_s: Union[float, Callable] = 0.003,
                 micro_batch: int = 4, plan: Optional[FaultPlan] = None,
                 replica: int = 0):
        self.clock = clock
        self.service_s = service_s
        self.default_micro_batch = micro_batch
        self.plan = plan
        self.replica = int(replica)
        self.calls = []          # (n_valid, micro_batch) per accepted wave
        self.busy_until = 0.0
        self.n_attempts = 0      # submissions offered, accepted or not
        self.crashed_until = -math.inf

    def submit_wave_async(self, x, valid=None, micro_batch=None
                          ) -> ScriptedWaveHandle:
        now = self.clock.now()
        self.n_attempts += 1
        if now < self.crashed_until:
            raise ReplicaCrashed(
                f"replica {self.replica} is down until "
                f"t={self.crashed_until:.6f} (now t={now:.6f})")
        mb = int(micro_batch or self.default_micro_batch)
        x = np.asarray(x)
        n = x.shape[0]
        if n > mb:
            raise ValueError(f"wave of {n} rows exceeds micro_batch={mb}")
        mask = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        mask = np.concatenate([mask, np.zeros(mb - n, bool)])
        s = self.service_s(len(self.calls) + 1) if callable(self.service_s) \
            else self.service_s
        lost = corrupt = False
        if self.plan is not None:
            for f in self.plan.active(self.replica, self.n_attempts, now):
                if f.kind == "replica_crash":
                    self.crashed_until = now + f.duration_s
                    raise ReplicaCrashed(
                        f"replica {self.replica} crashed at t={now:.6f} "
                        f"(outage {f.duration_s}s)")
                if f.kind == "transient_submit_error":
                    raise TransientSubmitError(
                        f"replica {self.replica} wave {self.n_attempts}: "
                        "transient submit failure")
                if f.kind == "replica_slowdown":
                    s *= f.factor
                elif f.kind == "wave_timeout":
                    lost = True
                elif f.kind == "corrupt_output":
                    corrupt = True
        self.calls.append((int(mask.sum()), mb))
        start = max(self.clock.now(), self.busy_until)
        # the device still *runs* a lost wave (it burns service time and
        # then recovers); only the response never arrives
        self.busy_until = start + s
        y = np.zeros((mb, 1), np.float32)
        y[:n, 0] = x.reshape(n, -1).sum(axis=1)
        if corrupt:
            y[:n, 0] += 2.0 ** 26        # beyond the proven 2**24 bound
        ready_t = math.inf if lost else self.busy_until
        return ScriptedWaveHandle(self.clock, ready_t, y, mask)


def scripted_pool(clock, services: Sequence[Union[float, Callable]],
                  micro_batch: int = 2, plan: Optional[FaultPlan] = None,
                  probe_interval_s: float = 0.05) -> ReplicaPool:
    """Replica pool whose i-th replica runs at ``services[i]`` per wave —
    the factory hands each replica slot its own independent scripted
    model, so the pool simulates ``len(services)`` devices. ``plan`` is
    shared across the replicas (specs name theirs by index)."""
    svc = list(services)
    slots = iter(range(len(svc)))

    def make():
        i = next(slots)
        return ScriptedWaveModel(clock, svc[i], micro_batch=micro_batch,
                                 plan=plan, replica=i)

    return ReplicaPool(factory=make, devices=[None] * len(svc),
                       probe_interval_s=probe_interval_s)

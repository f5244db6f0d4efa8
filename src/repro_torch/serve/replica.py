"""Replica pool: waves placed across executors by least outstanding work.

The port of ``repro.serve.replica``. The hls4ml platform framing — a
dataflow accelerator as a *shared* serving engine — maps here to one
replica per CUDA stream: a replica on a CUDA device owns a
``torch.cuda.Stream`` and submits its waves under it, so N logical
replicas sharing one compiled executor on one card
(``factory=lambda: cm``) are N streams, and the async engine overlaps
their waves on the card. The pool places each wave on the replica with
the least outstanding modeled work — the queueing-theory argument for
join-shortest-queue over round-robin under heterogeneous wave sizes.

Wave execution is split into ``submit`` (``submit_wave`` under the
replica's stream, which copies the wave to the model's device itself and
replays the segment programs' graphs there: a graph is keyed on the
stream, so replicas that share a model never share its buffers; the
call returns before the card has finished, and a CUDA event recorded
after the replay marks the wave's end) and the returned ``WaveHandle``'s
``wait`` — the seam the dispatch engines (``serve.dispatch``) are built
on. ``run_wave`` remains as the blocking submit-then-wait composition.

Before each submit the replica's stream waits for the device's current
stream: the executor packs K3's weights and transposes its banks there
(``CompiledTinyModel._rebuild``, again after ``apply_tuned``), and a wave
must not read them before that work is done. The wait costs no host
synchronisation.

A model-only pool is one replica on the model's own device; on the CPU
it degenerates to a single replica and the placement/overlap logic is
exercised by the tests through fake executors (a fake exposing
``submit_wave_async`` can script completion times against a manual
clock).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve.dispatch import WaveHandle
from repro_torch.serve.faults import NoReplicaAvailable

#: Replica health states (the failure-domain state machine — see
#: ``docs/faults.md``): healthy -> suspect on the first observed failure,
#: suspect -> quarantined on the next (excluded from placement),
#: quarantined -> recovering when a probe wave is due (exactly one wave is
#: allowed through), recovering -> healthy on probe success / back to
#: quarantined on probe failure. Any success from any state heals.
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
RECOVERING = "recovering"


@dataclasses.dataclass
class Replica:
    """One executor instance bound to one device; on a CUDA device, to
    one stream of it (``stream``, made here when not given)."""

    index: int
    model: object                 # anything with submit_wave(...) -> (y, mask)
    device: Optional[object] = None
    outstanding_s: float = 0.0    # modeled seconds of work placed, not done
    n_dispatched: int = 0
    n_inflight: int = 0           # waves submitted, not yet reaped
    health: str = HEALTHY
    n_failures: int = 0           # consecutive failures since last success
    last_failure: str = ""        # reason string of the latest failure
    next_probe_t: float = 0.0     # quarantined: when the probe wave is due
    stream: Optional[object] = None   # torch.cuda.Stream on a CUDA device

    def __post_init__(self):
        if isinstance(self.device, str):
            self.device = torch.device(self.device)
        if self.stream is None and isinstance(self.device, torch.device) \
                and self.device.type == "cuda":
            self.stream = torch.cuda.Stream(device=self.device)

    def submit(self, x, valid=None, micro_batch: Optional[int] = None
               ) -> WaveHandle:
        """Launch one padded wave on this replica without waiting for the
        result.

        Prefers the model's ``submit_wave_async`` when it has one (the
        scripted-fake protocol: returns an object with ``ready_t`` and
        ``wait()``); otherwise calls ``submit_wave`` — on a CUDA replica
        under its stream, ordered after the device's current stream, with
        an event recorded right after the launch, so the wave is in
        flight, not done, until the handle's ``wait``.
        """
        submit_async = getattr(self.model, "submit_wave_async", None)
        if submit_async is not None:
            inner = submit_async(x, valid=valid, micro_batch=micro_batch)
            return WaveHandle(self, inner=inner)
        if self.stream is None:
            y, mask = self.model.submit_wave(x, valid=valid,
                                             micro_batch=micro_batch)
            return WaveHandle(self, y=y, mask=mask)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            y, mask = self.model.submit_wave(x, valid=valid,
                                             micro_batch=micro_batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return WaveHandle(self, y=y, mask=mask, event=event)

    def run_wave(self, x, valid=None, micro_batch: Optional[int] = None):
        """Run one padded wave and block until the result is ready, so the
        caller's clock reading is the completion (the sync-engine path)."""
        return self.submit(x, valid=valid, micro_batch=micro_batch).wait()


class ReplicaPool:
    """Replicas of one model across devices, placed by least work.

    ``factory`` builds the executor of each replica slot (e.g.
    ``lambda: compile_graph(graph, ...)``, or ``lambda: cm`` for N streams
    sharing one executor on one card); ``devices=None`` with a factory
    means one replica per CUDA device and raises without one. When only
    ``model`` is given the pool has that single replica, on the model's
    own device. The first replica reuses ``model`` so single-device
    callers pay zero extra compiles.
    """

    def __init__(self, model=None, *,
                 factory: Optional[Callable[[], object]] = None,
                 devices: Optional[Sequence[object]] = None,
                 probe_interval_s: float = 0.05):
        if model is None and factory is None:
            raise ValueError("need a model or a factory")
        if probe_interval_s <= 0:
            raise ValueError(
                f"probe_interval_s must be > 0, got {probe_interval_s}")
        #: quarantined -> recovering probe cadence: how long a quarantined
        #: replica sits out before one probe wave is allowed through
        self.probe_interval_s = float(probe_interval_s)
        if devices is None:
            devices = (_cuda_devices() if factory is not None
                       else [getattr(model, "device", None)])
        if not devices:
            raise ValueError("no devices to place replicas on")
        #: per-replica outstanding-work counter sink; the router installs
        #: its tracer here so placement decisions show up as counter
        #: tracks (pid 1+i = replica i in the exported timeline)
        self.tracer = NULL_TRACER
        if len(devices) > 1 and factory is None:
            raise ValueError(
                f"{len(devices)} devices but no factory: replicas beyond "
                "the first need their own executor slot — pass "
                "factory=lambda: compile_graph(...) (or lambda: model to "
                "share one executor)")
        self.replicas: List[Replica] = []
        for i, dev in enumerate(devices):
            m = model if (i == 0 and model is not None) else factory()
            self.replicas.append(Replica(index=i, model=m, device=dev))

    def warm(self, x, micro_batch: Optional[int] = None) -> None:
        """Run one wave of ``x`` on every replica and wait for it; the
        results are discarded. On the card a replica's stream pays
        one-time costs on its first wave (the caching allocator's first
        blocks for that stream, cuBLAS's workspace for the float head),
        which made a fresh stream's first full-width CNV wave far slower
        than the next. A server warms its pool before traffic arrives. (A port-only
        method: JAX pays its one-time cost, the compile, per program, and
        the reference warms the model itself.)"""
        for r in self.replicas:
            r.run_wave(x, micro_batch=micro_batch)

    @property
    def default_micro_batch(self) -> int:
        m = self.replicas[0].model
        return int(getattr(m, "default_micro_batch", 1))

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def n_available(self) -> int:
        """Replicas the pool can place work on (not quarantined) — the
        worker count the admission controller prices the surviving pool
        with, so a half-dead pool sheds like the half it really is."""
        return sum(1 for r in self.replicas if r.health != QUARANTINED)

    def place(self, work_s: float = 0.0, now: Optional[float] = None,
              exclude: Sequence[int] = ()) -> Replica:
        """Pick the least-outstanding-work replica and charge it the wave's
        modeled service time; ``complete`` credits it back. Equal-work ties
        break to the replica that has dispatched fewest waves (round-robin
        under uniform load), then to index.

        Health-aware: quarantined replicas are skipped; when ``now`` is
        given and a quarantined replica's probe is due, that replica takes
        this one wave as its readmission probe (state -> recovering —
        exactly one wave, so a still-dead replica costs one retry, not a
        burst). ``exclude`` holds replica indices a retried wave must
        avoid (the ones it already failed on) — a *preference*: with
        every other replica down, retrying in place beats shedding. Raises
        ``NoReplicaAvailable`` (typed, never an IndexError) when the pool
        has nowhere at all to put the wave.

        The caller owes a *real* ``work_s`` estimate for join-shortest-queue
        to mean anything: with ``work_s=0`` every replica always ties and
        placement silently degenerates to dispatch-count round-robin —
        the bug the router's lane-level service estimate now closes even
        when SLO shedding is off.
        """
        exclude = frozenset(exclude)
        r = None
        if now is not None:
            due = [p for p in self.replicas
                   if p.health == QUARANTINED and now >= p.next_probe_t
                   and p.index not in exclude]
            if due:
                r = min(due, key=lambda p: (p.next_probe_t, p.index))
                r.health = RECOVERING
                if self.tracer.enabled:
                    self._trace_health(r, now)
        if r is None:
            live = [p for p in self.replicas
                    if p.health in (HEALTHY, SUSPECT)]
            candidates = [p for p in live if p.index not in exclude] or live
            if not candidates:
                raise NoReplicaAvailable(
                    "no replica available: "
                    + ", ".join(f"replica{p.index}={p.health}"
                                for p in self.replicas))
            r = min(candidates,
                    key=lambda r: (r.outstanding_s, r.n_dispatched, r.index))
        r.outstanding_s += float(work_s)
        r.n_dispatched += 1
        if self.tracer.enabled:
            self.tracer.counter("outstanding_s", r.outstanding_s,
                                cat="replica", pid=1 + r.index)
        return r

    # -- health state machine ----------------------------------------------
    def _trace_health(self, r: Replica, now: Optional[float]) -> None:
        kw = {} if now is None else {"t": now}
        self.tracer.instant("replica_health", cat="replica",
                            pid=1 + r.index, health=r.health,
                            failures=r.n_failures, **kw)
        self.tracer.counter("available_replicas", self.n_available,
                            cat="replica", **kw)

    def mark_failure(self, replica: Replica, now: float,
                     reason: str = "") -> str:
        """One observed failure (timeout, crash, corrupt output, submit
        error) on this replica: healthy degrades to suspect; anything
        already under suspicion — suspect, recovering (a failed probe) —
        goes to quarantine with the next probe scheduled. Returns the new
        health state."""
        replica.n_failures += 1
        replica.last_failure = str(reason)
        if replica.health == HEALTHY:
            replica.health = SUSPECT
        else:
            replica.health = QUARANTINED
            replica.next_probe_t = now + self.probe_interval_s
        if self.tracer.enabled:
            self._trace_health(replica, now)
        return replica.health

    def mark_success(self, replica: Replica, now: float) -> None:
        """One completed, integrity-clean wave: full health, from any
        state (a recovering replica's probe success readmits it)."""
        replica.n_failures = 0
        if replica.health != HEALTHY:
            replica.health = HEALTHY
            if self.tracer.enabled:
                self._trace_health(replica, now)

    def complete(self, replica: Replica, work_s: float = 0.0) -> None:
        replica.outstanding_s = max(0.0, replica.outstanding_s
                                    - float(work_s))
        if self.tracer.enabled:
            self.tracer.counter("outstanding_s", replica.outstanding_s,
                                cat="replica", pid=1 + replica.index)

    def stats(self) -> List[dict]:
        return [{"replica": r.index,
                 "device": str(r.device) if r.device is not None else "local",
                 "dispatched": r.n_dispatched,
                 "inflight": r.n_inflight,
                 "outstanding_s": r.outstanding_s,
                 "health": r.health,
                 "failures": r.n_failures}
                for r in self.replicas]


def _cuda_devices() -> List[torch.device]:
    """Every CUDA device, one replica each (the port's ``jax.devices()``);
    raises when there is none — a pool never falls back to the CPU
    unasked."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "ReplicaPool(factory=...) places one replica per CUDA device "
            "and found none; pass devices=[...] (e.g. [None] or "
            "['cpu']) to place replicas elsewhere")
    return [torch.device("cuda", i) for i in range(n)]

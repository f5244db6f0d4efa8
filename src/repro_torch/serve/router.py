"""The dynamic batcher: request traffic in, compiled segment waves out.

The port of ``repro.serve.router``: the same policy, event loop, trace
spans and counters. Two places touch the card: the platform stamped on
dispatch spans comes from the lanes' devices (``"gpu"`` for a CUDA lane,
JAX's word for it; ``"cpu"`` otherwise), and a completed wave is copied
to the host once, after its wait, before the integrity guard and the
per-request rows.

This is the runtime that was missing between individual requests and the
compiled streaming pipeline. Per model ("lane") the router keeps a
pending queue and two dispatch triggers:

  * **full wave** — the moment ``micro_batch`` requests (the autotuned wave
    size by default) are queued, they leave as one wave;
  * **deadline flush** — the oldest pending request never waits longer than
    ``max_wait_ms``: when the deadline passes, the partial wave leaves
    anyway, zero-padded through the executor's ``submit_wave`` padding-mask
    contract (padded rows are inert; valid rows stay bit-exact vs
    ``offline``).

Waves are placed on a ``ReplicaPool`` by least outstanding work, and an
optional ``SLOController`` sheds arrivals whose estimated completion
would blow the per-model p99 budget. *How* a placed wave executes is the
injectable ``DispatchEngine``'s business (``serve.dispatch``): the
default ``SyncEngine`` blocks inside dispatch (the original semantics),
while ``AsyncEngine`` submits without waiting — the router parks a
``WaveHandle`` per wave in its in-flight table and **reaps** completions
on every event-loop pass, so waves on different replicas overlap and an
N-replica pool finally runs N wide. Completion bookkeeping (result
stamping, metrics, SLO feedback, pool credit, trace spans) lives in one
place — ``_complete`` — for both engines.

Failure handling (``serve.faults``, ``docs/faults.md``): waves carry a
deadline priced off the lane's service estimate
(``RouterConfig.wave_timeout_mult``); ``reap`` cancels overdue waves and
re-dispatches their requests to a different replica with bounded retries
and exponential backoff — retried waves keep their original ``arrival_t``
so p99 stays honest. Every failure feeds the pool's replica health state
machine (healthy -> suspect -> quarantined -> recovering), admission is
repriced to the surviving pool, and a per-wave output integrity guard
(finite, inside the lowering's proven ``2**24`` bound) routes corrupt
results to retry instead of clients. Requests that exhaust retries — or
arrive when every replica is quarantined — are shed with a typed reason
code, never hung.

All timing goes through an injectable clock, so the router is an exact
discrete-event system under ``ManualClock`` — the property the
hand-simulated-trace tests exploit — and a real server under
``SystemClock``.

Typical use (the ``ServerStreaming`` scenario, the serve bench, and the
``TinyModelServer`` compatibility shim are all thin wrappers over this):

    router = Router({"ic": cm}, RouterConfig(max_wait_ms=2.0,
                                             p99_budget_ms=50.0),
                    engine=AsyncEngine())
    done = router.run_trace("ic", poisson_trace(qps, n), make_query)
    print(router.stats()["ic"]["metrics"])
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Deque, Dict, FrozenSet, List, Optional, Union

import numpy as np
import torch

from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve.clock import SystemClock
from repro_torch.serve.dispatch import DispatchEngine, SyncEngine, WaveHandle
from repro_torch.serve.faults import (
    DEFAULT_OUTPUT_BOUND,
    CorruptWave,
    FaultError,
    NoReplicaAvailable,
    WaveTimeout,
    wave_integrity_ok,
)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.replica import Replica, ReplicaPool
from repro_torch.serve.slo import ServiceModel, SLOController, queued_waves
from repro_torch.serve.traffic import Trace

#: Poll bounds while waves with unannounced completion times are in
#: flight (real devices under ``SystemClock``): the event loop starts at
#: ``_POLL_MIN_S`` and backs off exponentially to ``_POLL_MAX_S`` while
#: nothing completes — a hung device no longer burns a core at a fixed
#: 0.5 ms spin — resetting to the floor the moment a wave settles. The
#: backoff never sleeps past a wave deadline or batch deadline, so
#: timeouts still fire on time. Scripted handles announce ``ready_t`` and
#: never poll — manual-clock runs stay exact discrete-event simulations.
_POLL_MIN_S = 0.5e-3
_POLL_MAX_S = 16e-3


def _backend_name(pools) -> str:
    """The platform string stamped on dispatch spans (prediction-error
    rows group by it): ``"gpu"`` when a lane's replica or model lies on a
    CUDA device (JAX's name for that backend, so the rows group as the
    reference's do), else ``"cpu"``."""
    for pool in pools:
        for r in pool.replicas:
            dev = r.device if r.device is not None \
                else getattr(r.model, "device", None)
            if isinstance(dev, torch.device) and dev.type == "cuda":
                return "gpu"
    return "cpu"


def _host(y) -> np.ndarray:
    """A completed wave's output on the host, one copy per wave."""
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


@dataclasses.dataclass
class ServeRequest:
    """One inference request as the router tracks it."""

    uid: int
    model: str
    x: np.ndarray
    arrival_t: float
    done_t: float = 0.0
    result: Optional[np.ndarray] = None
    shed: bool = False
    #: why a shed/failed request carries no result ("slo", "no_replica",
    #: "retries_exhausted: ..."); None for served requests
    error: Optional[str] = None

    @property
    def latency_s(self) -> float:
        return self.done_t - self.arrival_t


@dataclasses.dataclass
class RouterConfig:
    """Per-model routing policy.

    ``micro_batch=None`` consumes the executor's (autotuned) default wave
    size; ``p99_budget_ms=None`` disables shedding (every request is
    admitted). ``slo_headroom`` scales the budget the admission test uses
    (0.8 = shed at 80% of budget, keeping margin for estimate error).
    """

    max_wait_ms: float = 2.0
    micro_batch: Optional[int] = None
    p99_budget_ms: Optional[float] = None
    slo_headroom: float = 1.0
    window_s: float = 30.0
    #: False = never dispatch from inside ``submit`` (a full wave waits for
    #: the next ``step``/``dispatch_one``) — the explicitly-stepped
    #: compatibility mode the ``TinyModelServer`` shim runs in.
    auto_dispatch: bool = True
    #: Wave deadline as a multiple of the lane's service estimate
    #: (``deadline = submit_t + max(mult * estimate, floor)``); ``None``
    #: disables wave timeouts entirely — the default, so deployments (and
    #: the exact hand-simulated tests) that never asked for fault
    #: handling keep bit-identical timing.
    wave_timeout_mult: Optional[float] = None
    #: Deadline floor: a lane whose estimate is still 0 (nothing observed
    #: yet) must not declare every wave instantly overdue.
    wave_timeout_floor_ms: float = 1.0
    #: Failed waves (timeout, crash, corrupt output, submit error) are
    #: re-dispatched to a different replica at most this many times before
    #: their requests are shed with reason "retries_exhausted".
    max_retries: int = 2
    #: Retry backoff base: attempt k waits ``retry_backoff_ms * 2**(k-1)``
    #: before re-dispatch (exponential, so a flapping pool isn't hammered).
    retry_backoff_ms: float = 0.5
    #: Per-wave output integrity guard at settle time (finite + inside
    #: ``output_bound``); violations are retried, never served.
    integrity_check: bool = True
    #: Magnitude bound the guard checks against; ``None`` resolves to the
    #: model's ``output_bound`` attribute when it has one, else the
    #: lowering exactness bound (``faults.DEFAULT_OUTPUT_BOUND = 2**24``).
    output_bound: Optional[float] = None
    #: Override the pool's quarantine probe cadence (seconds between
    #: readmission probe waves); ``None`` keeps the pool's own setting.
    probe_interval_ms: Optional[float] = None


class _Lane:
    """Internal per-model state: pool + queue + policy + metrics."""

    #: EWMA weight for the measured-wave-time fallback service estimate
    #: (same spirit as ``SLOController.ewma_alpha``).
    EWMA_ALPHA = 0.25

    def __init__(self, name: str, pool: ReplicaPool, cfg: RouterConfig,
                 slo: Optional[SLOController], start_t: float,
                 service: Optional[ServiceModel] = None, tid: int = 0):
        self.name = name
        self.pool = pool
        self.cfg = cfg
        self.slo = slo
        #: the raw FIFO-cost-model service estimate (uncorrected by the
        #: SLO controller's EWMA) — what dispatch spans record as the
        #: *predicted* wave service time, the learned-cost-model trail
        self.service = service
        self.tid = tid                       # trace track for this lane
        self.n_shed = 0
        self.n_inflight = 0                  # this lane's unreaped waves
        #: measured-wave-time EWMA: the placement work estimate of last
        #: resort when the lane has neither controller nor service model
        self.ewma_service_s: Optional[float] = None
        self.pending: Deque[ServeRequest] = collections.deque()
        self.metrics = ServeMetrics(window_s=cfg.window_s, start_t=start_t)
        self.micro_batch = int(cfg.micro_batch
                               or pool.default_micro_batch or 1)
        #: integrity-guard magnitude bound: config override, else the
        #: model's own declared bound, else the lowering proof's 2**24
        bound = cfg.output_bound
        if bound is None:
            bound = getattr(pool.replicas[0].model, "output_bound", None)
        self.output_bound = float(bound) if bound is not None \
            else DEFAULT_OUTPUT_BOUND

    def wave_deadline_s(self, work_s: float) -> Optional[float]:
        """Seconds an in-flight wave may run before it is declared
        overdue: the lane's service estimate times the configured
        multiplier, floored so an uncalibrated lane (estimate 0) doesn't
        declare every wave instantly late. ``None`` = timeouts off."""
        if self.cfg.wave_timeout_mult is None:
            return None
        return max(self.cfg.wave_timeout_mult * max(work_s, 0.0),
                   self.cfg.wave_timeout_floor_ms / 1e3)

    def deadline(self) -> Optional[float]:
        if not self.pending:
            return None
        return self.pending[0].arrival_t + self.cfg.max_wait_ms / 1e3

    def work_estimate_s(self) -> float:
        """The wave service estimate placement charges a replica.

        Best available source wins: the SLO controller's EWMA-corrected
        model, else the raw lane service model, else the measured-wave
        EWMA. Never 0.0 once anything has been observed — with a zero
        charge every replica ties on outstanding work and least-work
        placement silently degenerates to dispatch-count round-robin,
        which misplaces heterogeneous waves.
        """
        if self.slo is not None:
            return self.slo.wave_service_s(self.micro_batch)
        if self.service is not None:
            return self.service.wave_service_s(self.micro_batch)
        return self.ewma_service_s if self.ewma_service_s is not None \
            else 0.0

    def observe_service(self, measured_s: float) -> None:
        """Feed one completed wave's measured service time back into the
        lane's estimate (controller EWMA when present, lane EWMA else)."""
        if self.slo is not None:
            self.slo.observe_service(self.micro_batch, measured_s)
            return
        if measured_s <= 0:
            return
        if self.ewma_service_s is None:
            self.ewma_service_s = float(measured_s)
        else:
            a = self.EWMA_ALPHA
            self.ewma_service_s = \
                (1 - a) * self.ewma_service_s + a * float(measured_s)


@dataclasses.dataclass
class _InFlightWave:
    """One dispatched wave between submit and completion — the in-flight
    table's row (sync waves pass through without ever being parked)."""

    lane: _Lane
    reqs: List[ServeRequest]
    replica: Replica
    handle: WaveHandle
    t0: float                    # submit time (span start, service clock)
    work_s: float                # modeled work charged at placement
    n_valid: int
    seq: int                     # submission order: FIFO reap tiebreak
    deadline_t: Optional[float] = None   # overdue past this (None = never)
    attempt: int = 0                     # 0 = first dispatch, 1+ = retries
    #: replica indices this wave already failed on (retry placement avoids
    #: them — a preference place() may override when nothing else is up)
    exclude: FrozenSet[int] = frozenset()


@dataclasses.dataclass
class _RetryWave:
    """A failed wave's requests parked for re-dispatch after backoff."""

    lane: _Lane
    reqs: List[ServeRequest]
    not_before_t: float          # backoff expiry (absolute clock time)
    attempt: int                 # the attempt number of the re-dispatch
    exclude: FrozenSet[int]


class Router:
    """Dynamic-batching front end over compiled executors.

    ``models`` maps name -> executor (``CompiledTinyModel`` or anything
    with ``submit_wave``/``default_micro_batch``) or a prebuilt
    ``ReplicaPool``. ``config`` is one ``RouterConfig`` for every model or
    a per-model dict. ``service_models`` supplies the SLO service-time
    model per name; when omitted and a p99 budget is set, it is built from
    the compiled schedule (``ServiceModel.from_compiled`` — FIFO cost
    model calibrated by a ``stage_latencies`` probe). ``engine`` picks the
    dispatch semantics (default ``SyncEngine``; pass ``AsyncEngine()`` to
    overlap waves across replicas).
    """

    def __init__(self, models: Dict[str, object],
                 config: Union[RouterConfig, Dict[str, RouterConfig], None]
                 = None,
                 clock: Optional[object] = None,
                 service_models: Optional[Dict[str, ServiceModel]] = None,
                 tracer: Optional[object] = None,
                 engine: Optional[DispatchEngine] = None):
        self.clock = clock if clock is not None else SystemClock()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.engine = engine if engine is not None else SyncEngine()
        self._uid = 0
        self._wave_seq = 0
        self._inflight: List[_InFlightWave] = []
        self._retries: List[_RetryWave] = []
        self._poll_s = _POLL_MIN_S       # blind-handle backoff state
        self.lanes: Dict[str, _Lane] = {}
        now = self.clock.now()
        for i, (name, model) in enumerate(models.items()):
            cfg = (config.get(name, RouterConfig())
                   if isinstance(config, dict)
                   else (config or RouterConfig()))
            pool = model if isinstance(model, ReplicaPool) \
                else ReplicaPool(model)
            if cfg.probe_interval_ms is not None:
                pool.probe_interval_s = cfg.probe_interval_ms / 1e3
            if self.tracer.enabled:
                pool.tracer = self.tracer
            service = (service_models or {}).get(name)
            slo = None
            if cfg.p99_budget_ms is not None:
                if service is None:
                    service = ServiceModel.from_compiled(
                        pool.replicas[0].model)
                slo = SLOController(cfg.p99_budget_ms, service,
                                    window_s=cfg.window_s,
                                    headroom=cfg.slo_headroom)
            self.lanes[name] = _Lane(name, pool, cfg, slo, start_t=now,
                                     service=service, tid=i + 1)
        self.platform = (_backend_name(lane.pool
                                       for lane in self.lanes.values())
                         if self.tracer.enabled else "")

    def trace_names(self) -> Dict[str, Dict]:
        """Process/track naming maps for ``obs.export.export_chrome``:
        pid 0 is the router, pid 1+i replica i; one track per lane."""
        pids = {0: "router"}
        tids = {}
        for lane in self.lanes.values():
            tids[(0, lane.tid)] = f"lane:{lane.name}"
            for r in lane.pool.replicas:
                pids[1 + r.index] = f"replica{r.index}"
                tids[(1 + r.index, lane.tid)] = f"waves:{lane.name}"
        return {"process_names": pids, "thread_names": tids}

    # -- submission --------------------------------------------------------
    def submit(self, model: str, x, arrival_t: Optional[float] = None
               ) -> ServeRequest:
        """Admit (or shed) one request; a full wave dispatches in-line."""
        lane = self._lane(model)
        now = self.clock.now() if arrival_t is None else float(arrival_t)
        req = ServeRequest(uid=self._uid, model=model, x=np.asarray(x),
                           arrival_t=now)
        self._uid += 1
        tr = self.tracer
        if tr.enabled:
            tr.instant("enqueue", t=now, cat="router", tid=lane.tid,
                       uid=req.uid, model=model)
        if lane.slo is not None:
            lane.slo.observe_arrival(now)
            # waves this request must wait out: the ceiling form prices
            # the partial wave it joins, and every still-in-flight wave
            # holds a replica slot so it is queue delay too (zero under
            # the blocking engine, where dispatch and completion coincide)
            backlog_waves = queued_waves(len(lane.pending),
                                         lane.micro_batch, lane.n_inflight)
            # a request admitted late (the server was busy past its arrival
            # time) has already burned budget: the admission estimate must
            # carry that lag, or an overloaded single-worker lane would
            # never shed — its pending queue stays short while the clock
            # falls behind the trace
            lag_s = max(self.clock.now() - now, 0.0)
            # capacity is the SURVIVING pool: quarantined replicas take no
            # waves, so pricing the backlog across the nominal replica
            # count would under-shed exactly when the pool is degraded
            if not lane.slo.admit(now, backlog_waves, lane.micro_batch,
                                  lane.cfg.max_wait_ms / 1e3, lag_s=lag_s,
                                  n_workers=max(lane.pool.n_available, 1)):
                req.shed = True
                lane.n_shed += 1
                lane.metrics.record_shed(now)
                if tr.enabled:
                    tr.instant("shed", t=now, cat="router", tid=lane.tid,
                               uid=req.uid, model=model)
                    tr.counter("shed_total", lane.n_shed, t=now,
                               tid=lane.tid)
                    # a shed request's span is its (empty) lifetime: it
                    # exists in the trace but not in latency populations
                    tr.add_span("request", now, now, cat="router",
                                tid=lane.tid,
                                args={"uid": req.uid, "model": model,
                                      "shed": True})
                return req
        lane.metrics.record_admit(now)
        lane.pending.append(req)
        if tr.enabled:
            tr.instant("admit", t=now, cat="router", tid=lane.tid,
                       uid=req.uid, model=model)
            tr.counter("backlog", len(lane.pending), t=now, tid=lane.tid)
        if lane.cfg.auto_dispatch:
            while len(lane.pending) >= lane.micro_batch:
                self._dispatch(lane, lane.micro_batch)
        return req

    def _lane(self, model: str) -> _Lane:
        lane = self.lanes.get(model)
        if lane is None:
            raise KeyError(f"unknown model {model!r}; "
                           f"lanes: {sorted(self.lanes)}")
        return lane

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, lane: _Lane, n: int,
                  reqs: Optional[List[ServeRequest]] = None,
                  attempt: int = 0,
                  exclude: FrozenSet[int] = frozenset()) -> int:
        """Pop up to ``n`` requests and submit them as one padded wave
        (or re-submit a failed wave's ``reqs`` — a retry keeps its
        requests' original ``arrival_t`` so p99 stays honest).

        Under the blocking engine the wave also completes here; under the
        async engine it lands in the in-flight table and ``reap`` settles
        it later. A submission-time failure (crashed replica, transient
        error) parks the wave for retry; an empty / fully-quarantined pool
        sheds it with reason "no_replica".
        """
        if reqs is None:
            n = min(n, len(lane.pending))
            if n == 0:
                return 0
            reqs = [lane.pending.popleft() for _ in range(n)]
        else:
            n = len(reqs)
        mb = lane.micro_batch
        work_s = lane.work_estimate_s()
        tr = self.tracer
        if tr.enabled:
            tr.instant("wave_assemble", cat="router", tid=lane.tid,
                       model=lane.name, n_valid=n)
        now = self.clock.now()
        try:
            replica = lane.pool.place(work_s, now=now, exclude=exclude)
        except NoReplicaAvailable as e:
            # nowhere to put the wave at all: typed fast-fail, distinct
            # shed reason — never a hang, never an IndexError
            self._shed_wave(lane, reqs, now, reason="no_replica", exc=e)
            return 0
        if not self.engine.blocking:
            # backpressure: a replica never holds more than the engine's
            # in-flight allowance — reap (in completion order, overdue
            # waves failed first) until the chosen replica frees a slot
            while replica.n_inflight >= self.engine.max_inflight \
                    and self._inflight:
                self._reap_one(block=True)
        xb = np.stack([r.x for r in reqs])
        t0 = self.clock.now()
        try:
            handle = self.engine.submit(replica, xb, micro_batch=mb)
        except FaultError as e:
            # the submission itself was refused (crashed replica,
            # transient submit error): credit the placement charge back,
            # degrade the replica, park the wave for retry elsewhere
            lane.pool.complete(replica, work_s)
            lane.pool.mark_failure(replica, t0, reason=type(e).__name__)
            lane.metrics.record_fault(t0, "submit_error")
            if tr.enabled:
                tr.instant("wave_failed", t=t0, cat="router", tid=lane.tid,
                           model=lane.name, replica=replica.index,
                           kind="submit_error", attempt=attempt)
            self._park_retry(lane, reqs, attempt, t0,
                             exclude | {replica.index}, e)
            return 0
        replica.n_inflight += 1
        lane.n_inflight += 1
        self._wave_seq += 1
        deadline_t = None
        timeout_s = lane.wave_deadline_s(work_s)
        if timeout_s is not None:
            deadline_t = t0 + timeout_s
            handle.deadline_t = deadline_t
        wave = _InFlightWave(lane=lane, reqs=reqs, replica=replica,
                             handle=handle, t0=t0, work_s=work_s,
                             n_valid=n, seq=self._wave_seq,
                             deadline_t=deadline_t, attempt=attempt,
                             exclude=exclude)
        if self.engine.blocking:
            # a failed blocking wave (0) parked its requests for retry;
            # report only what actually completed
            return self._complete(wave)
        self._inflight.append(wave)
        if tr.enabled:
            tr.counter("inflight", lane.n_inflight, t=t0, tid=lane.tid)
        return n

    # -- completion --------------------------------------------------------
    @staticmethod
    def _completion_key(w: _InFlightWave):
        """Reap order: known completion times ascending (the discrete-event
        contract — callbacks settle in event order), then submission order
        for handles that don't pre-announce (real devices: FIFO)."""
        rt = w.handle.ready_t
        return (0, rt, w.seq) if rt is not None else (1, 0.0, w.seq)

    def _settle(self, wave: _InFlightWave) -> int:
        self._inflight.remove(wave)
        return self._complete(wave)

    def _release(self, wave: _InFlightWave) -> None:
        """Undo a wave's in-flight accounting (pool work charge, replica
        and lane in-flight counts) — the shared first step of settling a
        completion and of failing a wave."""
        wave.lane.pool.complete(wave.replica, wave.work_s)
        wave.replica.n_inflight -= 1
        wave.lane.n_inflight -= 1
        self._poll_s = _POLL_MIN_S       # progress: reset the poll backoff

    def _complete(self, wave: _InFlightWave) -> int:
        """Wait on one wave and run its completion: stamp ``done_t``,
        settle metrics, credit the pool, feed the SLO controller or lane
        EWMA, close the wave/request trace spans. A wave that fails —
        typed fault from the wait, or an output flunking the integrity
        guard — goes to the retry path instead; returns the number of
        requests actually served (0 on failure)."""
        lane = wave.lane
        try:
            y, mask = wave.handle.wait()
        except FaultError as e:
            self._release(wave)
            self._after_failure(wave, e, self.clock.now())
            return 0
        # a scripted handle knows the true completion instant (possibly
        # earlier than this reap); a real device doesn't — the clock
        # reading after the blocking wait is the completion
        done = wave.handle.done_t
        if done is None:
            done = self.clock.now()
        self._release(wave)
        y = _host(y)
        mask = np.asarray(mask)
        n, mb = wave.n_valid, lane.micro_batch
        if not (mask[:n].all() and not mask[n:].any()):
            # a bare assert here would vanish under ``python -O`` and let
            # an executor that mislabels its padding hand garbage rows to
            # clients — this is a result-integrity check, not a debug aid
            raise RuntimeError(
                f"lane {lane.name!r}: executor returned an invalid wave "
                f"mask {mask.tolist()} for {n} valid rows in a wave of "
                f"{mb} — padded rows must be masked out and valid rows "
                "masked in (see the submit_wave padding contract)")
        if lane.cfg.integrity_check \
                and not wave_integrity_ok(y[:n], lane.output_bound):
            # corrupt output is a failure, not a contract bug: the wave is
            # retried on another replica, never served to a client
            self._after_failure(
                wave,
                CorruptWave(
                    f"lane {lane.name!r}: wave output on replica "
                    f"{wave.replica.index} is non-finite or exceeds the "
                    f"proven bound {lane.output_bound:g}"),
                done)
            return 0
        lane.pool.mark_success(wave.replica, done)
        for r in wave.reqs:
            r.done_t = done
        for i, r in enumerate(wave.reqs):
            r.result = y[i]
            lane.metrics.record_completion(done, done - r.arrival_t)
        lane.metrics.record_wave(done, n, mb, service_s=done - wave.t0)
        lane.observe_service(done - wave.t0)
        tr = self.tracer
        if tr.enabled:
            # the dispatch span carries the FIFO-cost-model *predicted*
            # service time next to its measured duration — one
            # predicted-vs-measured training row per wave (obs.report)
            args = {"model": lane.name, "platform": self.platform,
                    "n_valid": n, "micro_batch": mb,
                    "replica": wave.replica.index}
            if lane.service is not None:
                args["predicted_ms"] = \
                    lane.service.wave_service_s(mb) * 1e3
                if lane.slo is not None:
                    # the controller's EWMA-corrected estimate, for
                    # auditing admission decisions (distinct from the raw
                    # model prediction above)
                    args["predicted_ewma_ms"] = wave.work_s * 1e3
            tr.add_span("wave", wave.t0, done, cat="router",
                        pid=1 + wave.replica.index, tid=lane.tid, args=args)
            for r in wave.reqs:
                # request span: arrival (enqueue) -> completion; duration
                # is exactly the latency ServeMetrics recorded, so
                # span-derived percentiles match snapshots to the bit
                tr.add_span("request", r.arrival_t, done, cat="router",
                            tid=lane.tid,
                            args={"uid": r.uid, "model": lane.name})
            tr.counter("backlog", len(lane.pending), t=done, tid=lane.tid)
            tr.counter("wave_occupancy", n / max(mb, 1), t=done,
                       tid=lane.tid)
            if not self.engine.blocking:
                tr.counter("inflight", lane.n_inflight, t=done,
                           tid=lane.tid)
        return n

    # -- failure path ------------------------------------------------------
    def _shed_wave(self, lane: _Lane, reqs: List[ServeRequest], now: float,
                   reason: str, exc: Optional[BaseException] = None) -> None:
        """Terminal failure: mark every request shed with a typed reason
        ("no_replica", "retries_exhausted") — the caller got a request
        object back from ``submit`` and reads the verdict off it."""
        tr = self.tracer
        for r in reqs:
            r.shed = True
            r.error = reason if exc is None else f"{reason}: {exc}"
            r.done_t = now
            lane.n_shed += 1
            lane.metrics.record_shed(now, reason=reason)
            if tr.enabled:
                tr.instant("shed", t=now, cat="router", tid=lane.tid,
                           uid=r.uid, model=lane.name, reason=reason)
                tr.counter("shed_total", lane.n_shed, t=now, tid=lane.tid)
                tr.add_span("request", r.arrival_t, now, cat="router",
                            tid=lane.tid,
                            args={"uid": r.uid, "model": lane.name,
                                  "shed": True, "reason": reason})

    def _park_retry(self, lane: _Lane, reqs: List[ServeRequest],
                    attempt: int, now: float, exclude: FrozenSet[int],
                    exc: BaseException) -> None:
        """Queue a failed wave's requests for re-dispatch after exponential
        backoff, or shed them once the retry budget is spent."""
        if attempt >= lane.cfg.max_retries:
            self._shed_wave(lane, reqs, now, reason="retries_exhausted",
                            exc=exc)
            return
        backoff = lane.cfg.retry_backoff_ms / 1e3 * (2 ** attempt)
        self._retries.append(_RetryWave(lane=lane, reqs=reqs,
                                        not_before_t=now + backoff,
                                        attempt=attempt + 1,
                                        exclude=exclude))
        if self.tracer.enabled:
            self.tracer.instant("wave_retry", t=now, cat="router",
                                tid=lane.tid, model=lane.name,
                                attempt=attempt + 1,
                                backoff_ms=backoff * 1e3)

    def _after_failure(self, wave: _InFlightWave, exc: BaseException,
                       now: float) -> None:
        """Post-release bookkeeping for a failed wave: degrade the replica,
        count the fault, cancel the handle, park the requests for retry on
        a different replica. ``arrival_t`` is untouched — the retried
        requests' latency keeps accruing from first arrival."""
        lane = wave.lane
        kind = {WaveTimeout: "timeout", CorruptWave: "integrity"} \
            .get(type(exc))
        if kind is None:
            kind = "crash" if "Crash" in type(exc).__name__ else "error"
        lane.pool.mark_failure(wave.replica, now,
                               reason=type(exc).__name__)
        lane.metrics.record_fault(now, kind)
        wave.handle.cancel()
        if self.tracer.enabled:
            self.tracer.instant("wave_failed", t=now, cat="router",
                                tid=lane.tid, model=lane.name,
                                replica=wave.replica.index, kind=kind,
                                attempt=wave.attempt)
            self.tracer.counter("inflight", lane.n_inflight, t=now,
                                tid=lane.tid)
        self._park_retry(lane, wave.reqs, wave.attempt, now,
                         wave.exclude | {wave.replica.index}, exc)

    def _fail_overdue(self, now: float) -> int:
        """Cancel every in-flight wave past its deadline whose handle
        isn't already ready (a result that made it in time is served even
        if reaped late); returns the number of waves failed."""
        overdue = [w for w in self._inflight
                   if w.deadline_t is not None and now >= w.deadline_t
                   and not w.handle.ready(now)]
        for w in overdue:
            self._inflight.remove(w)
            w.handle.cancel()
            self._release(w)
            self._after_failure(
                w, WaveTimeout(
                    f"wave on replica {w.replica.index} missed its "
                    f"deadline t={w.deadline_t:.6f} (now t={now:.6f})"),
                now)
        return len(overdue)

    def _reap_one(self, block: bool) -> int:
        """One reaping step: fail overdue waves, else settle the earliest
        ready wave, else (blocking) sleep toward the next event — a
        scripted completion, a wave deadline, or (blind real-device
        handles) the capped-backoff poll tick. Returns requests served
        this step, or -1 when non-blocking and nothing was actionable."""
        now = self.clock.now()
        if self._fail_overdue(now):
            return 0
        ready = [w for w in self._inflight if w.handle.ready(now)]
        if ready:
            return self._settle(min(ready, key=self._completion_key))
        if not block:
            return -1
        events = [w.handle.ready_t for w in self._inflight
                  if w.handle.ready_t is not None
                  and math.isfinite(w.handle.ready_t)]
        deadlines = [w.deadline_t for w in self._inflight
                     if w.deadline_t is not None]
        blind = any(w.handle.ready_t is None for w in self._inflight)
        if blind and not deadlines:
            # legacy blocking path (real devices, timeouts off): wait on
            # the earliest submission — the handle's own wait blocks
            return self._settle(min(self._inflight,
                                    key=self._completion_key))
        targets = events + deadlines
        if targets:
            target = min(targets)
            if blind:
                # never sleep past the poll tick while blind handles may
                # complete unannounced; back the tick off while idle
                target = min(target, now + self._poll_s)
                self._poll_s = min(self._poll_s * 2, _POLL_MAX_S)
            self.clock.sleep(max(target - now, 0.0))
            return 0
        # only scripted lost waves remain (ready_t = inf, no deadline):
        # settling raises the handle's typed WaveTimeout -> retry/shed,
        # so even a deadline-less blocking drain terminates
        return self._settle(min(self._inflight, key=self._completion_key))

    def reap(self, block: bool = False) -> int:
        """Settle completed in-flight waves (all of them with ``block``);
        returns the number of requests whose results landed. Overdue waves
        are failed onto the retry path first. A no-op under the blocking
        engine — waves never park in the table there."""
        served = 0
        while self._inflight:
            progressed = self._reap_one(block)
            if progressed < 0:
                break
            served += progressed
        return served

    def _dispatch_retries(self, now: float) -> int:
        """Re-dispatch every parked retry whose backoff has expired."""
        due = [rw for rw in self._retries if now >= rw.not_before_t]
        served = 0
        for rw in due:
            self._retries.remove(rw)
            served += self._dispatch(rw.lane, len(rw.reqs), reqs=rw.reqs,
                                     attempt=rw.attempt, exclude=rw.exclude)
        return served

    # -- event loop hooks --------------------------------------------------
    def step(self, now: Optional[float] = None) -> int:
        """Reap finished waves, then dispatch every lane whose wave is full
        or whose oldest pending request has hit the max-wait deadline.
        Returns #requests dispatched (== completed under the blocking
        engine)."""
        now = self.clock.now() if now is None else now
        self.reap()
        served = 0
        served += self._dispatch_retries(self.clock.now())
        for lane in self.lanes.values():
            while len(lane.pending) >= lane.micro_batch:
                served += self._dispatch(lane, lane.micro_batch)
            dl = lane.deadline()
            if dl is not None and now >= dl:
                served += self._dispatch(lane, lane.micro_batch)
        return served

    def next_deadline(self) -> Optional[float]:
        """Earliest pending batch deadline across lanes (None when idle)."""
        dls = [d for d in (lane.deadline() for lane in self.lanes.values())
               if d is not None]
        return min(dls) if dls else None

    def _next_wake(self) -> Optional[float]:
        """Earliest event the loop must wake for: a batch deadline, a
        scripted in-flight completion, a wave deadline, or a retry-backoff
        expiry. Real-device handles announce no ready_t; the caller bounds
        its sleep with the poll backoff instead. A scripted *lost* wave
        (``ready_t = inf``) is not an event — its wave deadline is."""
        times = [d for d in (self.next_deadline(),) if d is not None]
        times += [w.handle.ready_t for w in self._inflight
                  if w.handle.ready_t is not None
                  and math.isfinite(w.handle.ready_t)]
        times += [w.deadline_t for w in self._inflight
                  if w.deadline_t is not None]
        times += [rw.not_before_t for rw in self._retries]
        return min(times) if times else None

    def _has_blind_inflight(self) -> bool:
        return any(w.handle.ready_t is None for w in self._inflight)

    def dispatch_one(self, model: str, max_n: Optional[int] = None) -> int:
        """Dispatch at most one (possibly partial) wave for one lane —
        the explicit-stepping hook the ``TinyModelServer`` shim drives."""
        lane = self._lane(model)
        n = lane.micro_batch if max_n is None else min(int(max_n),
                                                       lane.micro_batch)
        return self._dispatch(lane, n)

    def flush(self, model: Optional[str] = None) -> int:
        """Force-dispatch pending requests (partial waves included)."""
        lanes = [self._lane(model)] if model else list(self.lanes.values())
        served = 0
        for lane in lanes:
            while lane.pending:
                served += self._dispatch(lane, lane.micro_batch)
        return served

    def drain(self) -> int:
        """Flush everything, reap every in-flight wave, and run parked
        retries to a verdict (served or shed); the end-of-trace barrier.
        Terminates even with lost waves in flight: every retry chain is
        bounded by ``max_retries`` and every blocking reap step either
        settles, fails, or advances the clock toward a finite event."""
        served = self.flush()
        while self._inflight or self._retries:
            if self._inflight:
                self.reap(block=True)
            if self._retries:
                t = min(rw.not_before_t for rw in self._retries)
                self.clock.sleep(max(t - self.clock.now(), 0.0))
                self._dispatch_retries(self.clock.now())
        return served

    # -- trace replay ------------------------------------------------------
    def run_trace(self, model: str, trace: Trace,
                  make_query: Callable[[int], np.ndarray]
                  ) -> List[ServeRequest]:
        """Replay an arrival trace against one lane in (clock) real time.

        Between arrivals the router sleeps only as far as the next event —
        a batch deadline or (async engine) a scripted in-flight completion
        — so deadline flushes and completion reaps fire at the right
        moment even in arrival gaps. Under a ``ManualClock`` this loop is
        an exact simulation: sleeps advance the clock instantly and
        service time is whatever the executor (or a scripted fake) makes
        of it.
        """
        t0 = self.clock.now()
        out: List[ServeRequest] = []
        arr = np.asarray(trace.arrivals)
        i = 0
        while i < len(arr):
            target = t0 + float(arr[i])
            if self.clock.now() >= target:
                # due (or late) arrival: submit before stepping. While the
                # server was busy these requests were conceptually queuing
                # — admitting the whole late burst first lets it coalesce
                # into full waves, as it would in a threaded server, and
                # ``arrival_t=target`` keeps the blocked wait on the books.
                out.append(self.submit(model, make_query(i),
                                       arrival_t=target))
                i += 1
                continue
            self.step()
            wake = self._next_wake()
            if self._has_blind_inflight():
                # real-device waves in flight: wake to reap at least every
                # poll interval so completion stamping tracks the device
                # (capped exponential backoff; any settle resets the floor)
                poll = self.clock.now() + self._poll_s
                self._poll_s = min(self._poll_s * 2, _POLL_MAX_S)
                wake = poll if wake is None else min(wake, poll)
            if wake is not None and wake < target:
                self.clock.sleep(max(wake - self.clock.now(), 0.0))
                self.step()
            else:
                self.clock.sleep(max(target - self.clock.now(), 0.0))
        # drain the tail: honour remaining deadlines and scripted
        # completions in event order, then flush + reap what's left
        wake = self._next_wake()
        while wake is not None:
            self.clock.sleep(max(wake - self.clock.now(), 0.0))
            self.step()
            wake = self._next_wake()
        self.drain()
        return out

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, Dict]:
        """Per-lane snapshot: metrics window + SLO estimates + replicas."""
        now = self.clock.now()
        out: Dict[str, Dict] = {}
        for name, lane in self.lanes.items():
            snap = lane.metrics.snapshot(now)
            d = {"metrics": snap, "micro_batch": lane.micro_batch,
                 "pending": len(lane.pending),
                 "inflight": lane.n_inflight,
                 "retries_pending": sum(len(rw.reqs)
                                        for rw in self._retries
                                        if rw.lane is lane),
                 "replicas": lane.pool.stats()}
            if lane.slo is not None:
                d["slo"] = {
                    "p99_budget_ms": lane.slo.p99_budget_ms,
                    "wave_service_ms":
                        lane.slo.wave_service_s(lane.micro_batch) * 1e3,
                    "arrival_qps": lane.slo.arrival_qps(now),
                    "utilization":
                        lane.slo.utilization(now, lane.micro_batch),
                    "occupancy_estimate": lane.slo.occupancy_estimate(
                        now, lane.micro_batch,
                        lane.cfg.max_wait_ms / 1e3),
                }
            out[name] = d
        return out

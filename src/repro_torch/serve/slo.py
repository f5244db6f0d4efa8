"""SLO-aware admission control for the serve router.

The port of ``repro.serve.slo``. Service estimates stay Python floats (a
float32 anywhere would change the snapshot bytes); the port's
``stage_latencies``, ``stage_work`` and ``costmodel`` stand in for the
reference's, and ``measure_wave_service_s`` waits for each wave on the
card where the reference blocks on the JAX array.

The question the shedder answers per arriving request: *if we admit this,
will it (and the requests behind it) still finish inside the p99 budget?*
Answering needs a service-time estimate, and the serve runtime builds it
the same way the streaming autotuner does — model first, measurement
second:

  1. **FIFO cost model** — ``core.dataflow.micro_batch_stage`` prices every
     compiled stage at a wave size (``overhead + ceil(work*mb/elems)``
     simulated cycles, ``work`` from ``executor.stage_work``); summing the
     stage latencies gives the modeled fill+drain cycles of one wave
     through the segment pipeline.
  2. **stage_latencies calibration** — the executor's measured per-stage
     probe converts cycles to seconds: ``sec_per_cycle = measured wall
     seconds at the probe batch / modeled cycles at that batch``.
  3. **online correction** — every dispatched wave's measured service time
     feeds an EWMA ratio on top of the calibrated model, so drift (thermal,
     competing load) is tracked without re-probing.

Queue state then closes the loop: the controller tracks the arrival rate
in a sliding window and estimates steady-state queue occupancy by
Little's law (``L = lambda * W``); admission compares the *realized*
backlog's completion estimate against the budget and sheds the request up
front — a shed costs the client one fast rejection instead of a blown
p99.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.dataflow import micro_batch_stage


@dataclasses.dataclass
class ServiceModel:
    """Cycles -> seconds service-time model for one compiled schedule.

    ``works`` is the per-stage (name, fifo_work) list; ``sec_per_cycle``
    the stage_latencies calibration. ``calibration`` keeps the audit trail
    (probe batch, measured ms, modeled cycles) for the bench JSON.
    """

    works: List[Tuple[str, int]]
    sec_per_cycle: float
    calibration: Dict = dataclasses.field(default_factory=dict)

    def wave_cycles(self, micro_batch: int) -> int:
        """Modeled fill+drain cycles of ONE wave: the sum of per-stage
        service latencies under the FIFO cost model (a single wave visits
        every stage once; there is no pipelining inside one wave)."""
        return sum(micro_batch_stage(name, work, micro_batch).latency
                   for name, work in self.works)

    def wave_service_s(self, micro_batch: int) -> float:
        return self.wave_cycles(micro_batch) * self.sec_per_cycle

    def saturation_qps(self, micro_batch: int) -> float:
        """Max sustainable arrival rate at this wave size: full waves,
        back to back."""
        return micro_batch / max(self.wave_service_s(micro_batch), 1e-12)

    def recalibrated(self, measured_s: float, micro_batch: int
                     ) -> "ServiceModel":
        """New model rescaled so ``wave_service_s(micro_batch)`` equals a
        *measured* wave service time.

        The stage_latencies calibration prices the stage compute but not
        the per-wave dispatch overhead (host crossing, kernel launches),
        which dominates small models on CPU — so capacity planning from
        the raw model over-estimates saturation badly there. One measured
        ``submit_wave`` probe pins the model to reality at the operating
        wave size while keeping the FIFO model's *shape* across sizes.
        """
        modeled = self.wave_service_s(micro_batch)
        if measured_s <= 0 or modeled <= 0:
            return self
        ratio = measured_s / modeled
        return dataclasses.replace(
            self, sec_per_cycle=self.sec_per_cycle * ratio,
            calibration={**self.calibration,
                         "measured_wave_ms": measured_s * 1e3,
                         "wave_micro_batch": int(micro_batch),
                         "dispatch_overhead_ratio": ratio})

    @classmethod
    def from_compiled(cls, cm, stage_ms: Optional[Sequence[Dict]] = None,
                      probe_batch: int = 8) -> "ServiceModel":
        """Build the model for a ``CompiledTinyModel``: FIFO-model stage
        works plus a stage_latencies calibration at ``probe_batch``.

        Pass a precomputed ``stage_ms`` breakdown (e.g. the autotuner's
        ``seed_stage_ms``) to skip the probe; its batch must then be
        ``probe_batch``.
        """
        from repro_torch.deploy.autotune import default_sample
        from repro_torch.deploy.executor import stage_work

        works = [(s.name, stage_work(s)) for s in cm.schedule.stages]
        if stage_ms is None:
            stage_ms = cm.stage_latencies(default_sample(cm, probe_batch))
        measured_s = sum(s["ms"] for s in stage_ms) / 1e3
        model = cls(works=works, sec_per_cycle=1.0)
        cycles = model.wave_cycles(probe_batch)
        model.sec_per_cycle = measured_s / max(cycles, 1)
        model.calibration = {"probe_batch": int(probe_batch),
                             "measured_ms": measured_s * 1e3,
                             "modeled_cycles": int(cycles)}
        return model


@dataclasses.dataclass
class PredictedServiceModel(ServiceModel):
    """Predictor-priced service model for a COLD model — no probe, no
    completed wave, no ``stage_latencies`` run.

    ``predicted_s`` tables the learned wave-cost predictor's per-wave
    service estimate at each candidate micro-batch
    (``repro_torch.costmodel``); ``scale`` is the online correction factor
    ``recalibrated`` folds measured waves into. Off-table wave sizes are
    extrapolated with the FIFO model's *shape* (cycles ratio against the
    nearest tabled size) — the same stance as the calibrated base class,
    just anchored on a prediction instead of a probe. The first measured
    wave starts pulling ``scale`` toward reality (and the
    ``SLOController`` EWMA corrects on top), so cold-start pricing decays
    into the measured path with no mode switch.
    """

    predicted_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    scale: float = 1.0

    def wave_service_s(self, micro_batch: int) -> float:
        mb = int(micro_batch)
        if not self.predicted_s:
            return super().wave_service_s(mb)
        s = self.predicted_s.get(mb)
        if s is None:
            ref = min(sorted(self.predicted_s),
                      key=lambda m: (abs(m - mb), m))
            s = self.predicted_s[ref] * (
                self.wave_cycles(mb) / max(self.wave_cycles(ref), 1))
        return s * self.scale

    def recalibrated(self, measured_s: float, micro_batch: int
                     ) -> "PredictedServiceModel":
        modeled = self.wave_service_s(micro_batch)
        if measured_s <= 0 or modeled <= 0:
            return self
        ratio = measured_s / modeled
        return dataclasses.replace(
            self, scale=self.scale * ratio,
            calibration={**self.calibration,
                         "measured_wave_ms": measured_s * 1e3,
                         "wave_micro_batch": int(micro_batch),
                         "dispatch_overhead_ratio": ratio})

    @classmethod
    def from_predictor(cls, predictor, cm,
                       candidates: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)
                       ) -> "PredictedServiceModel":
        """Price a compiled model's waves from static structure alone.

        ``predictor`` is a ``repro_torch.costmodel.WaveCostPredictor`` (or
        anything with ``predict_ms(features_dict)``); the features come
        from the versioned extractor, so this runs zero probes and zero
        model executions — admission control for a model the server has
        never seen.
        """
        from repro_torch.costmodel.features import wave_features
        from repro_torch.deploy.executor import stage_work

        works = [(s.name, stage_work(s)) for s in cm.schedule.stages]
        table = {int(mb): float(predictor.predict_ms(wave_features(cm, mb)))
                 / 1e3
                 for mb in sorted({int(m) for m in candidates if m >= 1})}
        model = cls(works=works, sec_per_cycle=1.0, predicted_s=table)
        ref = min(table)
        model.sec_per_cycle = table[ref] / max(model.wave_cycles(ref), 1)
        model.calibration = {
            "source": "predicted",
            "feature_schema_version": int(getattr(predictor,
                                                  "schema_version", 0)),
            "candidates": sorted(table),
        }
        return model

    @classmethod
    def from_table(cls, works: List[Tuple[str, int]],
                   predicted_s: Dict[int, float]) -> "PredictedServiceModel":
        """Build directly from a predicted per-micro-batch table — the
        scripted-simulation entry point (no compiled model needed)."""
        table = {int(k): float(v) for k, v in predicted_s.items()}
        model = cls(works=list(works), sec_per_cycle=1.0,
                    predicted_s=table)
        ref = min(table)
        model.sec_per_cycle = table[ref] / max(model.wave_cycles(ref), 1)
        model.calibration = {"source": "predicted",
                             "candidates": sorted(table)}
        return model


def measure_wave_service_s(cm, micro_batch: int, iters: int = 5) -> float:
    """Median wall seconds of one padded wave through ``submit_wave`` —
    the probe ``ServiceModel.recalibrated`` consumes (one compile + one
    discarded warm iteration first, the ``stage_latencies`` convention)."""
    from repro_torch.deploy.autotune import default_sample
    from repro_torch.obs import timer as obs_timer

    x = default_sample(cm, micro_batch)
    for _ in range(2):                   # build + discarded warm
        y, _ = cm.submit_wave(x, micro_batch=micro_batch)
        _wait(y)
    times = []
    for _ in range(max(iters, 1)):
        t0 = obs_timer.now()
        y, _ = cm.submit_wave(x, micro_batch=micro_batch)
        _wait(y)
        times.append(obs_timer.now() - t0)
    times.sort()
    return times[len(times) // 2]


def _wait(y) -> None:
    """Block until a wave's output is computed: synchronise the CUDA
    device it lies on; CPU tensors are ready when returned."""
    if isinstance(y, torch.Tensor) and y.device.type == "cuda":
        torch.cuda.synchronize(y.device)


def queued_waves(n_pending: int, micro_batch: int, n_inflight: int = 0
                 ) -> int:
    """Waves an arriving request must wait out before its own wave
    completes, its own wave *excluded* (``SLOController.admit`` adds the
    +1 for it): queued work counted in waves plus every wave still in
    flight on a replica.

    The queued term is ``ceil((n_pending + 1) / micro_batch) - 1`` — the
    arriving request joins the queue and the total is rounded *up* to
    whole waves, so the partial wave it lands in is priced. (For a pure
    pending queue this equals ``n_pending // micro_batch``; the
    floor-division form the router used to inline only *looked* like it
    dropped the partial wave because of that identity — but it had no
    slot for in-flight waves at all, which is where the async router's
    real queue delay lives: a wave submitted but not completed still
    occupies a replica exactly like a queued one.)
    """
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    if n_pending < 0 or n_inflight < 0:
        raise ValueError(
            f"negative queue state: pending={n_pending} "
            f"inflight={n_inflight}")
    return (int(n_pending) + micro_batch) // micro_batch - 1 \
        + int(n_inflight)


class SLOController:
    """Per-model admission controller against a p99 latency budget.

    ``admit`` estimates the arriving request's completion latency —
    batching wait (it may sit out the full deadline) plus the backlog's
    service time plus its own wave's — and sheds when the estimate
    exceeds ``headroom * budget``. ``occupancy_estimate`` is the Little's
    law monitoring signal (windowed arrival rate times estimated time in
    system); ``utilization`` the offered-load / capacity ratio that tells
    the bench where saturation sits.
    """

    def __init__(self, p99_budget_ms: float, service: ServiceModel,
                 window_s: float = 10.0, headroom: float = 1.0,
                 ewma_alpha: float = 0.25):
        if p99_budget_ms <= 0:
            raise ValueError(f"p99_budget_ms must be > 0, got {p99_budget_ms}")
        self.p99_budget_ms = float(p99_budget_ms)
        self.service = service
        self.window_s = float(window_s)
        self.headroom = float(headroom)
        self.ewma_alpha = float(ewma_alpha)
        self._ratio = 1.0          # EWMA of measured / modeled service
        self._arrivals: Deque[float] = collections.deque()

    # -- service-time estimate (model x online correction) -----------------
    def wave_service_s(self, micro_batch: int) -> float:
        return self.service.wave_service_s(micro_batch) * self._ratio

    def observe_service(self, micro_batch: int, measured_s: float) -> None:
        modeled = self.service.wave_service_s(micro_batch)
        if modeled <= 0 or measured_s <= 0:
            return
        a = self.ewma_alpha
        self._ratio = (1 - a) * self._ratio + a * (measured_s / modeled)

    # -- arrival rate ------------------------------------------------------
    def observe_arrival(self, now: float) -> None:
        self._arrivals.append(now)
        cutoff = now - self.window_s
        while self._arrivals and self._arrivals[0] < cutoff:
            self._arrivals.popleft()

    def arrival_qps(self, now: float) -> float:
        if not self._arrivals:
            return 0.0
        span = max(now - self._arrivals[0], 1e-9)
        return len(self._arrivals) / span

    # -- queue-state estimates ---------------------------------------------
    def utilization(self, now: float, micro_batch: int) -> float:
        """Offered load over capacity: rho = lambda / saturation_qps."""
        cap = self.service.saturation_qps(micro_batch) / max(self._ratio, 1e-9)
        return self.arrival_qps(now) / max(cap, 1e-9)

    def occupancy_estimate(self, now: float, micro_batch: int,
                           max_wait_s: float = 0.0) -> float:
        """Little's law: L = lambda * W with W = batching wait + one wave
        of service. The steady-state queue length this arrival rate implies
        — the monitoring number reported next to the realized backlog."""
        w = max_wait_s + self.wave_service_s(micro_batch)
        return self.arrival_qps(now) * w

    def estimated_latency_s(self, backlog_waves: int, micro_batch: int,
                            max_wait_s: float, lag_s: float = 0.0,
                            n_workers: int = 1) -> float:
        """Completion estimate for a request admitted *now*: the time it
        already spent blocked behind the server (``lag_s`` — arrival to
        admission), worst-case batching wait, every queued or in-flight
        wave ahead of it, then its own wave's service.

        ``n_workers`` is the replica count draining the queue: an
        N-replica pool under a non-blocking engine retires up to N waves
        per service period, so the backlog's delay is
        ``ceil(waves / N)`` service *rounds*, not ``waves`` serial
        services (with ``n_workers=1`` this reduces exactly to the
        single-worker arithmetic)."""
        waves = int(backlog_waves) + 1
        rounds = -(-waves // max(int(n_workers), 1))
        return max(lag_s, 0.0) + max_wait_s \
            + rounds * self.wave_service_s(micro_batch)

    def admit(self, now: float, backlog_waves: int, micro_batch: int,
              max_wait_s: float, lag_s: float = 0.0,
              n_workers: int = 1) -> bool:
        est = self.estimated_latency_s(backlog_waves, micro_batch,
                                       max_wait_s, lag_s, n_workers)
        return est * 1e3 <= self.p99_budget_ms * self.headroom


def slo_operating_point(service: ServiceModel, p99_budget_ms: float,
                        candidates: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                        ) -> Dict[str, object]:
    """The SLO-constrained operating point for one model: the largest wave
    size whose modeled fill+drain stays inside the latency budget (bigger
    waves amortize dispatch overhead -> more throughput, but a full wave's
    service time bounds every member's latency from below). Returns the
    choice plus the scored candidate table (the bench's audit trail).
    """
    rows = []
    best = None
    for mb in sorted({int(m) for m in candidates if m >= 1}):
        s = service.wave_service_s(mb)
        fits = s * 1e3 <= p99_budget_ms
        rows.append({"micro_batch": mb, "service_ms": s * 1e3,
                     "saturation_qps": service.saturation_qps(mb),
                     "fits_budget": fits})
        if fits:
            best = rows[-1]
    if best is None:            # nothing fits: serve single queries anyway
        best = rows[0]
    return {"micro_batch": int(best["micro_batch"]),
            "service_ms": float(best["service_ms"]),
            "saturation_qps": float(best["saturation_qps"]),
            "fits_budget": bool(best["fits_budget"]),
            "candidates": rows}

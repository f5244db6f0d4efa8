"""Deterministic fault injection + the failure taxonomy for the serving
stack.

The port of ``repro.serve.faults``. Two places meet the card: the
integrity guard reads torch tensors as well as numpy arrays (cast to
float64 before ``abs``, which in int32 wraps ``INT32_MIN`` onto itself),
and ``FaultyModel`` corrupts a CUDA wave on its device and waits for the
wave before it stretches it (``submit_wave`` returns before the card has
finished).

The paper's accelerators sit behind a host–device boundary where the real
failure modes live: stalled DMA waves, hung replicas, transient submit
errors, silent numeric corruption. This module gives the router a typed
vocabulary for those failures and a *seedable, clock-driven* way to
inject them, exploiting the one asset this repo has that real clusters
don't — the whole server is an exact discrete-event simulation under
``ManualClock``, so chaos tests are byte-for-byte reproducible.

Three pieces:

  * **Taxonomy** — ``FaultError`` and its subclasses are the failures the
    router knows how to *survive* (retry on another replica, quarantine,
    shed with a reason code). Anything else escaping a wave is a bug and
    still propagates. ``WaveError`` wraps executor-side execution
    failures so raw backend exceptions never escape ``submit_wave``.
  * **FaultPlan / FaultSpec** — a deterministic schedule of injectable
    faults keyed by (replica, wave-index or clock-window). The sim layer
    (``serve.sim.ScriptedWaveModel``) consults the plan on every submit;
    the real path gets the same plan through ``FaultyModel``, a wrapper
    around any ``submit_wave`` executor.
  * **Integrity guard** — ``wave_integrity_ok`` is the cheap per-wave
    output check the router runs at settle time: finite, and in range
    against the lowering's proven integer bound (every exact fast path is
    proven ``< 2**24`` — ``deploy.lower._float_mm_safe`` — so any larger
    magnitude is corruption, not a big activation). ``corrupt_output``
    faults are caught here and routed to retry instead of being served.

See ``docs/faults.md`` for the taxonomy table, the replica health state
machine, and the retry/backoff pricing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import timer as obs_timer

# -- taxonomy ---------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of the failures the router survives (retry/quarantine/shed).

    Subclassing ``RuntimeError`` keeps legacy ``except RuntimeError``
    callers working; the router itself catches ``FaultError`` so
    *unexpected* exceptions (genuine bugs) still propagate loudly.
    """


class WaveError(FaultError):
    """A wave failed inside the executor: the typed wrapper around any
    backend/runtime exception escaping ``submit_wave`` execution (the
    input-validation ``ValueError``s are *not* wrapped — a malformed wave
    is a caller bug, not a device failure)."""


class WaveTimeout(FaultError):
    """An in-flight wave missed its deadline (lost response / hung
    device) and was cancelled by the router."""


class ReplicaCrashed(FaultError):
    """A replica refused the wave because it is down (crash outage)."""


class TransientSubmitError(FaultError):
    """Submission itself failed transiently (queue full, DMA hiccup);
    the wave never reached the device and is safe to retry anywhere."""


class CorruptWave(FaultError):
    """A completed wave failed the output integrity guard (non-finite or
    out of the proven integer range) — served to retry, never to a
    client."""


class NoReplicaAvailable(FaultError):
    """The pool has no replica to place a wave on: empty, or every
    replica quarantined with no probe due. The router sheds the wave with
    a distinct reason code instead of hanging."""


# -- output integrity guard -------------------------------------------------

#: The lowering exactness bound: every integer fast path is admitted only
#: when its worst-case magnitude is proven ``< 2**24`` (exact in float32 —
#: ``deploy.lower._float_mm_safe`` and the threshold-bank check). A healthy
#: wave can therefore never carry a magnitude past this; the float head's
#: logits are far smaller still. Anything bigger is corruption.
DEFAULT_OUTPUT_BOUND = float(1 << 24)


def wave_integrity_ok(y, bound: float = DEFAULT_OUTPUT_BOUND) -> bool:
    """Cheap per-wave output check: every value finite and within
    ``bound`` in magnitude. O(wave) numpy reductions — negligible next to
    the wave's own matmuls. Takes a numpy array or a tensor (on any
    device; the reduction runs there)."""
    if isinstance(y, torch.Tensor):
        if y.numel() == 0:
            return True
        if y.is_floating_point() and not bool(torch.isfinite(y).all()):
            return False
        return bool(y.to(torch.float64).abs().max() <= bound)
    y = np.asarray(y)
    if y.size == 0:
        return True
    if y.dtype.kind == "f" and not bool(np.isfinite(y).all()):
        return False
    return bool(np.abs(y.astype(np.float64, copy=False)).max() <= bound)


# -- the fault plan ---------------------------------------------------------

#: Injectable fault kinds (the ``FaultSpec.kind`` vocabulary).
FAULT_KINDS = ("wave_timeout", "replica_crash", "replica_slowdown",
               "corrupt_output", "transient_submit_error")


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: *what* happens on *which* replica, *when*.

    Keyed either by ``wave`` (the 1-based index of the submission attempt
    on that replica) or by a clock window ``[after_t, until_t)``. All
    kinds except ``replica_slowdown`` are consumable events
    (``n_times`` firings, then inert); a slowdown is a modifier that
    applies to every wave inside its window.

    ``factor`` scales service time for ``replica_slowdown``;
    ``duration_s`` is the outage length for ``replica_crash`` (``inf`` =
    never recovers on its own — only useful with the router's probe
    machinery disabled) and, when finite, how long a ``wave_timeout``'s
    response is delayed before the handle is abandoned.
    """

    kind: str
    replica: int = 0
    wave: Optional[int] = None
    after_t: Optional[float] = None
    until_t: float = math.inf
    factor: float = 2.0
    duration_s: float = math.inf
    n_times: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.wave is None and self.after_t is None:
            raise ValueError(
                "a FaultSpec needs a key: wave= (1-based wave index) or "
                "after_t= (clock-window start)")
        if self.kind == "replica_slowdown" and self.factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, "
                             f"got {self.factor}")

    def matches(self, replica: int, wave: int, now: float) -> bool:
        if replica != self.replica:
            return False
        if self.wave is not None:
            return wave == self.wave
        return self.after_t <= now < self.until_t


class FaultPlan:
    """A deterministic schedule of faults, shared by every replica of a
    pool (specs name their replica). ``active`` is the single consultation
    point: it returns the specs firing for this (replica, wave, now) and
    consumes one firing from each consumable spec, so a plan replayed
    under the same clock produces the identical fault sequence — the
    determinism the chaos suite's byte-identical-trace check rests on.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (),
                 seed: Optional[int] = None):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self._remaining = [s.n_times for s in self.specs]

    def __repr__(self):
        return f"FaultPlan({self.specs!r}, seed={self.seed!r})"

    def reset(self) -> None:
        """Re-arm every consumable spec (replaying the same run)."""
        self._remaining = [s.n_times for s in self.specs]

    def active(self, replica: int, wave: int, now: float
               ) -> List[FaultSpec]:
        out = []
        for i, s in enumerate(self.specs):
            if not s.matches(replica, wave, now):
                continue
            if s.kind == "replica_slowdown":     # modifier, never consumed
                out.append(s)
            elif self._remaining[i] > 0:
                self._remaining[i] -= 1
                out.append(s)
        return out

    @classmethod
    def chaos(cls, seed: int, n_replicas: int, horizon_s: float,
              n_faults: int = 4,
              kinds: Sequence[str] = FAULT_KINDS) -> "FaultPlan":
        """A seeded random plan: ``n_faults`` faults of the given kinds,
        uniformly placed over ``[0, horizon_s)`` across the replicas.
        Pure function of its arguments — two plans built from the same
        seed are identical, so a chaos run is reproducible end to end."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(int(n_faults)):
            kind = str(rng.choice(list(kinds)))
            t0 = float(rng.uniform(0.0, horizon_s))
            spec = FaultSpec(
                kind=kind,
                replica=int(rng.integers(0, max(n_replicas, 1))),
                after_t=t0,
                until_t=(t0 + float(rng.uniform(0.05, 0.25)) * horizon_s
                         if kind == "replica_slowdown" else math.inf),
                factor=float(rng.uniform(1.5, 4.0)),
                duration_s=float(rng.uniform(0.05, 0.25)) * horizon_s)
            specs.append(spec)
        return cls(specs, seed=seed)


# -- real-path injector -----------------------------------------------------


class FaultyModel:
    """Wrap any ``submit_wave`` executor with a ``FaultPlan`` — the real
    (compiled-model) counterpart of the scripted sim's injection.

    The wrapper is deliberately *synchronous* (``submit_wave_async`` is
    pinned to ``None`` so ``Replica.submit`` takes the sync path): faults
    fire inside the submit call, where the blocking engine — and the
    async engine's handle ``wait`` — will see them as typed exceptions.
    Everything else (``default_micro_batch``, ``schedule``, ...) passes
    through to the wrapped model, so the wrapper drops into a
    ``ReplicaPool`` wherever the real model did.
    """

    #: pin the async protocol off: Replica.submit probes this attribute
    #: and must fall through to ``submit_wave`` for faults to fire in-line
    submit_wave_async = None

    def __init__(self, model, plan: FaultPlan, replica: int = 0,
                 clock=None):
        self._model = model
        self.plan = plan
        self.replica = int(replica)
        self._clock = clock            # None -> the injectable obs timer
        self.n_attempts = 0
        self.crashed_until = -math.inf
        self.n_injected = 0

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock.now()
        return obs_timer.now()

    def _sleep(self, seconds: float) -> None:
        if seconds <= 0:
            return
        if self._clock is not None:
            self._clock.sleep(seconds)
        else:
            obs_timer.sleep(seconds)

    def submit_wave(self, x, valid=None, micro_batch=None):
        now = self._now()
        self.n_attempts += 1
        if now < self.crashed_until:
            raise ReplicaCrashed(
                f"replica {self.replica} is down until "
                f"t={self.crashed_until:.6f} (now t={now:.6f})")
        slowdown = 1.0
        corrupt = timeout = None
        for f in self.plan.active(self.replica, self.n_attempts, now):
            self.n_injected += 1
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
                slowdown *= f.factor
            elif f.kind == "corrupt_output":
                corrupt = f
            elif f.kind == "wave_timeout":
                timeout = f
        t0 = self._now()
        y, mask = self._model.submit_wave(x, valid=valid,
                                          micro_batch=micro_batch)
        if slowdown > 1.0:
            # on the card submit_wave returns before the wave is done: wait
            # for it, so the stretch scales the wave's time, not only its
            # host dispatch
            _wait_wave(y)
            self._sleep((slowdown - 1.0) * max(self._now() - t0, 0.0))
        if timeout is not None:
            if math.isfinite(timeout.duration_s):
                self._sleep(timeout.duration_s)
            raise WaveTimeout(
                f"replica {self.replica} wave {self.n_attempts}: "
                "response lost (injected)")
        if corrupt is not None:
            if isinstance(y, torch.Tensor):
                y = y.clone()             # on the wave's device
                if y.is_floating_point():
                    y[..., 0] = float("inf")
                else:
                    y[..., 0] += 1 << 26
            else:
                y = np.array(y)
                if y.dtype.kind == "f":
                    y[..., 0] = np.inf        # non-finite: integrity guard
                else:
                    y[..., 0] = y[..., 0] + (1 << 26)   # beyond 2**24
        return y, mask


def _wait_wave(y) -> None:
    """Block until a wave's output ``y`` is computed: a CUDA tensor waits
    for the current stream of its device (the one the wave was launched
    on); anything else is ready when returned."""
    if isinstance(y, torch.Tensor) and y.device.type == "cuda":
        torch.cuda.current_stream(y.device).synchronize()


def faulty_pool(pool, plan: FaultPlan, clock=None):
    """Wrap every replica of an existing ``ReplicaPool`` in a
    ``FaultyModel`` sharing one plan (replica indices line up with the
    plan's ``FaultSpec.replica`` keys). Returns the pool, mutated."""
    for r in pool.replicas:
        r.model = FaultyModel(r.model, plan, replica=r.index, clock=clock)
    return pool

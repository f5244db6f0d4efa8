"""Dispatch engines: how assembled waves reach replicas.

The port of ``repro.serve.dispatch``: a wave on the card is tracked by a
``torch.cuda.Event`` where the reference asks the JAX array
(``ready()`` is ``Event.query``, ``wait()`` is ``Event.synchronize``).

The router's batching policy (when a wave forms) is separate from its
dispatch policy (how the wave's execution relates to the submit path),
and the second one is what this module makes injectable:

  * ``SyncEngine`` — submit and block. The wave completes inside
    ``Router._dispatch`` before the next line runs, exactly the pre-engine
    semantics: under ``ManualClock`` the scripted executor advances the
    clock during the blocking call and every existing hand-simulated trace
    stays bit-identical.

  * ``AsyncEngine`` — submit and return. ``Replica.submit`` launches the
    wave (``submit_wave`` under the replica's CUDA stream; the kernels are
    queued, not finished, when the call returns) and hands back a
    ``WaveHandle`` holding a CUDA event recorded right after the launch;
    the router parks it in an in-flight table and *reaps* completions on
    its next event-loop pass. Waves on different replicas
    overlap — the pool finally runs as wide as it is — and each replica is
    double-buffered up to ``max_inflight`` waves before the engine applies
    backpressure by reaping its oldest wave.

Both engines speak one protocol — ``dispatch`` returns either a completed
wave or an in-flight handle — so the router's completion bookkeeping
(metrics, SLO feedback, pool credit, trace spans) lives in exactly one
place, ``Router._complete``, no matter which engine is driving.

Discrete-event testing survives the split: a scripted model can expose
``submit_wave_async`` returning an object with ``ready_t`` (absolute
completion time on the injected clock) and ``wait()``; the handle then
reports readiness against the manual clock and ``Router.reap`` settles
completions in ``ready_t`` order, so two overlapping waves on two
replicas take max — not sum — of their service times, exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.serve.faults import WaveTimeout


class WaveHandle:
    """One in-flight wave on one replica.

    Wraps either a model-level async handle (``submit_wave_async`` — the
    scripted-fake path) or raw ``submit_wave`` outputs. For a wave on the
    card, ``event`` is a ``torch.cuda.Event`` recorded on the replica's
    stream right after the launch; outputs on the CPU (or numpy) are
    ready when returned.

    ``ready_t`` is the absolute completion time on the injected clock when
    the model can script it (manual-clock fakes), else ``None`` (real
    devices don't pre-announce). ``done_t`` is set by ``wait()`` when the
    model knows the true completion instant; the router falls back to its
    own clock reading otherwise.

    ``deadline_t`` is the router's wave timeout (submit time + the lane's
    service estimate x ``RouterConfig.wave_timeout_mult``), ``None`` when
    timeouts are off. A wave still unfinished past its deadline is
    ``cancel``-ed: the handle reports not-ready forever after, and a
    late ``wait`` raises ``WaveTimeout`` instead of handing a client a
    result the router already re-dispatched elsewhere.
    """

    def __init__(self, replica, y=None, mask=None, *, inner=None,
                 event=None):
        self.replica = replica
        self._y = y
        self._mask = mask
        self._event = event           # torch.cuda.Event after the launch
        self._inner = inner           # model-level async handle, if any
        self._result: Optional[Tuple[object, object]] = None
        self.ready_t: Optional[float] = getattr(inner, "ready_t", None)
        self.done_t: Optional[float] = None
        self.deadline_t: Optional[float] = None
        self.cancelled = False

    def cancel(self) -> None:
        """Abandon the wave: the device may still finish it, but its
        result must never reach a client (the router re-dispatched the
        requests). Idempotent; a completed handle keeps its result."""
        if self._result is None:
            self.cancelled = True

    def ready(self, now: Optional[float] = None) -> bool:
        """Non-blocking readiness probe. Scripted handles compare their
        ``ready_t`` against the caller's clock; a wave on the card asks
        its event (``query``); anything else is ready when returned."""
        if self._result is not None:
            return True
        if self.cancelled:
            return False
        if self.ready_t is not None:
            return now is not None and now >= self.ready_t
        if self._event is not None:
            return bool(self._event.query())
        return True

    def wait(self) -> Tuple[object, object]:
        """Block until the wave's result is materialized (idempotent).
        A cancelled handle raises ``WaveTimeout`` instead of blocking —
        the wave was abandoned past its deadline and its requests live
        elsewhere now."""
        if self._result is not None:
            return self._result
        if self.cancelled:
            raise WaveTimeout(
                f"wave on replica {getattr(self.replica, 'index', '?')} "
                "was cancelled past its deadline")
        if self._inner is not None:
            y, mask = self._inner.wait()
            self.done_t = getattr(self._inner, "done_t", self.ready_t)
        else:
            y, mask = self._y, self._mask
            if self._event is not None:
                self._event.synchronize()
        self._result = (y, mask)
        return self._result


class DispatchEngine:
    """Protocol: ``submit`` launches a wave on a replica, returning a
    ``WaveHandle``; ``blocking`` tells the router whether to complete the
    wave inline (sync) or park the handle in its in-flight table (async)."""

    blocking = True
    #: per-replica in-flight ceiling before the router must reap (the
    #: async engine's backpressure knob; irrelevant when blocking)
    max_inflight = 1

    def submit(self, replica, x, valid=None, micro_batch=None) -> WaveHandle:
        return replica.submit(x, valid=valid, micro_batch=micro_batch)


class SyncEngine(DispatchEngine):
    """Blocking dispatch: today's semantics, bit-exact. The wave is
    submitted and waited on inside the router's dispatch call, so manual
    clocks advance inside ``_dispatch`` exactly as before the engine
    split."""

    blocking = True
    max_inflight = 1


class AsyncEngine(DispatchEngine):
    """Non-blocking dispatch: submit the wave, return the handle, let the
    router overlap waves across replicas and reap completions on its next
    event-loop pass.

    ``max_inflight`` bounds uncompleted waves per replica (2 =
    double-buffering: one executing, one queued behind it); at the bound
    the router block-reaps the replica's oldest wave before submitting —
    backpressure instead of unbounded device queues.
    """

    blocking = False

    def __init__(self, max_inflight: int = 2):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = int(max_inflight)

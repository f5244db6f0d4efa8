"""Spans, instant events, and counter series for the compile→execute→serve
stack.

The paper's credibility rests on per-stage accounting (II/FIFO tables,
auditable µs latencies); this tracer is that discipline applied to our own
runtime. Every layer records into one ``Tracer``:

  * **spans** — named intervals with a category, a ``(pid, tid)``
    attribution (exported as Perfetto process/track), and free-form args.
    ``tracer.span(...)`` is a context manager; ``add_span`` records a
    finished interval from explicit timestamps (how the router records a
    request's arrival→completion after the fact).
  * **instants** — point events (``enqueue``, ``admit``, ``shed``).
  * **counters** — time series (queue backlog, FIFO occupancy, replica
    outstanding work) rendered as counter tracks.

Events land in a bounded ring (oldest dropped first, drop count kept), so
a long-running server can stay traced without unbounded memory. Appends
are lock-protected — the router's threads and the host queue loop may
interleave. Time comes from an injectable clock (any object with
``now()``); under a manual clock a traced run is a deterministic
discrete-event record. This module is a copy of ``repro.obs.tracer``.

``NULL_TRACER`` is the default everywhere: a ``NullTracer`` whose methods
are no-ops returning shared singletons, so the disabled path costs one
attribute lookup and an empty call — nothing allocates, nothing locks.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.obs import timer as _timer

#: Event kinds (``TraceEvent.kind``).
SPAN, INSTANT, COUNTER = "span", "instant", "counter"


@dataclasses.dataclass
class TraceEvent:
    """One recorded event. ``t1`` is meaningful for spans only; ``value``
    for counters only. Times are seconds in the tracer's clock domain."""

    kind: str
    name: str
    cat: str
    t0: float
    t1: float = 0.0
    pid: int = 0
    tid: int = 0
    value: float = 0.0
    args: Optional[Dict] = None
    seq: int = 0                  # record order (stable export tiebreak)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _Span:
    """Live span handle: ``with tracer.span(...) as sp: sp.set(k=v)``.
    Records on exit; ``set`` attaches args discovered mid-span (the
    dispatch span learns its measured service time this way)."""

    __slots__ = ("_tracer", "name", "cat", "pid", "tid", "args", "t0")

    def __init__(self, tracer, name, cat, pid, tid, args):
        self._tracer = tracer
        self.name, self.cat = name, cat
        self.pid, self.tid = pid, tid
        self.args = args
        self.t0 = 0.0

    def set(self, **kwargs) -> "_Span":
        if self.args is None:
            self.args = {}
        self.args.update(kwargs)
        return self

    def __enter__(self) -> "_Span":
        self.t0 = self._tracer.now()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.add_span(self.name, self.t0, self._tracer.now(),
                              cat=self.cat, pid=self.pid, tid=self.tid,
                              args=self.args)
        return False


class _NullSpan:
    """Shared do-nothing span: the NullTracer's context manager."""

    __slots__ = ()

    def set(self, **kwargs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffered, thread-safe event recorder with an injectable clock.

    ``clock`` is any object with ``now()`` (``serve.clock.SystemClock`` /
    ``ManualClock``); ``None`` reads the process-wide ``obs.timer`` — the
    same source the instrumented code measures with, so spans and manual
    timings never disagree. ``capacity`` bounds memory: the oldest events
    fall off first and ``n_dropped`` counts them (an exporter that claims
    completeness must check it).
    """

    enabled = True

    def __init__(self, clock: Optional[object] = None,
                 capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._clock = clock
        self.capacity = int(capacity)
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.n_dropped = 0

    # -- time --------------------------------------------------------------
    def now(self) -> float:
        return self._clock.now() if self._clock is not None \
            else _timer.now()

    # -- recording ---------------------------------------------------------
    def _record(self, ev: TraceEvent) -> None:
        with self._lock:
            ev.seq = self._seq
            self._seq += 1
            if len(self._events) == self.capacity:
                self.n_dropped += 1
            self._events.append(ev)

    def span(self, name: str, cat: str = "", pid: int = 0, tid: int = 0,
             **args) -> _Span:
        """Context manager timing a block into one span event."""
        return _Span(self, name, cat, pid, tid, args or None)

    def add_span(self, name: str, t0: float, t1: float, cat: str = "",
                 pid: int = 0, tid: int = 0,
                 args: Optional[Dict] = None) -> None:
        """Record a finished interval from explicit clock readings."""
        self._record(TraceEvent(SPAN, name, cat, float(t0), float(t1),
                                pid, tid, args=args))

    def instant(self, name: str, t: Optional[float] = None, cat: str = "",
                pid: int = 0, tid: int = 0, **args) -> None:
        t = self.now() if t is None else float(t)
        self._record(TraceEvent(INSTANT, name, cat, t, t, pid, tid,
                                args=args or None))

    def counter(self, name: str, value: float, t: Optional[float] = None,
                cat: str = "", pid: int = 0, tid: int = 0) -> None:
        """One sample of a counter series (rendered as a counter track)."""
        t = self.now() if t is None else float(t)
        self._record(TraceEvent(COUNTER, name, cat, t, t, pid, tid,
                                value=float(value)))

    # -- reading -----------------------------------------------------------
    def events(self, kind: Optional[str] = None, name: Optional[str] = None,
               cat: Optional[str] = None) -> List[TraceEvent]:
        """Snapshot of the ring (record order), optionally filtered."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if name is not None:
            evs = [e for e in evs if e.name == name]
        if cat is not None:
            evs = [e for e in evs if e.cat == cat]
        return evs

    def spans(self, name: Optional[str] = None,
              cat: Optional[str] = None) -> List[TraceEvent]:
        return self.events(kind=SPAN, name=name, cat=cat)

    def counters(self, name: Optional[str] = None) -> List[TraceEvent]:
        return self.events(kind=COUNTER, name=name)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self.n_dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __bool__(self) -> bool:
        # without this, __len__ makes an *empty* tracer falsy and
        # ``tracer or NULL_TRACER`` silently discards a fresh tracer
        # before its first event; a real tracer is always truthy
        return True


class NullTracer:
    """The disabled tracer: every method is a no-op over shared singletons.

    This is the default ``tracer=`` everywhere, so the instrumented hot
    paths pay only an attribute lookup and an empty call when tracing is
    off — no allocation, no lock, no clock read. ``enabled`` lets bulk
    recorders (the host queue loop's per-hop occupancy counters) skip
    entire loops in one branch.
    """

    enabled = False
    capacity = 0
    n_dropped = 0

    def now(self) -> float:
        return 0.0

    def span(self, name: str, cat: str = "", pid: int = 0, tid: int = 0,
             **args) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def counter(self, *a, **kw) -> None:
        pass

    def events(self, *a, **kw) -> List[TraceEvent]:
        return []

    spans = events
    counters = events

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def __bool__(self) -> bool:
        # deliberately falsy: the disabled tracer is the "no tracing"
        # sentinel, so ``tracer or NULL_TRACER`` and enabled-style checks
        # both treat it as absent
        return False


#: The shared default NullTracer instance.
NULL_TRACER = NullTracer()

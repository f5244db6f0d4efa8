"""Reduction of a profiler trace (Chrome JSON) to what the readers need.

The traced window is the ``tinybench.window`` annotation; the host spans
are the loop's ``tinybench.<name>`` annotations (``loadgen``, ``call``,
``copy_out``); the device's operations are the trace's kernel, memcpy and
memset events. Every time is clipped to the window and given in seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "tinybench."
WINDOW = SPAN_PREFIX + "window"


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float
    dur: float


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    ops: List[DeviceOp]
    #: host spans, (start, end, name), sorted by start
    spans: List[Tuple[float, float, str]]
    busy: List[Tuple[float, float]]
    calls: int = 0
    rows: int = 0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    @property
    def op_s(self) -> float:
        """Sum of every device operation's time (overlaps counted)."""
        return sum(o.dur for o in self.ops)

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            out[o.name] += o.dur
        return dict(out)

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's idle intervals: no device operation running."""
        out, t = [], 0.0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by what the host was doing: each gap split over
        the loop's spans that overlap it, "none" where no span was open
        (the loop's own bookkeeping). The spans follow one another and do
        not nest."""
        ends = [e for _, e, _ in self.spans]
        out: Dict[str, float] = defaultdict(float)
        for g0, g1 in self.gaps():
            covered = 0.0
            i = bisect.bisect_right(ends, g0)
            while i < len(self.spans) and self.spans[i][0] < g1:
                s, e, n = self.spans[i]
                d = min(e, g1) - max(s, g0)
                if d > 0:
                    out[n] += d
                    covered += d
                i += 1
            if g1 - g0 > covered:
                out["none"] += g1 - g0 - covered
        return dict(out)


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(events: List[dict]) -> TraceSummary:
    """Reduce the trace's events (``traceEvents``) to the window's."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW and "cat" in e
           and "gpu" not in e["cat"]]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} window annotations")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        a, b = max(s, w0), min(s + d, w1)
        if b <= a:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(DeviceOp(e["name"], cat, (a - w0) / 1e6,
                                (b - a) / 1e6))
        elif (cat == "user_annotation" and e["name"] != WINDOW
              and e["name"].startswith(SPAN_PREFIX)):
            spans.append(((a - w0) / 1e6, (b - w0) / 1e6,
                          e["name"][len(SPAN_PREFIX):]))
    spans.sort()
    busy = merge([(o.start, o.start + o.dur) for o in ops])
    return TraceSummary(window_s=(w1 - w0) / 1e6, ops=ops, spans=spans,
                        busy=busy)


def load(path: str) -> TraceSummary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])


def breakdown(t: TraceSummary, top: int = 10) -> Dict[str, list]:
    ops = sorted(t.seconds_by_name().items(), key=lambda kv: -kv[1])
    gaps = sorted(t.idle_by_span().items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}

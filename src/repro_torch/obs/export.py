"""Trace exporters: Chrome trace-event JSON (Perfetto / ``chrome://tracing``)
and flat JSONL. A copy of ``repro.obs.export`` over the port's tracer.

The Chrome export maps the tracer's attribution onto Perfetto's model —
``pid`` becomes a process row (pid 0 the router, pid 1+N replica N, by the
serve instrumentation's convention), ``tid`` a track inside it (one per
lane / segment / FIFO), spans become ``"X"`` complete events, instants
``"i"``, counter series ``"C"`` counter tracks. Open the file with
https://ui.perfetto.dev (or ``chrome://tracing``) and the server run reads
as a timeline: request tracks over router lanes, wave execution on replica
rows, backlog and FIFO occupancy as counter plots underneath.

Serialization is **deterministic**: events export in record order, keys
are sorted, separators fixed, timestamps are exact float arithmetic on the
recorded clock readings — so two runs under the same manual clock
schedule produce byte-identical files, and the same bytes as
``repro.obs.export`` writes for the same events
(``tests/test_torch_obs.py``).

The JSONL export is the flat machine-readable form (one event per line)
for downstream analysis — the prediction-error training set of
``obs.report`` reads either representation.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.tracer import COUNTER, INSTANT, SPAN, TraceEvent, Tracer


def _sanitize(args: Optional[Dict]) -> Optional[Dict]:
    """Args become plain JSON: numpy scalars and 0-d torch tensors (on any
    device) unwrap to the Python bool, int or float the reference writes
    for the equal numpy scalar; everything else that isn't a JSON
    primitive stringifies (determinism requires values whose text form is
    stable — no default object reprs with addresses)."""
    if not args:
        return None

    def scalar(v):
        # a 0-d tensor's shape, torch.Size([]), equals () as well
        item = getattr(v, "item", None)
        if item is not None and getattr(v, "shape", None) == ():
            v = item()
        return v

    out = {}
    for k, v in args.items():
        v = scalar(v)
        if isinstance(v, (bool, int, float, str, type(None))):
            out[str(k)] = v
        elif isinstance(v, (list, tuple)):
            out[str(k)] = [x if isinstance(x, (bool, int, float, str))
                           else str(x) for x in map(scalar, v)]
        else:
            out[str(k)] = str(v)
    return out


def chrome_events(events: List[TraceEvent],
                  process_names: Optional[Dict[int, str]] = None,
                  thread_names: Optional[Dict[Tuple[int, int], str]] = None,
                  ) -> List[Dict]:
    """Convert tracer events to Chrome trace-event dicts (ts/dur in µs)."""
    out: List[Dict] = []
    for pid in sorted(process_names or {}):
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": process_names[pid]}})
    for pid, tid in sorted(thread_names or {}):
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": thread_names[(pid, tid)]}})
    for e in events:
        base = {"name": e.name, "cat": e.cat or "trace",
                "ts": e.t0 * 1e6, "pid": e.pid, "tid": e.tid}
        if e.kind == SPAN:
            base.update(ph="X", dur=(e.t1 - e.t0) * 1e6)
            args = _sanitize(e.args)
            if args:
                base["args"] = args
        elif e.kind == INSTANT:
            base.update(ph="i", s="t")
            args = _sanitize(e.args)
            if args:
                base["args"] = args
        elif e.kind == COUNTER:
            base.update(ph="C", args={e.name: e.value})
        else:  # pragma: no cover — tracer only records the three kinds
            continue
        out.append(base)
    return out


def chrome_json(tracer: Tracer,
                process_names: Optional[Dict[int, str]] = None,
                thread_names: Optional[Dict[Tuple[int, int], str]] = None,
                meta: Optional[Dict] = None) -> str:
    """The full Chrome trace document as a deterministic JSON string."""
    doc = {
        "traceEvents": chrome_events(tracer.events(), process_names,
                                     thread_names),
        "displayTimeUnit": "ms",
        "otherData": {"n_dropped": tracer.n_dropped,
                      **(_sanitize(meta) or {})},
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


def export_chrome(tracer: Tracer, path: str,
                  process_names: Optional[Dict[int, str]] = None,
                  thread_names: Optional[Dict[Tuple[int, int], str]] = None,
                  meta: Optional[Dict] = None) -> str:
    """Write the Perfetto-loadable trace file; returns the path."""
    text = chrome_json(tracer, process_names, thread_names, meta)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def jsonl_lines(tracer: Tracer) -> List[str]:
    """One deterministic JSON object per event, record order."""
    lines = []
    for e in tracer.events():
        d = {"kind": e.kind, "name": e.name, "cat": e.cat,
             "t0": e.t0, "t1": e.t1, "pid": e.pid, "tid": e.tid,
             "seq": e.seq}
        if e.kind == COUNTER:
            d["value"] = e.value
        args = _sanitize(e.args)
        if args:
            d["args"] = args
        lines.append(json.dumps(d, sort_keys=True, separators=(",", ":")))
    return lines


def export_jsonl(tracer: Tracer, path: str) -> str:
    """Write the flat JSONL form; returns the path."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        for line in jsonl_lines(tracer):
            f.write(line + "\n")
    return path

"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result line's contents.

``run_cell`` does all of it on the device it is given; ``run.py`` is the
command line, which asks for a card first. The tests drive ``run_cell``
on the CPU at small sizes, with the program's own CPU path.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from tinybench import counts, layout, loadgen, trace
from tinybench.reference import reference_logits, row_gaps

#: Seed stream of the check's sample, apart from the pool's and the
#: weights'.
CHECK_STREAM = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str):
    from torch.profiler import record_function

    return record_function(trace.SPAN_PREFIX + name)


def traced_window(call, fetch, pool, rows, seconds, first, device,
                  max_calls=None):
    """The closed loop under ``torch.profiler`` (host and device), reduced
    to a ``trace.TraceSummary``; the Chrome trace goes to the temporary
    directory and is removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        with record_function(trace.WINDOW):
            rec = loadgen.closed_loop(call, fetch, pool, rows, seconds,
                                      first=first, span=_span,
                                      max_calls=max_calls)
        _sync(device)
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(prefix="tinybench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = trace.load(path)
    finally:
        os.remove(path)
    summary.calls, summary.rows = rec.calls, rec.rows
    return summary, rec


def _sample(rec: loadgen.Records, n: int, seed: int) -> np.ndarray:
    """Indices of the calls the check compares: ``n`` of the window's
    calls drawn from the seed (all of them where it has fewer)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        CHECK_STREAM]))
    if rec.calls <= n:
        return np.arange(rec.calls)
    return np.sort(rng.choice(rec.calls, size=n, replace=False))


def check(graph: dict, pool: np.ndarray, rec: loadgen.Records,
          picked: np.ndarray, limits: Dict[str, float], device,
          answers: Optional[Callable] = None) -> dict:
    """The check of a window's sampled calls against the plain reference:
    ``numbers``, each compared number with its limit (the widest logit
    gap), ``rows`` checked and ``wrong``, the rows past the limit.
    ``answers(codes)``, where given, stands in the program's place (the
    control)."""
    rows = rec.rows_per_call
    codes = np.concatenate([pool[rec.first[i]:rec.first[i] + rows]
                            for i in picked])
    ref, nonzero = reference_logits(graph, codes, device=device)
    got = (answers(codes) if answers is not None
           else np.concatenate([rec.logits[i] for i in picked]))
    log("nonzero code share by stage (reference, checked rows): " + ", ".join(
        f"{k} {v:.4f}" for k, v in nonzero.items()))
    limit = float(limits["logit_gap"])
    gaps = row_gaps(got, ref)
    return {"numbers": {"logit_gap": {"value": float(gaps.max()),
                                      "limit": limit}},
            "rows": int(codes.shape[0]), "wrong": int((gaps > limit).sum())}


def run_cell(cell_name: str, seed: int, seconds: float, trace_on: bool,
             device="cuda", t_start: Optional[float] = None,
             traffic_override: Optional[dict] = None,
             root: Optional[Path] = None,
             control: Optional[str] = None) -> dict:
    """One run of ``cell_name``; returns the result line's object (the
    ``checks`` key last). ``control`` names a precision of the reference
    (``reference.PRECISIONS``) that stands in the program's place in the
    check: the control, which the check must reject."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.core.qir import Graph
    from repro_torch.deploy.executor import compile_graph

    if int(seed) < 0:
        raise ValueError("--seed must be a whole number >= 0")
    device = torch.device(device)
    spec = layout.resolve(cell_name, root)
    cfg, mix = spec["config"], dict(spec["traffic"])
    mix.update(traffic_override or {})
    scenario = layout.scenario(mix["scenario"], root)
    rows = int(mix["rows_per_call"])

    # set-up: the graph from the seed, the program, the pool, warm-up
    marks = [("imports", time.perf_counter())]
    graph = layout.graph_family(cfg["family"], root).make_graph(cfg, seed)
    text = json.dumps(graph)
    marks.append(("graph", time.perf_counter()))
    g = Graph.from_json(text)
    model = compile_graph(g, in_scale=float(g.meta["in_scale"]),
                          device=device)
    del g, text
    call = model.offline
    marks.append(("compile_graph", time.perf_counter()))

    def fetch(y):
        return y.cpu().numpy()

    pool = loadgen.make_pool(seed, int(mix["pool_samples"]),
                             (int(cfg["in_hw"]), int(cfg["in_hw"]),
                              int(cfg["in_ch"])))
    marks.append(("pool", time.perf_counter()))
    # the pool is walked on from call to call: warm-up, window, trace
    sent = loadgen.closed_loop(call, fetch, pool, rows, 3600.0,
                                 max_calls=1).calls
    marks.append(("first call (build, capture)", time.perf_counter()))
    sent += loadgen.closed_loop(call, fetch, pool, rows, 3600.0,
                                  first=sent,
                                  max_calls=int(mix["warmup_calls"])).calls
    marks.append(("warm-up calls", time.perf_counter()))
    if trace_on:
        sent += traced_window(call, fetch, pool, rows, 3600.0, sent,
                                device, max_calls=1)[1].calls
        marks.append(("profiler warm-up", time.perf_counter()))
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    setup_s = time.perf_counter() - t_start
    log("set-up s: " + ", ".join(
        f"{n} {t - (marks[i - 1][1] if i else t_start):.3f}"
        for i, (n, t) in enumerate(marks)) + f"; total {setup_s:.3f}")

    rec = loadgen.closed_loop(call, fetch, pool, rows, seconds, first=sent)
    log(scenario.describe(rec))
    summary = None
    if trace_on:
        summary, _ = traced_window(call, fetch, pool, rows,
                                   float(mix["trace_seconds"]),
                                   sent + rec.calls, device)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    result: dict = {"correct": False, "attempted": rec.rows, "failed": 0}
    if trace_on:
        ctx = types.SimpleNamespace(
            scenario=mix["scenario"], rows_per_call=rows, graph=graph,
            ops_per_inference=counts.ops_per_inference(graph), window=rec,
            trace=summary)
        metrics = {}
        for name, reader in layout.metric_readers(root).items():
            v = reader.read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": reader.UNIT}
        result["metrics"] = metrics
    else:
        metrics = dict(scenario.metrics(rec))
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device.type == "cuda"
                        else "cpu", "kind": kind, "count": 1,
                        "memory_peak_bytes": peak}
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = trace.breakdown(summary)
        log(f"traced window: {summary.calls} calls in "
            f"{summary.window_s:.6f} s, device busy {summary.busy_s:.6f} s")

    # the check, once the program's state is freed
    picked = _sample(rec, int(mix["check_calls"]), seed)
    del call, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    answers = None
    if control is not None:
        def answers(codes):
            return reference_logits(graph, codes, device=device,
                                    precision=control)[0]
    verdict = check(graph, pool, rec, picked, spec["cell"]["limits"], device,
                    answers=answers)
    log(f"check: {verdict['rows']} rows of {len(picked)} calls against "
        f"the reference in {time.perf_counter() - t0:.3f} s")
    checks = verdict["numbers"]
    result["failed"] = verdict["wrong"]
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    return result


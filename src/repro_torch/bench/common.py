"""Shared benchmark helpers of the port: uniform rows (name, us_per_call,
derived), banners, machine-readable artifacts (``BENCH_*.json``), and the
device timer.

``row``, ``banner``, ``print_rows`` and ``emit_json`` are copies of
``benchmarks/common.py``'s, with the provenance of the port (torch and its
device in place of JAX). ``time_ms`` times device work by CUDA-graph
replay.
"""

from __future__ import annotations

import datetime
import json
import os
import platform
import statistics
import subprocess
from typing import Any, Dict, List

import torch

from repro_torch.obs import timer as obs_timer


def row(name: str, us: float = 0.0, **derived) -> Dict[str, Any]:
    return {"name": name, "us_per_call": us, "derived": derived}


def print_rows(rows: List[Dict[str, Any]]):
    for r in rows:
        d = ";".join(f"{k}={v}" for k, v in r["derived"].items())
        print(f"{r['name']},{r['us_per_call']:.3f},{d}", flush=True)


def banner(title: str):
    print(f"\n=== {title} " + "=" * max(0, 70 - len(title)), flush=True)


def bench_dir() -> str:
    """Where BENCH_*.json artifacts land (``REPRO_BENCH_DIR``, default the
    working directory)."""
    return os.environ.get("REPRO_BENCH_DIR", ".")


def git_sha() -> str:
    """Short sha of HEAD, or "" outside a git checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def device_kind() -> str:
    """The card's name, or "cpu" where there is none."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def provenance() -> Dict[str, str]:
    """Git sha, platform string, torch and CUDA versions, device, UTC time."""
    stamp = datetime.datetime.fromtimestamp(obs_timer.walltime(),
                                            datetime.timezone.utc)
    return {
        "git_sha": git_sha(),
        "platform": platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": str(torch.version.cuda),
        "device_kind": device_kind(),
        "timestamp_utc": stamp.isoformat(timespec="seconds"),
    }


def emit_json(name: str, payload: Dict[str, Any],
              directory: str = None) -> str:
    """Write one benchmark artifact with its schema version, platform and
    provenance; returns the path written."""
    directory = bench_dir() if directory is None else directory
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    doc = {
        "schema": 1,
        "backend": "torch-cuda" if torch.cuda.is_available() else "torch-cpu",
        "machine": platform.machine(),
        "python": platform.python_version(),
        "provenance": provenance(),
        **payload,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    print(f"wrote {path}", flush=True)
    return path


def time_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the median over ``reps``
    replays of a CUDA graph that holds ``inner`` back-to-back calls, timed
    with CUDA events, after one warm call on a side stream. Replay leaves
    out the host's dispatch of each call (Python, ctypes, allocation: tens
    of µs, more than a small kernel), which event timing of eager calls
    would measure instead. Inputs stay in L2 between calls, as weights
    and banks do between the blocks of one wave."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        vals.append(a.elapsed_time(b) / inner)
    del graph
    return statistics.median(vals)

"""MLPerf Tiny SingleStream: the 90th percentile query latency.

A query runs from its sending to its logits on the host; the next one is
sent when they are there. ``singlestream_p90_ms`` is the nearest-rank
90th percentile over all the window's queries, which MLPerf Tiny scores;
the count and the other percentiles go on an earlier line.
"""

from tinybench.loadgen import nearest_rank


def metrics(rec) -> dict:
    return {"singlestream_p90_ms": {
        "value": nearest_rank(rec.latencies_s(), 0.9) * 1e3, "unit": "ms"}}


def describe(rec) -> str:
    lat = rec.latencies_s()
    q = {p: nearest_rank(lat, p / 100) * 1e3 for p in (50, 90, 99)}
    fifths = [nearest_rank(lat[p], 0.9) * 1e3 for p in rec.parts(5)
              if len(p)]
    return (f"singlestream: {rec.calls} queries in {rec.elapsed_s:.6f} s; "
            f"ms p50 {q[50]:.6f}, p90 {q[90]:.6f}, p99 {q[99]:.6f}, "
            f"max {lat.max() * 1e3:.6f}, mean {lat.mean() * 1e3:.6f}; "
            f"p90 ms by fifth of the window "
            + " ".join(f"{v:.6f}" for v in fifths))

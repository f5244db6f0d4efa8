"""MLPerf Offline: the rate of inferences over the whole window.

``offline_qps`` is every inference whose logits reached the host in the
window, over the window's seconds, from its start to the last logits on
the host: all the work over all the time, so a stalled call lowers it.
The median call time goes on an earlier line, never in its place.
"""

import numpy as np


def metrics(rec) -> dict:
    return {"offline_qps": {"value": rec.rows / rec.elapsed_s,
                            "unit": "inferences/s"}}


def describe(rec) -> str:
    lat = rec.latencies_s() * 1e3
    fifths = [len(p) * rec.rows_per_call / (rec.elapsed_s / 5)
              for p in rec.parts(5)]
    return (f"offline: {rec.calls} calls of {rec.rows_per_call} rows, "
            f"{rec.rows} inferences in {rec.elapsed_s:.6f} s; call ms "
            f"median {np.median(lat):.6f}, max {lat.max():.6f}; "
            f"inferences/s by fifth of the window "
            + " ".join(f"{q:.1f}" for q in fifths))

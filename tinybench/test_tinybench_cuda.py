"""The command on the card, one short run a cell and trace mode. Marked
``cuda``: it skips where no CUDA device is present. On the card:

    python -m pytest -q -m cuda tinybench/test_tinybench_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tinybench import layout

pytestmark = pytest.mark.cuda
CHECKOUT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["cnv_w1a1.offline_b1024",
                                  "ic_hls4ml.singlestream"])
def test_a_short_run_on_the_card(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, "tinybench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "1", "--trace", str(trace)],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], out.stderr[-4000:]
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check logit_gap")
    if trace:
        assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
        with open(CHECKOUT / "BENCHMARK.json") as f:
            want = {p["name"] for p in json.load(f)["per_layer"]
                    if cell in p["workloads"]}
        assert set(r["metrics"]) == want
        assert len(r["breakdown"]["device_ops"]) <= 10
    else:
        scen = layout.resolve(cell)["traffic"]["scenario"]
        assert set(r["metrics"]) == {"setup_s", {
            "offline": "offline_qps",
            "singlestream": "singlestream_p90_ms"}[scen]}

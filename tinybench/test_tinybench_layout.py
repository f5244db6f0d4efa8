"""The harness finds every cell, configuration, mix and metric by its name
in files of its own, and ``BENCHMARK.json`` agrees with them."""

import json
import shutil
from pathlib import Path

import pytest

from tinybench import harness, layout

CHECKOUT = Path(__file__).resolve().parent.parent


def _manifest():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_cell_of_the_manifest_resolves():
    m = _manifest()
    files = {c["name"]: c["file"] for c in m["configs"]}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for w in m["workloads"]:
        spec = layout.resolve(w["name"])
        assert spec["cell"]["config"] == w["config"]
        assert spec["cell"]["traffic"] == w["traffic"]
        assert spec["cell"].get("chips", 1) == w["chips"]
        assert files[w["config"]] == f"tinybench/configs/{w['config']}.json"
        assert spec["config"]["name"] == w["config"]
        scen = spec["traffic"]["scenario"]
        # the scenario's metric is the cell's end-to-end metric
        listed = {n for n, e in e2e.items() if w["name"] in e.get(
            "workloads", [w["name"]])}
        assert listed == {"setup_s", {"offline": "offline_qps",
                                      "singlestream": "singlestream_p90_ms"
                                      }[scen]}
        assert set(spec["cell"]["limits"]) == {"logit_gap"}
    for c in m["configs"]:
        cfg = layout.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_every_per_layer_metric_has_its_reader():
    readers = layout.metric_readers()
    m = _manifest()
    assert {p["name"] for p in m["per_layer"]} == set(readers)
    for p in m["per_layer"]:
        assert readers[p["name"]].UNIT == p["unit"]
        # a metric's cells report the end-to-end metric it moves
        e = next(e for e in m["end_to_end"] if e["name"] == p["moves"])
        assert set(p["workloads"]) <= set(e.get("workloads",
                                                p["workloads"]))


def test_files_dropped_into_a_copy_are_found(tmp_path):
    root = tmp_path / "tinybench"
    shutil.copytree(layout.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = layout.config("cnv_w1a1")
    cfg["name"] = "cnv_w1a1_copy"
    (root / "configs" / "cnv_w1a1_copy.json").write_text(json.dumps(cfg))
    (root / "traffic" / "offline_b8.json").write_text(json.dumps(
        dict(layout.traffic("offline_b1024"), rows_per_call=8,
             pool_samples=16, warmup_calls=1, trace_seconds=0.05,
             check_calls=1)))
    (root / "workloads" / "cnv_w1a1_copy.offline_b8.json").write_text(
        json.dumps({"config": "cnv_w1a1_copy", "traffic": "offline_b8",
                    "chips": 1, "limits": {"logit_gap": 0.0}}))
    (root / "metrics" / "calls_traced.offline.py").write_text(
        'UNIT = "calls"\n\n\ndef read(ctx):\n'
        '    return ctx.trace.calls if ctx.trace else None\n')
    assert "cnv_w1a1_copy.offline_b8" in layout.names("workloads", ".json",
                                                      root)
    assert "calls_traced.offline" in layout.metric_readers(root)
    r = harness.run_cell("cnv_w1a1_copy.offline_b8", 3, 0.05, True,
                         device="cpu", root=root)
    assert r["correct"] and r["metrics"]["calls_traced.offline"]["value"] > 0
    assert r["metrics"]["calls_traced.offline"]["unit"] == "calls"


@pytest.mark.parametrize("bad", ["../configs/x", "a b", "", "x/y"])
def test_names_outside_the_contract_are_refused(bad):
    with pytest.raises(ValueError):
        layout.cell(bad)

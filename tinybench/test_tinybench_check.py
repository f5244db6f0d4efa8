"""The check that decides ``correct``: the program passes it, the control
(the plain reference in the nearest lower precision, in the program's
place) fails it, and so does a run whose timed path is broken underneath.
Runs go through ``harness.run_cell`` on the CPU (the program's plain
path) at small sizes: the card's look is skipped, the rest is the run."""

import pytest
import torch

from repro_torch.deploy.executor import CompiledTinyModel
from tinybench import harness

SMALL = {"offline_b1024": {"rows_per_call": 4, "pool_samples": 16,
                           "warmup_calls": 1, "check_calls": 2},
         "singlestream": {"pool_samples": 16, "warmup_calls": 1,
                          "check_calls": 6}}


def _run(cell, seed=5, control=None):
    return harness.run_cell(cell, seed, 0.05, False, device="cpu",
                            traffic_override=SMALL[cell.split(".")[1]],
                            control=control)


@pytest.mark.parametrize("cell", ["ic_hls4ml.offline_b1024",
                                  "cnv_w1a1.singlestream"])
def test_the_program_passes(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"
    gap = r["checks"]["logit_gap"]
    assert 0 <= gap["value"] <= gap["limit"]


@pytest.mark.parametrize("cell, control", [
    ("ic_hls4ml.offline_b1024", "int4"),
    ("ic_hls4ml.offline_b1024", "bf16_head"),
    ("cnv_w1a1.offline_b1024", "int4"),
    ("cnv_w1a1.singlestream", "int4")])
def test_the_control_fails(cell, control):
    r = _run(cell, control=control)
    assert not r["correct"] and r["failed"] > 0
    gap = r["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def _altered(orig):
    """One answer of every call altered where it is produced: its logits
    rotated by one class."""
    def offline(self, x):
        y = orig(self, x).clone()
        y[0] = torch.roll(y[0], 1)
        return y
    return offline


def _half_left_out(orig):
    """Half of every batch left out: its rows get the other half's
    answers."""
    def offline(self, x):
        y = orig(self, x).clone()
        n = y.shape[0]
        y[n // 2:] = y[:n - n // 2]
        return y
    return offline


def _stale(orig):
    """A call that returns the last call's answers unchanged (a replay
    that reads an old buffer)."""
    held = {}

    def offline(self, x):
        y = orig(self, x)
        out = held.get("last", y)
        held["last"] = y
        return out
    return offline


@pytest.mark.parametrize("cell, fault", [
    ("cnv_w1a1.offline_b1024", _altered),
    ("ic_hls4ml.offline_b1024", _altered),
    ("cnv_w1a1.offline_b1024", _half_left_out),
    ("cnv_w1a1.offline_b1024", _stale),
    ("cnv_w1a1.singlestream", _altered),
    ("ic_hls4ml.singlestream", _stale)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(CompiledTinyModel, "offline",
                        fault(CompiledTinyModel.offline))
    r = _run(cell)
    assert not r["correct"] and r["failed"] > 0

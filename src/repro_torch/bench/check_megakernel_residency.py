"""Check that the port's megakernel planner keeps its byte accounting sound.

    python -m repro_torch.bench.check_megakernel_residency [--device cuda]

The port's counterpart of ``scripts/check_megakernel_residency.py``, over
the port's Hopper caps. Every golden graph (``tests/golden/*.qir.json``) and
the four Table-1 models at full width (``bench.models``) are compiled, and
for each run the planner (``deploy.lower.plan_megakernel``) admitted:

  * the per-CTA plan fits one block's shared memory
    (``core.bops.MEGAKERNEL_SMEM_BYTES``), and a fresh
    ``megakernel_cta_plan`` of the run gives the plan's cluster, row tile
    and bytes;
  * the weights and banks fit the plan's budget (by default
    ``core.bops.MEGAKERNEL_L2_BYTES``);
  * the components (weights + banks + tiles) add up to the total, and a
    fresh ``megakernel_residency_bytes`` pass gives the same numbers;
  * ``MEGAKERNEL_MIN_STAGES <= n_stages <= MEGAKERNEL_MAX_STAGES``, every
    stage of the run is a fused dense stage, and its segment is compiled.

KWS and AD, golden and full width, must plan a run; a 64-byte budget must
make the planner reject every segment (the staged fallback). Prints one
line per plan and exits 1 on any violation.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict

from repro_torch.core import bops
from repro_torch.core.qir import Graph
from repro_torch.deploy import compile_graph
from repro_torch.deploy.lower import (MEGAKERNEL_MIN_STAGES,
                                      FusedThresholdStage, plan_megakernel)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "..", "..", "tests", "golden")

#: Models whose dense chains must fit resident: the MLP goldens and the
#: full-width MLPs.
MUST_PLAN = {"kws", "ad", "KWS-FINN", "AD-hls4ml"}


def golden_graphs() -> Dict[str, Graph]:
    paths = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.qir.json")))
    return {os.path.basename(p).split(".")[0]: Graph.load(p) for p in paths}


def full_width_graphs() -> Dict[str, Graph]:
    from repro_torch.bench.table6_scenarios import MODELS

    return {name: build(seed) for name, (build, _, seed) in MODELS.items()}


def check_compiled(name: str, cm) -> int:
    """Violations of one compiled model's plans; prints a line each."""
    failures = 0
    plans = sorted(cm._mega_plans.items())
    for k, plan in plans:
        run = cm.schedule.stages[plan.start:plan.stop]
        res = bops.megakernel_residency_bytes(run, block_m=plan.block_m)
        cta = bops.megakernel_cta_plan(run)
        ok = (cta["fits"]
              and plan.cta_bytes <= bops.MEGAKERNEL_SMEM_BYTES
              and plan.cta_bytes == cta["smem_bytes"]
              and plan.cluster == cta["cluster"]
              and plan.block_m == cta["block_m"]
              and plan.weight_bytes + plan.bank_bytes <= plan.budget_bytes
              and plan.total_bytes == (plan.weight_bytes + plan.bank_bytes
                                       + plan.tile_bytes)
              and plan.total_bytes == res["total_bytes"]
              and plan.weight_bytes == res["weight_bytes"]
              and plan.bank_bytes == res["bank_bytes"]
              and plan.tile_bytes == res["tile_bytes"]
              and MEGAKERNEL_MIN_STAGES <= plan.n_stages
              <= bops.MEGAKERNEL_MAX_STAGES
              and all(isinstance(s, FusedThresholdStage) for s in run)
              and cm.segments[k].compiled)
        print(f"{'ok  ' if ok else 'FAIL'} {name} segment {k}: stages "
              f"[{plan.start},{plan.stop}) CTA {plan.cta_bytes} <= "
              f"{bops.MEGAKERNEL_SMEM_BYTES} B on {plan.cluster} CTAs x "
              f"{plan.block_m} rows; weights + banks "
              f"{plan.weight_bytes + plan.bank_bytes} <= budget "
              f"{plan.budget_bytes} (w={plan.weight_bytes} "
              f"banks={plan.bank_bytes} tiles={plan.tile_bytes})",
              flush=True)
        failures += 0 if ok else 1
    if name in MUST_PLAN and not plans:
        print(f"FAIL {name}: its dense chain admitted no megakernel plan")
        failures += 1
    if not plans and name not in MUST_PLAN:
        print(f"ok   {name}: no fused dense run (staged dispatch only)")
    for seg in cm.segments:
        if plan_megakernel(cm.schedule.stages, seg, budget_bytes=64):
            print(f"FAIL {name}: a 64-byte budget still admitted a plan")
            failures += 1
    return failures


def check_graphs(graphs: Dict[str, Graph], device=None) -> int:
    """Compile each graph on ``device`` and count the violations."""
    failures = 0
    for name, graph in graphs.items():
        cm = compile_graph(graph, in_scale=graph.meta.get("in_scale",
                                                          1.0 / 127.0),
                           device=device)
        failures += check_compiled(name, cm)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    goldens = golden_graphs()
    if not goldens:
        print(f"no golden fixtures under {GOLDEN_DIR!r}")
        return 1
    failures = check_graphs(goldens, args.device)
    failures += check_graphs(full_width_graphs(), args.device)
    print(f"check_megakernel_residency: {failures} violation(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

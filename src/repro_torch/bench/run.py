"""The port's bench harness: one section per paper table and figure, plus
the kernel bench, the serving bench, the obs and cost-model benches and
the dry run's roofline table.

    python -m repro_torch.bench.run                      # every section
    python -m repro_torch.bench.run --only table6,obs    # some of them
    python -m repro_torch.bench.run --only table2,table3 --device cpu

The port of ``benchmarks/run.py``. Each section prints CSV rows
``name,us_per_call,derived`` (``bench.common.print_rows``); every section
is run and reported, and the harness exits 1 naming the sections that
raised. ``--device`` goes to the sections that take one (the default is the
card); ``kernels`` and ``serve`` time device work and need the card;
``table2``, ``fig2`` and ``fig3`` run on the host; ``roofline`` renders
the tables of ``artifacts/dryrun`` (under the working directory: run
``python -m repro_torch.launch.dryrun --all`` first) on the H100's
constants, and prints a note when there are none.
"""

from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.bench import (
    costmodel_bench,
    fig2_bo_scan,
    fig3_asha_scan,
    fig4_quant_scan,
    kernel_bench,
    obs_bench,
    serve_bench,
    table1_models,
    table2_fifo,
    table3_fusion,
    table4_ad_opts,
    table5_latency_energy,
    table6_scenarios,
)
from repro_torch.obs import timer as obs_timer


def _roofline_section():
    """Render the dry run's roofline tables (the paper-faithful baseline,
    and the optimized and serving re-sweeps where their tags exist) if
    artifacts exist."""
    import os

    from repro_torch.bench.common import banner
    from repro_torch.launch.roofline import (analyze, load_artifacts,
                                             render_table, summary_lines)

    banner("Roofline table (from dry-run artifacts)")
    if not os.path.isdir("artifacts/dryrun"):
        print("roofline: no artifacts/dryrun — run "
              "repro_torch.launch.dryrun first")
        return []
    rows = [analyze(r) for r in load_artifacts("artifacts/dryrun")]
    print("--- paper-faithful baseline ---")
    print(render_table(rows, mesh="single", tag="baseline"))
    for line in summary_lines(rows, mesh="single", tag="baseline"):
        print(line)
    if any(r.tag == "optimized" for r in rows):
        print("\n--- beyond-paper optimized ---")
        print(render_table(rows, mesh="single", tag="optimized"))
    if any(r.tag == "serving" for r in rows):
        print("\n--- decode cells under the serving layout "
              "(tponly + int8 weights) ---")
        print(render_table(rows, mesh="single", tag="serving"))
    return rows


#: section -> callable of the device (None: the card)
SECTIONS = {
    "table1": lambda d: table1_models.run(d),
    "table2": lambda d: table2_fifo.run(),
    "table3": lambda d: table3_fusion.run(d),
    "table4": lambda d: table4_ad_opts.run(d),
    "table5": lambda d: table5_latency_energy.run(d),
    "table6": lambda d: table6_scenarios.run(d),
    "fig2": lambda d: fig2_bo_scan.run(),
    "fig3": lambda d: fig3_asha_scan.run(),
    "fig4": lambda d: fig4_quant_scan.run(d),
    "kernels": lambda d: kernel_bench.run(),
    "serve": lambda d: serve_bench.run(),
    "obs": lambda d: obs_bench.run(d),
    "costmodel": lambda d: costmodel_bench.run(d),
    "roofline": lambda d: _roofline_section(),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated section names")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = list(SECTIONS)
    if args.only:
        names = [n.strip() for n in args.only.split(",")]
        unknown = [n for n in names if n not in SECTIONS]
        if unknown:
            ap.error(f"unknown sections {unknown}; known: {list(SECTIONS)}")
    t0 = obs_timer.now()
    failures = []
    for name in names:
        try:
            SECTIONS[name](args.device)
        except Exception:  # noqa: BLE001 - every section is reported
            failures.append(name)
            traceback.print_exc()
    print(f"\n[bench] done in {obs_timer.now() - t0:.1f}s; "
          f"{len(names) - len(failures)}/{len(names)} sections ok",
          flush=True)
    if failures:
        print(f"[bench] FAILED sections: {failures}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

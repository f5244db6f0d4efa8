"""Paper Table 2: the FIFO buffer sizes the depth-optimisation pass picks for
each submitted model's dataflow pipeline (simulate big, record the maximum
occupancy, shrink to max + 1).

The port of ``benchmarks/table2_fifo.py`` on ``core.dataflow`` (the port's
copy of the reference's FIFO simulator). It runs on the host: no model, no
device. Each row carries the paper's FIFO sizes beside the optimised depths.

    python -m repro_torch.bench.table2_fifo
"""

from __future__ import annotations

from repro_torch.bench.common import banner, print_rows, row
from repro_torch.core.dataflow import (
    conv_pipeline_stages,
    mlp_pipeline_stages,
    optimize_fifo_depths,
)

#: The FIFO sizes the paper reports for each submission.
PAPER_SIZES = {"AD-hls4ml": "1 (opt disabled)", "KWS-FINN": "32-64",
               "IC-hls4ml": "1-1066", "IC-FINN-CNV": "2-512"}


def pipelines():
    """The four submissions' pipelines, as the reference builds them."""
    return {
        # AD autoencoder (the paper ran it with the FIFO pass disabled,
        # size 1; the pass runs anyway to show what it would pick)
        "AD-hls4ml": mlp_pipeline_stages([128, 72, 72, 8, 72, 72, 128],
                                         reuse_factor=144),
        # KWS MLP (paper range 32-64)
        "KWS-FINN": mlp_pipeline_stages([490, 256, 256, 256, 12],
                                        reuse_factor=8),
        # the conv stacks: (in_elems, out_elems, ii, latency) per stage
        "IC-hls4ml": conv_pipeline_stages([
            (32 * 32 * 3, 32 * 32 * 32, 4, 8),
            (32 * 32 * 32, 32 * 32 * 4, 4, 8),
            (32 * 32 * 4, 32 * 32 * 32, 8, 16),
            (32 * 32 * 32, 8 * 8 * 32, 16, 32),
            (8 * 8 * 32, 8 * 8 * 4, 4, 8),
        ]),
        "IC-FINN-CNV": conv_pipeline_stages([
            (32 * 32 * 3, 30 * 30 * 64, 2, 4),
            (30 * 30 * 64, 28 * 28 * 64, 2, 4),
            (14 * 14 * 64, 12 * 12 * 128, 2, 4),
            (12 * 12 * 128, 10 * 10 * 128, 2, 4),
            (5 * 5 * 128, 3 * 3 * 256, 2, 4),
            (3 * 3 * 256, 1 * 1 * 256, 2, 4),
        ]),
    }


def run():
    banner("Table 2: FIFO buffer depth optimization")
    rows = []
    for name, stages in pipelines().items():
        n_tok = max(s.elems_in for s in stages) * 2
        res = optimize_fifo_depths(stages, n_tokens=n_tok)
        d = res["optimized_depths"]
        rows.append(row(
            f"table2/{name}",
            fifo_min=min(d), fifo_max=max(d),
            total_buffer_elems=res["total_buffer_elems"],
            throughput_preserved=res["throughput_preserved"],
            cycles=res["optimized_cycles"],
            paper_fifo_sizes=PAPER_SIZES[name],
        ))
    print_rows(rows)
    return rows


if __name__ == "__main__":
    run()

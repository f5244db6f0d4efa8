"""Megakernel residency accounting and the residency-aware traffic model.

The port of the megakernel part of ``repro.core.bops`` (the rest of that
module — ``stage_cost``, ``schedule_cost``, ``conv_input_band_bytes`` —
comes with the measurement slice). The byte accounting is the reference's,
function for function; ``tests/test_torch_megakernel.py`` holds it equal.

What differs is the budget. The reference admits a run when its whole
working set (weights + banks + tiles) fits one 2 MiB VMEM cap
(``MEGAKERNEL_VMEM_BYTES``). On the H100 a thread block has at most
227 KB of shared memory, less than the weights alone of the full-width KWS
(256,512 B) or the weights and banks of AD (322,656 B). So the port's
megakernel (``kernels/csrc/mlp_megakernel.cu``) keeps only the row tiles
in shared memory and reads weights and banks through the L2 cache, which
every block of the wave shares. The planner (``deploy.lower
.plan_megakernel``) therefore admits a run on two budgets:

  * ``tile_bytes`` at the port's row block fits ``MEGAKERNEL_SMEM_BYTES``;
  * ``weight_bytes + bank_bytes`` fits ``MEGAKERNEL_L2_BYTES``;

and on the kernel's limit of ``MEGAKERNEL_MAX_STAGES`` stages per launch.
"""

from __future__ import annotations

import math

#: Shared memory one thread block may use on sm_90 (227 KB = 232,448 B,
#: the ``cudaFuncAttributeMaxDynamicSharedMemorySize`` ceiling; NVIDIA's
#: Hopper tuning guide). Budget for the megakernel's row tiles.
MEGAKERNEL_SMEM_BYTES = 232_448

#: The H100's L2 cache (50 MB; NVIDIA's H100 data sheet).
H100_L2_BYTES = 50 * 2 ** 20

#: Budget for the weights and banks of one fused run: half of the L2, so
#: that they stay cached while the wave's input and output codes stream
#: through the other half. Every block reads the whole run, so a run that
#: fits is fetched from device memory about once per wave.
MEGAKERNEL_L2_BYTES = H100_L2_BYTES // 2

#: Rows per thread block of the megakernel (``BM`` in
#: ``kernels/csrc/mlp_megakernel.cu``, which must match). Up to about a
#: thousand rows a launch takes as long as one block's serial chain of k
#: and bank steps, whatever its rows, so small blocks that spread the wave
#: over more SMs finish sooner: a 1024-row wave gives 128 blocks for the
#: card's 132 SMs. ``scripts/k3_row_block_sweep.py`` measured 8 rows of
#: 128 threads against 4, 16 and 32 rows (PERF.md). At 8 rows the
#: full-width KWS tiles are 40,256 B (at 32 rows 161,024 B; at 128 rows
#: 644,096 B, more than any block can hold).
MEGAKERNEL_BLOCK_M = 8

#: Longest stage run one megakernel launch takes (``MAX_STAGES`` in the
#: kernel source: the per-stage pointers and sizes travel in one fixed-size
#: kernel parameter).
MEGAKERNEL_MAX_STAGES = 8


def megakernel_residency_bytes(stages, block_m: int = MEGAKERNEL_BLOCK_M
                               ) -> dict:
    """Working set of a FusedThresholdStage run fused into one megakernel:
    every stage's int8 weight matrix and int32 threshold bank, plus the
    two revolving inter-stage FIFO tiles (int32, ``block_m`` rows by the
    widest intermediate dim) and the input/output row blocks — the
    reference's accounting. The port's planner budgets ``tile_bytes``
    against shared memory and ``weight_bytes + bank_bytes`` against L2."""
    stages = list(stages)
    weight = sum(int(math.prod(s.stage.w_int.shape)) for s in stages)
    bank = sum(4 * int(math.prod(s.stage.thresholds.shape)) for s in stages)
    dims = [int(stages[0].in_dim)] + [int(s.out_dim) for s in stages]
    inter = max(dims[1:-1], default=0)
    tile = (4 * block_m * (dims[0] + dims[-1])    # input + output row blocks
            + 2 * 4 * block_m * inter)            # two revolving FIFO tiles
    return {"weight_bytes": int(weight), "bank_bytes": int(bank),
            "tile_bytes": int(tile),
            "total_bytes": int(weight + bank + tile)}


def megakernel_traffic_bytes(stages, wave_rows: int) -> float:
    """Device-memory traffic of one fused wave: parameters are fetched once
    (they stay cached across the wave), activations cross device memory
    only at the run's boundary — the wave input is read and the final
    codes written; every inter-stage tile stays in shared memory."""
    stages = list(stages)
    res = megakernel_residency_bytes(stages)
    io = 4.0 * wave_rows * (int(stages[0].in_dim) + int(stages[-1].out_dim))
    return io + res["weight_bytes"] + res["bank_bytes"]


def staged_traffic_bytes(stages, wave_rows: int) -> float:
    """The per-stage dispatch baseline the megakernel deletes: every stage
    re-reads its parameters and round-trips its input and output
    activations through device memory."""
    total = 0.0
    for s in stages:
        total += 4.0 * wave_rows * (int(s.in_dim) + int(s.out_dim))
        total += float(math.prod(s.stage.w_int.shape))
        total += 4.0 * float(math.prod(s.stage.thresholds.shape))
    return total

"""Dataflow pipeline model + FIFO buffer-depth optimization (paper §3.1.2).

A copy of ``repro.core.dataflow`` (framework-free; the port keeps its own
copy rather than importing the JAX package), held equal to it by
``tests/test_torch_dataflow.py``.

The paper sizes inter-layer FIFO buffers by RTL-simulating the whole design
with oversized FIFOs, recording the maximum occupancy of each, then setting
depth = max_occupancy + 1. The same question — "how much buffering does a
producer/consumer pipeline need to sustain full throughput?" — sizes the
queues of the executor's micro-batched streaming pipeline
(``deploy.executor.plan_streaming``).

This module implements a cycle-accurate discrete-event simulation of a linear
dataflow pipeline (stages with initiation interval II, pipeline latency L, and
rate conversion elems_in -> elems_out), the occupancy recorder, and the
depth-optimization pass. `optimize_fifo_depths` reproduces the paper's
workflow: simulate big -> record max -> shrink to max+1 -> re-simulate and
assert zero throughput loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Stage:
    """One dataflow stage.

    Consumes ``elems_in`` tokens, then ``latency`` cycles later emits
    ``elems_out`` tokens; can start a new batch every ``ii`` cycles
    (initiation interval — the paper's reuse factor shows up here: RF=r
    multiplies II by r).
    """

    name: str
    ii: int = 1
    latency: int = 1
    elems_in: int = 1
    elems_out: int = 1


BIG_DEPTH = 1 << 20


def simulate_pipeline(
    stages: Sequence[Stage],
    n_tokens: int,
    depths: Sequence[int],
    max_cycles: int = 50_000_000,
) -> Tuple[int, List[int]]:
    """Simulate a linear pipeline fed with ``n_tokens`` input tokens.

    depths[i] is the capacity of the FIFO *in front of* stage i (depths[0] is
    the input FIFO, assumed fed at 1 token/cycle); an extra output FIFO of
    unbounded size collects results. Returns (total_cycles, max_occupancy per
    FIFO). A stage stalls if its input lacks elems_in tokens or its output
    FIFO lacks space for elems_out.
    """
    n = len(stages)
    occ = [0] * (n + 1)           # occ[i]: tokens in FIFO feeding stage i; occ[n] = output
    max_occ = [0] * (n + 1)
    next_free = [0] * n           # cycle at which stage may initiate again
    # in-flight completions: list of (finish_cycle, stage_idx)
    inflight: List[Tuple[int, int]] = []
    fed = 0
    produced_total = 0
    expected_out = n_tokens
    for st in stages:
        expected_out = (expected_out // st.elems_in) * st.elems_out

    cycle = 0
    while produced_total < expected_out:
        if cycle > max_cycles:
            raise RuntimeError("pipeline simulation did not converge (deadlock?)")
        # 1) retire in-flight work finishing this cycle
        still = []
        for fin, i in inflight:
            if fin == cycle:
                occ[i + 1] += stages[i].elems_out
                max_occ[i + 1] = max(max_occ[i + 1], occ[i + 1])
                if i + 1 == n:
                    produced_total += stages[i].elems_out
            else:
                still.append((fin, i))
        inflight = still
        # 2) feed input FIFO (1 token per cycle, respecting its depth)
        if fed < n_tokens and occ[0] < depths[0]:
            occ[0] += 1
            fed += 1
            max_occ[0] = max(max_occ[0], occ[0])
        # 3) stage initiations (downstream first, frees space for upstream)
        for i in reversed(range(n)):
            st = stages[i]
            out_cap = depths[i + 1] if i + 1 < n else BIG_DEPTH
            out_occ = occ[i + 1] if i + 1 <= n else 0
            if (
                cycle >= next_free[i]
                and occ[i] >= st.elems_in
                and (i + 1 == n or out_occ + st.elems_out <= out_cap)
            ):
                occ[i] -= st.elems_in
                next_free[i] = cycle + st.ii
                inflight.append((cycle + max(st.latency, 1), i))
        cycle += 1
    return cycle, max_occ


def optimize_fifo_depths(
    stages: Sequence[Stage], n_tokens: int
) -> Dict[str, object]:
    """Paper §3.1.2 as an optimization pass.

    1. simulate with effectively-unbounded FIFOs,
    2. record per-FIFO max occupancy,
    3. set depth = max_occupancy + 1,
    4. re-simulate and verify total cycles did not regress.
    Returns dict with baseline/optimized depths, cycles, and the resource
    saving (sum of depths, the BRAM/LUT analogue).
    """
    n = len(stages)
    big = [BIG_DEPTH] * (n + 1)
    base_cycles, max_occ = simulate_pipeline(stages, n_tokens, big)
    opt_depths = [m + 1 for m in max_occ]
    opt_cycles, _ = simulate_pipeline(stages, n_tokens, opt_depths)
    return {
        "baseline_depths": big[: n + 1],
        "optimized_depths": opt_depths,
        "baseline_cycles": base_cycles,
        "optimized_cycles": opt_cycles,
        "throughput_preserved": opt_cycles <= base_cycles,
        "total_buffer_elems": sum(opt_depths),
    }


#: Modeled element throughput of one pipeline stage, elements per simulated
#: cycle. One simulated cycle stands for "the time a stage needs to chew
#: through this many accumulator elements"; the absolute value only sets the
#: cycle unit, the *ratios* between stages are what size the FIFOs.
STAGE_ELEMS_PER_CYCLE = 8192

#: Fixed per-initiation cost in simulated cycles: the dispatch/launch/sync
#: overhead a stage pays every time it starts a micro-batch, independent of
#: the micro-batch size. This is the term that makes tiny micro-batches
#: expensive (many hops) and is what the micro-batch autotuner trades against
#: pipeline fill/drain latency (which grows with the micro-batch).
HOP_OVERHEAD_CYCLES = 8


def micro_batch_stage(name: str, work: int, micro_batch: int = 1,
                      *, elems_per_cycle: int = STAGE_ELEMS_PER_CYCLE,
                      overhead: int = HOP_OVERHEAD_CYCLES) -> Stage:
    """Simulation stage for one compiled deploy stage at a micro-batch size.

    ``work`` is the stage's per-sample element count (``fifo_work``); a
    micro-batch of ``micro_batch`` samples costs
    ``overhead + ceil(work * micro_batch / elems_per_cycle)`` cycles, and the
    stage is busy for the whole service time (ii == latency — the executor
    runs one micro-batch at a time per stage). Total batch cycles therefore
    trade hop overhead (favors big micro-batches) against pipeline fill/drain
    (favors small ones) — the optimum the FIFO-model autotuner searches for.
    """
    mb = max(int(micro_batch), 1)
    lat = int(overhead) + max(1, -(-int(work) * mb // int(elems_per_cycle)))
    return Stage(name=name, ii=lat, latency=lat, elems_in=1, elems_out=1)


def mlp_pipeline_stages(layer_dims: Sequence[int], reuse_factor: int = 1) -> List[Stage]:
    """Build the dataflow stage graph of an MLP deployment.

    Each dense layer consumes its full input vector and emits its output
    vector; II scales with the reuse factor (paper §3.3.2: RF = number of
    times each multiplier is reused; latency ~ RF)."""
    stages = []
    for i in range(len(layer_dims) - 1):
        fan_in, fan_out = layer_dims[i], layer_dims[i + 1]
        stages.append(
            Stage(
                name=f"dense_{i}",
                ii=max(reuse_factor, 1),
                latency=max(reuse_factor, 1) + 2,  # mult chain + accum + act
                elems_in=fan_in,
                elems_out=fan_out,
            )
        )
    return stages


def conv_pipeline_stages(shapes: Sequence[Tuple[int, int, int, int]]) -> List[Stage]:
    """Stages for a conv stack; shapes: (in_elems, out_elems, ii, latency)."""
    return [
        Stage(name=f"conv_{i}", ii=ii, latency=lat, elems_in=ein, elems_out=eout)
        for i, (ein, eout, ii, lat) in enumerate(shapes)
    ]


def prefetch_depth(producer_period: float, consumer_period: float, jitter: float = 2.0) -> int:
    """Host->device prefetch-buffer depth from the same occupancy logic:
    enough slots to cover consumer stalls of `jitter` periods."""
    ratio = producer_period / max(consumer_period, 1e-9)
    return max(2, int(jitter * max(ratio, 1.0)) + 1)

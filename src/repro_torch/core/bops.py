"""Hardware-cost metrics: BOPs, weight memory, inference cost, schedule
traffic, and the megakernel residency accounting.

The port of ``repro.core.bops``, ``lm_model_flops`` (the LM roofline's
useful work, ``launch/roofline.py``) included. Eq. 1 / Eq. 2 of the paper:

  BOPs ~= m*n*k^2 * (b_a*b_w + b_a + b_w + log2(n*k^2))          (Eq. 1)
  C     = 0.5 * (BOPs/BOPs_ref + WM/WM_ref)                      (Eq. 2)

and the compiled-schedule costing (``stage_cost``, ``schedule_cost``,
``stage_traffic_bytes``, ``conv_input_band_bytes``) that the scenario
runtime's energy proxy and the autotuner read. Function for function the
arithmetic is the reference's (``tests/test_torch_bops.py`` and
``tests/test_torch_megakernel.py`` hold it equal); the reference reaches
``repro.kernels`` for the conv helpers, the port its own
``kernels/conv_threshold.py``, imported inside the functions because
``kernels.ops`` imports this module.

What differs is the megakernel budget. The reference admits a run when its
whole working set (weights + banks + tiles) fits one 2 MiB VMEM cap
(``MEGAKERNEL_VMEM_BYTES``). On the H100 a thread block has at most
227 KB of shared memory, less than the weights alone of the full-width KWS
(256,512 B) or the weights and banks of AD (322,656 B). So the port's
megakernel (``kernels/csrc/mlp_megakernel.cu``) runs each row tile on a
thread-block cluster of up to 8 CTAs, each holding its share of every
stage's channels: its slices of the weights and banks and the row tile's
codes, exchanged through distributed shared memory (``kernels.ops
.megakernel_plan`` lays a CTA out). The planner (``deploy.lower
.plan_megakernel``) admits a run on three budgets:

  * the per-CTA plan at the smallest row tile, ``MEGAKERNEL_BLOCK_M``
    rows, on 8 CTAs, fits ``MEGAKERNEL_SMEM_BYTES``
    (``megakernel_cta_plan``; slices that do not fit stream);
  * ``weight_bytes + bank_bytes`` fits ``MEGAKERNEL_L2_BYTES``;
  * at most ``MEGAKERNEL_MAX_STAGES`` stages per launch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List


def conv_bops(m: int, n: int, k: int, b_a: int, b_w: int,
              out_hw: int = 1) -> float:
    """Eq. 1 for one conv layer, times the number of output positions.

    m: out channels, n: in channels, k: kernel size, out_hw: H_out*W_out."""
    per_pos = m * n * k * k * (b_a * b_w + b_a + b_w
                                + math.log2(max(n * k * k, 2)))
    return per_pos * out_hw


def dense_bops(m: int, n: int, b_a: int, b_w: int) -> float:
    """Eq. 1 with k=1 (fully connected)."""
    return conv_bops(m, n, 1, b_a, b_w, out_hw=1)


def weight_memory_bits(n_weights: int, b_w: int) -> int:
    """WM: total bits to store the weights."""
    return n_weights * b_w


def inference_cost(bops: float, wm: float, bops_ref: float,
                   wm_ref: float) -> float:
    """Eq. 2 relative inference cost."""
    return 0.5 * (bops / bops_ref + wm / wm_ref)


@dataclass
class LayerCost:
    name: str
    bops: float
    wm_bits: int
    flops: float
    n_params: int
    traffic_bytes: float = 0.0   # per-query memory traffic (schedule costing)


def dense_cost(name, in_dim, out_dim, b_a=8, b_w=8, bias=True) -> LayerCost:
    n_w = in_dim * out_dim + (out_dim if bias else 0)
    return LayerCost(name=name, bops=dense_bops(out_dim, in_dim, b_a, b_w),
                     wm_bits=weight_memory_bits(n_w, b_w),
                     flops=2.0 * in_dim * out_dim, n_params=n_w)


def conv_cost(name, in_ch, out_ch, k, out_h, out_w, b_a=8, b_w=8,
              bias=True) -> LayerCost:
    n_w = k * k * in_ch * out_ch + (out_ch if bias else 0)
    return LayerCost(
        name=name,
        bops=conv_bops(out_ch, in_ch, k, b_a, b_w, out_hw=out_h * out_w),
        wm_bits=weight_memory_bits(n_w, b_w),
        flops=2.0 * k * k * in_ch * out_ch * out_h * out_w, n_params=n_w)


@dataclass
class ModelCost:
    layers: List[LayerCost]

    @property
    def bops(self) -> float:
        return sum(l.bops for l in self.layers)

    @property
    def wm_bits(self) -> int:
        return sum(l.wm_bits for l in self.layers)

    @property
    def flops(self) -> float:
        return sum(l.flops for l in self.layers)

    @property
    def n_params(self) -> int:
        return sum(l.n_params for l in self.layers)

    @property
    def traffic_bytes(self) -> float:
        return sum(l.traffic_bytes for l in self.layers)

    def cost_vs(self, ref: "ModelCost") -> float:
        return inference_cost(self.bops, self.wm_bits, ref.bops, ref.wm_bits)

    def table(self) -> str:
        rows = [f"{'layer':24s} {'params':>10s} {'BOPs':>14s} "
                f"{'WM[bits]':>12s} {'FLOPs':>14s}"]
        for l in self.layers:
            rows.append(f"{l.name:24s} {l.n_params:>10d} {l.bops:>14.3e} "
                        f"{l.wm_bits:>12d} {l.flops:>14.3e}")
        rows.append(f"{'TOTAL':24s} {self.n_params:>10d} {self.bops:>14.3e} "
                    f"{self.wm_bits:>12d} {self.flops:>14.3e}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# compiled-schedule costing (deploy.lower stage lists)
# ---------------------------------------------------------------------------

def _padded_width(geom) -> int:
    """The input width a direct-conv row band carries: SAME-padded or not."""
    from repro_torch.kernels.conv_threshold import same_pads

    if geom.padding != "SAME":
        return geom.in_w
    (_, _), (pw_lo, pw_hi) = same_pads(geom.in_h, geom.in_w, geom.out_h,
                                       geom.out_w, geom.stride, geom.kernel)
    return geom.in_w + pw_lo + pw_hi


def conv_input_band_bytes(geom, block_h: int) -> float:
    """Input bytes one query streams through the fused direct-conv kernel
    at a given output-row block: per-block bands of
    ``(block_h - 1) * stride + kernel`` padded input rows, halo rows
    counted once per block they belong to."""
    from repro_torch.kernels.conv_threshold import band_rows

    bh = max(1, min(int(block_h), geom.out_h))
    n_blocks = -(-geom.out_h // bh)
    return 4.0 * n_blocks * band_rows(bh, geom.stride, geom.kernel) \
        * _padded_width(geom) * geom.in_ch


def stage_traffic_bytes(stage) -> float:
    """Memory-traffic model of one lowered deploy stage for one batch-1
    query: input and output codes (int32), parameters (int8 weights, int32
    thresholds, float32 head weights); an im2col conv stage also writes and
    re-reads its patch matrix, a direct one streams row bands (tuned
    ``block_h`` or ``plan_conv_blocks``' default) in place of its flat
    input."""
    io = 4.0 * (int(getattr(stage, "in_dim", 0))
                + int(getattr(stage, "out_dim", 0)))
    bank = getattr(stage, "stage", None)        # ThresholdDense, if fused
    params = 0.0
    if bank is not None:
        params = (float(math.prod(bank.w_int.shape))
                  + 4.0 * float(math.prod(bank.thresholds.shape)))
    w = getattr(stage, "w", None)               # FloatHeadStage
    if w is not None:
        params = 4.0 * float(math.prod(w.shape))
    geom = getattr(stage, "geom", None)
    if geom is not None and getattr(stage, "lowering", "direct") == "im2col":
        patch = (geom.out_h * geom.out_w
                 * geom.kernel * geom.kernel * geom.in_ch)
        io += 2.0 * 4.0 * patch                 # write + read the im2col mat
    elif geom is not None:
        bh = getattr(stage, "block_h", None)
        if not bh:
            from repro_torch.kernels.conv_threshold import plan_conv_blocks

            bh = plan_conv_blocks(geom.out_h, geom.out_w, geom.out_ch)
        io += conv_input_band_bytes(geom, bh) \
            - 4.0 * int(getattr(stage, "in_dim", 0))
    return io + params


def stage_cost(stage) -> LayerCost:
    """Eq. 1/2 cost of one lowered deploy stage, by duck type: conv stages
    carry a ``geom``, matmul-like stages ``in_dim``/``out_dim``, pool and
    flatten stages cost no BOPs; ``traffic_bytes`` is
    ``stage_traffic_bytes``."""
    name = getattr(stage, "name", type(stage).__name__)
    b_a = int(getattr(stage, "in_bits", 8))
    bank = getattr(stage, "stage", None)
    b_w = int(getattr(bank, "weight_bits", 8))
    geom = getattr(stage, "geom", None)
    traffic = stage_traffic_bytes(stage)
    if geom is not None:
        c = conv_cost(name, geom.in_ch, geom.out_ch, geom.kernel,
                      geom.out_h, geom.out_w, b_a, b_w, bias=False)
        c.traffic_bytes = traffic
        return c
    w = getattr(stage, "w", None)
    if bank is not None or w is not None:
        c = dense_cost(name, int(stage.in_dim), int(stage.out_dim),
                       b_a, b_w, bias=w is not None)
        c.traffic_bytes = traffic
        return c
    return LayerCost(name=name, bops=0.0, wm_bits=0, flops=0.0, n_params=0,
                     traffic_bytes=traffic)


def schedule_cost(stages: Iterable) -> ModelCost:
    """ModelCost of a compiled ``StageSchedule.stages`` list: the energy
    proxy the scenario runtime attaches to a deployment."""
    return ModelCost([stage_cost(s) for s in stages])


# ---------------------------------------------------------------------------
# megakernel residency accounting + residency-aware traffic model
# ---------------------------------------------------------------------------

#: Shared memory one thread block may use on sm_90 (227 KB = 232,448 B,
#: the ``cudaFuncAttributeMaxDynamicSharedMemorySize`` ceiling; NVIDIA's
#: Hopper tuning guide). Budget for one megakernel CTA.
MEGAKERNEL_SMEM_BYTES = 232_448

#: The H100's L2 cache (50 MB; NVIDIA's H100 data sheet).
H100_L2_BYTES = 50 * 2 ** 20

#: Budget for the weights and banks of one fused run: half of the L2, so
#: that they stay cached while the wave's input and output codes stream
#: through the other half. Every cluster reads the whole run, so a run that
#: fits is fetched from device memory about once per wave.
MEGAKERNEL_L2_BYTES = H100_L2_BYTES // 2

#: The row tile admission prices: the smallest the megakernel takes
#: (``kernels.ops.MEGAKERNEL_ROW_TILES``). The planner plans a segment
#: without knowing its rows, so a run admitted at 8 rows on 8 CTAs fits at
#: every M; the kernel takes larger tiles (16-64 rows) and smaller clusters
#: only where they fit. At 8 rows on 8 CTAs the full-width KWS takes
#: 69,568 B a CTA (``megakernel_cta_plan``), its code tiles 24,576 B.
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
    reference's accounting. The port's planner budgets the per-CTA plan
    (``megakernel_cta_plan``) against shared memory and ``weight_bytes +
    bank_bytes`` against L2."""
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


def megakernel_cta_plan(stages) -> dict:
    """The per-CTA plan admission prices for a FusedThresholdStage run:
    ``kernels.ops.megakernel_plan`` of its widths and bank depths at no
    row count (``MEGAKERNEL_BLOCK_M`` rows, 8 CTAs a cluster). ``fits``
    says whether its shared memory (``smem_bytes``) is within
    ``MEGAKERNEL_SMEM_BYTES``; ``weights_resident`` / ``banks_resident``
    whether the slices stay in it or stream."""
    from repro_torch.kernels.ops import megakernel_plan

    stages = list(stages)
    dims = (int(stages[0].in_dim),) + tuple(int(s.out_dim) for s in stages)
    steps = tuple(int(s.stage.thresholds.shape[1]) for s in stages)
    return megakernel_plan(dims, steps)


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


# ---------------------------------------------------------------------------
# LM-scale model FLOPs (used by launch/roofline.py)
# ---------------------------------------------------------------------------

def lm_model_flops(n_active_params: int, n_tokens: int, training: bool = True) -> float:
    """6*N*D for training (fwd+bwd), 2*N*D for inference forward."""
    mult = 6.0 if training else 2.0
    return mult * n_active_params * n_tokens

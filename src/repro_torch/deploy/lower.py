"""QIR graph lowering on torch: from an interchange graph to a stage schedule.

The port of ``repro.deploy.lower``. ``lower_graph`` walks a
``core.qir.Graph`` and greedily fuses every

    Dense|Conv2D -> [BatchNorm] -> [Relu] -> Quant

chain into one integer stage (int8 matmul -> int32 accumulator ->
multi-threshold), with pool, flatten, float-head and fallback stages for
the rest. Banks, scales and the exactness decisions (``mm_float``,
``affine``) equal the reference's bit for bit; the stages are built on
the CPU and moved to the executor's device afterwards (``StageSchedule.to``).

Each fused stage has two ways to run:
  * ``apply_kernel`` — the CUDA kernels (``kernels.ops``): ``threshold_matmul``
    for dense stages and the im2col conv lowering, ``conv_threshold`` for
    direct conv stages. On CPU tensors the wrappers run their plain versions.
  * ``apply_ref``    — the plain integer matmul and threshold count.
The executor uses ``apply_kernel`` on every device. ``mm_float`` and
``affine`` are the reference's exactness decisions for its float32 CPU
path; the port has no such path and carries them so that its schedule
equals the reference's.

``group_segments`` cuts a schedule into the executor's streaming segments
at host boundaries, and ``plan_megakernel`` picks, per segment, the run of
dense stages that ``kernels.ops.mlp_megakernel`` executes as one launch;
only its admission test differs from the reference (``core.bops``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import bops
from repro_torch.core.qir import Graph, Node, eval_node, full_fp32
from repro_torch.core.quantizers import IntQuantizer
from repro_torch.core.streamline import (
    ThresholdDense,
    apply_threshold_dense,
    make_threshold_stage,
    multi_threshold,
    streamline_conv,
    streamline_dense,
)
from repro_torch.kernels import ops
from repro_torch.kernels.conv_threshold import int_matmul, pad_input


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# im2col
# ---------------------------------------------------------------------------

def im2col(x: torch.Tensor, kernel: int, stride: int, padding: str
           ) -> torch.Tensor:
    """Extract conv patches: (N, H, W, C) -> (N, OH, OW, kernel*kernel*C).

    Feature order is (kh, kw, c) row-major — identical to reshaping an HWIO
    kernel to (kh*kw*cin, cout), so ``patches @ w2d`` is the convolution.
    SAME zero-pads with ``same_pads``' split (low side floor(pad/2))."""
    n, h, w, c = x.shape
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
    else:
        oh, ow = (h - kernel) // stride + 1, (w - kernel) // stride + 1
    x = pad_input(x, kernel=kernel, stride=stride, padding=padding,
                  out_h=oh, out_w=ow)
    cols = [x[:, i:i + stride * (oh - 1) + 1:stride,
              j:j + stride * (ow - 1) + 1:stride, :]
            for i in range(kernel) for j in range(kernel)]
    return torch.cat(cols, dim=-1)


# ---------------------------------------------------------------------------
# stage kinds
# ---------------------------------------------------------------------------

def _float_mm_safe(w_int, in_bits: int) -> bool:
    """True when the stage's integer matmul can run *exactly* in float32:
    every partial sum stays below 2^24 in the worst case over channels."""
    colsum = np.sum(np.abs(np.asarray(w_int, np.int64)), axis=0)
    worst = int(colsum.max()) if colsum.size else 0
    return worst * ((1 << in_bits) - 1) < (1 << 24)


def _move(obj, device):
    """Copy of a stage dataclass with every tensor field on ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif isinstance(v, ThresholdDense):
            changes[f.name] = v.to(device)
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            changes[f.name] = tuple(t.to(device) for t in v)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass
class FusedThresholdStage:
    """One streamlined integer dense stage (see core/streamline.py)."""

    name: str
    stage: ThresholdDense
    in_dim: int
    out_dim: int
    in_scale: float
    in_bits: int = 8
    mm_float: bool = False   # see _float_mm_safe (parity only)
    affine: Optional[tuple] = None   # see _exact_affine (parity only)

    @property
    def out_scale(self) -> float:
        return self.stage.out_scale

    @property
    def macs(self) -> int:
        return self.in_dim * self.out_dim

    def apply_ref(self, x_int):
        return apply_threshold_dense(self.stage, x_int)

    def apply_kernel(self, x_int):
        # int32, not int8: inter-stage codes are unsigned up to 255 with
        # 8-bit activations and would wrap under an int8 cast
        return ops.threshold_matmul(x_int.to(torch.int32).contiguous(),
                                    self.stage.w_int, self.stage.thresholds)


@dataclasses.dataclass
class ConvGeom:
    """Static conv geometry a fused conv stage needs."""

    kernel: int
    stride: int
    padding: str
    in_h: int
    in_w: int
    in_ch: int
    out_h: int
    out_w: int
    out_ch: int


CONV_LOWERINGS = ("direct", "im2col")


def default_conv_lowering() -> str:
    """The preferred conv lowering, overridable via REPRO_CONV_LOWERING."""
    kind = os.environ.get("REPRO_CONV_LOWERING", "direct").strip() or "direct"
    if kind not in CONV_LOWERINGS:
        raise ValueError(
            f"REPRO_CONV_LOWERING={kind!r}; expected one of {CONV_LOWERINGS}")
    return kind


@dataclasses.dataclass
class FusedConvThresholdStage:
    """One streamlined integer conv stage (direct or im2col lowering).

    ``stage.w_int`` holds the (kernel*kernel*in_ch, out_ch) im2col weight
    matrix; both lowerings consume the one artifact and give identical
    integers."""

    name: str
    stage: ThresholdDense
    geom: ConvGeom
    in_scale: float
    in_bits: int = 8
    mm_float: bool = False
    affine: Optional[tuple] = None
    lowering: str = "direct"         # "direct" | "im2col"

    @property
    def out_scale(self) -> float:
        return self.stage.out_scale

    @property
    def in_dim(self) -> int:
        return self.geom.in_h * self.geom.in_w * self.geom.in_ch

    @property
    def out_dim(self) -> int:
        return self.geom.out_h * self.geom.out_w * self.geom.out_ch

    @property
    def macs(self) -> int:
        g = self.geom
        return g.out_h * g.out_w * g.kernel * g.kernel * g.in_ch * g.out_ch

    @property
    def fifo_work(self) -> int:
        """Per-token work driving the FIFO-depth simulation: the direct
        kernel emits only output tiles, the im2col lowering materializes
        patch tiles (= ``macs``)."""
        g = self.geom
        if self.lowering == "direct":
            return g.out_h * g.out_w * g.out_ch
        return self.macs

    def _nhwc(self, x_int):
        g = self.geom
        return x_int.reshape(-1, g.in_h, g.in_w, g.in_ch)

    def _cols2d(self, x_int):
        g = self.geom
        cols = im2col(self._nhwc(x_int), g.kernel, g.stride, g.padding)
        return cols.reshape(-1, g.kernel * g.kernel * g.in_ch)

    def _shape_out(self, y2d, n):
        g = self.geom
        return y2d.reshape(n, g.out_h, g.out_w, g.out_ch)

    def apply_ref(self, x_int):
        acc = int_matmul(self._cols2d(x_int), self.stage.w_int)
        return self._shape_out(multi_threshold(acc, self.stage.thresholds),
                               x_int.shape[0])

    def apply_kernel(self, x_int):
        g = self.geom
        if self.lowering == "direct":
            x = self._nhwc(x_int).to(torch.int32).contiguous()
            return ops.conv_threshold(
                x, self.stage.w_int, self.stage.thresholds,
                kernel=g.kernel, stride=g.stride, padding=g.padding,
                out_h=g.out_h, out_w=g.out_w)
        y = ops.threshold_matmul(
            self._cols2d(x_int).to(torch.int32).contiguous(),
            self.stage.w_int, self.stage.thresholds)
        return self._shape_out(y, x_int.shape[0])


@dataclasses.dataclass
class IntPoolStage:
    """MaxPool executed directly on integer codes (exact: the code -> value
    map is monotone, so max commutes with decoding)."""

    name: str
    window: int
    stride: int
    padding: str
    in_h: int
    in_w: int
    ch: int
    out_h: int
    out_w: int
    in_scale: float
    in_bits: int = 8

    @property
    def out_scale(self) -> float:
        return self.in_scale

    @property
    def in_dim(self) -> int:
        return self.in_h * self.in_w * self.ch

    @property
    def out_dim(self) -> int:
        return self.out_h * self.out_w * self.ch

    @property
    def macs(self) -> int:
        return self.out_h * self.out_w * self.ch * self.window * self.window

    def apply_ref(self, x):
        from repro_torch.core.qir import max_pool_nhwc

        x = x.reshape(-1, self.in_h, self.in_w, self.ch)
        return max_pool_nhwc(x, self.window, self.stride, self.padding)


@dataclasses.dataclass
class FlattenStage:
    """NHWC -> (N, H*W*C) reshape between the conv stack and the FC head."""

    name: str
    in_dim: int
    in_scale: float
    in_bits: int = 8

    @property
    def out_dim(self) -> int:
        return self.in_dim

    @property
    def out_scale(self) -> float:
        return self.in_scale

    @property
    def macs(self) -> int:
        return self.in_dim

    def apply_ref(self, x):
        return x.reshape(x.shape[0], -1)


@dataclasses.dataclass
class FloatHeadStage:
    """Final affine head: logits = x_int * in_scale @ w + b (float out), in
    full float32 on every device (``full_fp32``)."""

    name: str
    w: torch.Tensor
    b: torch.Tensor
    in_dim: int
    out_dim: int
    in_scale: float
    in_bits: int = 8

    @property
    def macs(self) -> int:
        return self.in_dim * self.out_dim

    def apply_ref(self, x_int):
        with full_fp32():
            return x_int.to(torch.float32) @ self.w * self.in_scale + self.b


@dataclasses.dataclass
class RefChainStage:
    """Fallback float interpreter over a run of QIR nodes: consumes the float
    value of its input and emits float, with ``Graph.run`` semantics."""

    name: str
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    in_name: str
    out_name: str
    in_dim: int
    out_dim: int
    in_scale: float
    in_bits: int = 8

    def apply_ref(self, x_float):
        dev = x_float.device
        env: Dict[str, torch.Tensor] = {
            k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in self.initializers.items()}
        env[self.in_name] = x_float
        with full_fp32():
            for node in self.nodes:
                env[node.outputs[0]] = eval_node(
                    node, [env[i] for i in node.inputs])
        return env[self.out_name]


Stage = Union[FusedThresholdStage, FusedConvThresholdStage, IntPoolStage,
              FlattenStage, FloatHeadStage, RefChainStage]


@dataclasses.dataclass
class StageSchedule:
    """The static compilation artifact: an ordered list of stages plus the
    input quantization contract (integer codes with ``in_scale`` step)."""

    stages: List[Stage]
    in_scale: float
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def n_fused(self) -> int:
        return sum(isinstance(s, (FusedThresholdStage,
                                  FusedConvThresholdStage))
                   for s in self.stages)

    @property
    def n_fused_conv(self) -> int:
        return sum(isinstance(s, FusedConvThresholdStage)
                   for s in self.stages)

    def layer_dims(self) -> List[int]:
        dims = [self.stages[0].in_dim]
        for s in self.stages:
            dims.append(s.out_dim)
        return dims

    def to(self, device) -> "StageSchedule":
        """A copy whose stages hold their tensors on ``device``."""
        return dataclasses.replace(
            self, stages=[_move(s, device) for s in self.stages])

    def describe(self) -> str:
        rows = [f"schedule: {len(self.stages)} stages "
                f"({self.n_fused} fused int, {self.n_fused_conv} conv, "
                f"in_scale={self.in_scale:g})"]
        for s in self.stages:
            kind = type(s).__name__
            if isinstance(s, FusedConvThresholdStage):
                kind += f"[{s.lowering}]"
            rows.append(f"  {s.name:16s} {kind:24s} {s.in_dim:>6d} -> {s.out_dim}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# segments (streaming)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of stages the executor treats as one unit.

    ``compiled`` segments are runs of fused/integer stages that the
    streaming executor runs as one segment program per micro-batch wave.
    A ``RefChainStage`` is a *host boundary*: it interprets arbitrary
    leftover QIR nodes, so it gets its own non-compiled segment, run one
    micro-batch at a time.
    """

    start: int   # first stage index (inclusive)
    stop: int    # last stage index (exclusive)
    compiled: bool

    @property
    def n_stages(self) -> int:
        return self.stop - self.start


def group_segments(stages: Sequence[Stage]) -> List[Segment]:
    """Group a stage schedule into maximal compiled segments split at host
    boundaries (``RefChainStage``). Every stage lands in exactly one segment
    and segment order is schedule order."""
    segments: List[Segment] = []
    run_start = 0
    for i, s in enumerate(stages):
        if isinstance(s, RefChainStage):
            if i > run_start:
                segments.append(Segment(run_start, i, compiled=True))
            segments.append(Segment(i, i + 1, compiled=False))
            run_start = i + 1
    if run_start < len(stages):
        segments.append(Segment(run_start, len(stages), compiled=True))
    return segments


# ---------------------------------------------------------------------------
# megakernel planner (one launch for a run of dense stages)
# ---------------------------------------------------------------------------

#: Fusing one stage is what ``threshold_matmul`` already does — the
#: megakernel only pays off once there is an inter-stage boundary to delete.
MEGAKERNEL_MIN_STAGES = 2


@dataclasses.dataclass(frozen=True)
class MegakernelSegment:
    """A planned megakernel covering stages ``[start, stop)`` — a run of
    consecutive ``FusedThresholdStage``s that the executor dispatches as
    ONE ``mlp_megakernel`` launch. Carries the planner's byte accounting
    (``core.bops.megakernel_residency_bytes``); ``tile_bytes`` was admitted
    under ``core.bops.MEGAKERNEL_SMEM_BYTES``, weights and banks under
    ``budget_bytes``."""

    start: int          # first fused stage index (inclusive)
    stop: int           # last fused stage index (exclusive)
    block_m: int        # kernel row block the tile accounting assumed
    weight_bytes: int   # int8 weight matrices, all stages (read via L2)
    bank_bytes: int     # int32 threshold banks, all stages (read via L2)
    tile_bytes: int     # in/out row blocks + two revolving FIFO tiles
    budget_bytes: int   # cap on weight_bytes + bank_bytes (L2)

    @property
    def n_stages(self) -> int:
        return self.stop - self.start

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.bank_bytes + self.tile_bytes


def plan_megakernel(stages: Sequence[Stage], segment: Segment, *,
                    budget_bytes: Optional[int] = None
                    ) -> Optional[MegakernelSegment]:
    """Walk one compiled ``Segment`` and plan its megakernel.

    Finds the longest run of consecutive ``FusedThresholdStage``s inside
    the segment (the earlier run wins a tie), as the reference does, and
    admits it when the kernel can take it: at most
    ``MEGAKERNEL_MAX_STAGES`` stages, row tiles (at the kernel's row block)
    that fit one block's shared memory (``MEGAKERNEL_SMEM_BYTES``), and
    weights and banks that fit the L2 budget (``MEGAKERNEL_L2_BYTES``, or
    ``budget_bytes`` when given: tests force the staged fallback with a
    tiny one). Returns ``None`` when no run is long enough or one of these
    fails — the executor then runs the stages one kernel each, which stays
    the exactness reference.
    """
    budget = bops.MEGAKERNEL_L2_BYTES if budget_bytes is None \
        else budget_bytes
    if not segment.compiled:
        return None
    best = None          # longest run wins; earlier run breaks length ties
    i = segment.start
    while i < segment.stop:
        if isinstance(stages[i], FusedThresholdStage):
            j = i
            while j < segment.stop and isinstance(stages[j],
                                                  FusedThresholdStage):
                j += 1
            if best is None or (j - i) > (best[1] - best[0]):
                best = (i, j)
            i = j
        else:
            i += 1
    if best is None or best[1] - best[0] < MEGAKERNEL_MIN_STAGES:
        return None
    block_m = bops.MEGAKERNEL_BLOCK_M
    res = bops.megakernel_residency_bytes(stages[best[0]:best[1]],
                                          block_m=block_m)
    if (best[1] - best[0] > bops.MEGAKERNEL_MAX_STAGES
            or res["tile_bytes"] > bops.MEGAKERNEL_SMEM_BYTES
            or res["weight_bytes"] + res["bank_bytes"] > budget):
        return None      # the kernel cannot take it: staged path
    return MegakernelSegment(start=best[0], stop=best[1], block_m=block_m,
                             weight_bytes=res["weight_bytes"],
                             bank_bytes=res["bank_bytes"],
                             tile_bytes=res["tile_bytes"],
                             budget_bytes=budget)


# ---------------------------------------------------------------------------
# pattern matcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChainMatch:
    """One fusable Dense|Conv2D -> [BatchNorm] -> [Relu] -> Quant run."""

    kind: str                         # "dense" | "conv"
    head: Node
    params: Dict[str, np.ndarray]     # w, b (+ BN stats when present)
    act: str                          # "halfup" | "bipolar"
    act_bits: int
    weight_bits: int
    s_out: Optional[float]            # export-frozen activation scale
    w_scale: Optional[np.ndarray]     # per-channel scale: weights pre-quantized
    n_consumed: int


def _head_params(graph: Graph, node: Node) -> Optional[Dict[str, np.ndarray]]:
    """Pull (w, b) for a Dense/Conv2D node; None unless w is an initializer."""
    if len(node.inputs) < 2 or node.inputs[1] not in graph.initializers:
        return None
    w = graph.initializers[node.inputs[1]]
    b = (graph.initializers.get(node.inputs[2])
         if len(node.inputs) > 2 else None)
    if b is None:
        b = np.zeros((w.shape[-1],), np.float32)
    return {"w": w, "b": b}


def _is_linear_value(graph: Graph, name: str) -> bool:
    """True iff ``name`` has exactly one consumer and is not a graph output."""
    if name in graph.outputs:
        return False
    return sum(name in n.inputs for n in graph.nodes) == 1


def _is_passthrough_value(graph: Graph, name: str) -> bool:
    """At most one consumer, so the stage pipeline stays a chain."""
    return sum(name in n.inputs for n in graph.nodes) <= 1


def _match_chain(graph: Graph, nodes: List[Node], i: int
                 ) -> Optional[ChainMatch]:
    """Try to match Dense|Conv2D -> [BatchNorm] -> [Relu] -> Quant at i.

    The chain must be linear; a Relu is required for the half-up flavor and
    forbidden for the bipolar one."""
    head = nodes[i]
    if head.op not in ("Dense", "Conv2D"):
        return None
    if head.op == "Conv2D" and "in_shape" not in head.attrs:
        return None
    params = _head_params(graph, head)
    if params is None:
        return None
    j = i + 1
    prev_out = head.outputs[0]
    if not _is_linear_value(graph, prev_out):
        return None
    if j < len(nodes) and nodes[j].op == "BatchNorm" and nodes[j].inputs[0] == prev_out:
        bn = nodes[j]
        try:
            stats = [graph.initializers[n] for n in bn.inputs[1:5]]
        except KeyError:
            return None
        params.update(gamma=stats[0], beta=stats[1], mu=stats[2], sigma2=stats[3])
        prev_out = bn.outputs[0]
        j += 1
        if not _is_linear_value(graph, prev_out):
            return None
    relu = False
    if j < len(nodes) and nodes[j].op == "Relu" and nodes[j].inputs[0] == prev_out:
        relu = True
        prev_out = nodes[j].outputs[0]
        j += 1
        if not _is_linear_value(graph, prev_out):
            return None
    if not (j < len(nodes) and nodes[j].op == "Quant"
            and nodes[j].inputs[0] == prev_out and nodes[j].quant is not None):
        return None
    quant = nodes[j]
    bipolar = bool(quant.attrs.get("bipolar"))
    if bipolar == relu:
        return None
    act_bits = quant.quant.bits
    weight_bits = head.attrs.get("weight_bits", act_bits)
    w_scale = None
    ws_name = head.attrs.get("w_scale")
    if ws_name is not None and ws_name in graph.initializers and "gamma" not in params:
        w_scale = graph.initializers[ws_name]
    s_out = quant.attrs.get("scale")
    return ChainMatch(
        kind="dense" if head.op == "Dense" else "conv",
        head=head, params=params,
        act="bipolar" if bipolar else "halfup",
        act_bits=act_bits, weight_bits=weight_bits,
        s_out=None if s_out is None else float(s_out),
        w_scale=w_scale, n_consumed=j + 1 - i)


def _threshold_for_chain(m: ChainMatch, scale: float,
                         bn_eps: float) -> ThresholdDense:
    """Streamline one matched chain into a ThresholdDense bank."""
    w = np.asarray(m.params["w"], np.float32)
    w2d = w.reshape(-1, w.shape[-1])
    if m.w_scale is not None:
        # weights carry integer codes times a per-channel scale; divide it
        # back out (exact: the exporter used po2 / unit scales)
        s_w = _t(m.w_scale).reshape(-1)
        w_int = torch.round(_t(w2d) / s_w[None, :])
        return make_threshold_stage(
            w_int, s_w, m.params["b"], in_scale=scale, act_bits=m.act_bits,
            s_out=m.s_out, bipolar=m.act == "bipolar",
            weight_bits=m.weight_bits)
    params = {k: _t(v) for k, v in m.params.items()}
    if m.kind == "conv":
        return streamline_conv(
            params, weight_bits=m.weight_bits, act_bits=m.act_bits,
            in_scale=scale, bn_eps=bn_eps, s_out=m.s_out,
            bipolar=m.act == "bipolar")
    if m.act == "bipolar":
        wq = IntQuantizer(bits=m.weight_bits, signed=True, narrow=True, axis=0)
        w_int, s_w = wq.quantize_int(_t(w2d))
        return make_threshold_stage(
            w_int, s_w.squeeze(0), m.params["b"], in_scale=scale,
            act_bits=m.act_bits, bipolar=True, weight_bits=m.weight_bits)
    return streamline_dense(
        params, weight_bits=m.weight_bits, act_bits=m.act_bits,
        in_scale=scale, bn_eps=bn_eps, s_out=m.s_out)


def _exact_affine(m: ChainMatch, td: ThresholdDense, scale: float,
                  mm_safe: bool, in_bits: int) -> Optional[tuple]:
    """(mul, add) for the O(1) activation, or None when not provably exact.

    Requires the half-up flavor with an export-frozen s_out, pre-quantized
    weights whose per-channel scales (and in_scale/s_out) are powers of two,
    bias on the accumulator grid, and the 2^24 accumulator bound. The numpy
    arithmetic is the reference's; only the result becomes float32 tensors.
    """
    if (m.act != "halfup" or m.s_out is None or m.w_scale is None
            or not mm_safe):
        return None
    s_w = np.asarray(m.w_scale, np.float64).reshape(-1)
    grids = np.concatenate([s_w, [scale, td.out_scale]])
    if not np.all(grids > 0):
        return None
    logs = np.log2(grids)
    if not np.all(logs == np.round(logs)):
        return None
    g = s_w * scale                        # accumulator grid per channel
    r1 = g / td.out_scale                  # activation grid in code units
    b = np.asarray(m.params["b"], np.float64).reshape(-1)
    if not (np.all(b / g == np.round(b / g)) and np.all(r1 <= 0.5)):
        return None                        # bias off-grid / 0.5 off-grid
    colsum = np.sum(np.abs(np.asarray(td.w_int, np.int64)), axis=0)
    k_max = (colsum * ((1 << in_bits) - 1) + np.abs(b / g) + 0.5 / r1)
    if not np.all(k_max < (1 << 24)):
        return None
    mul = torch.from_numpy((g / td.out_scale).astype(np.float32))
    add = torch.from_numpy((b / td.out_scale + 0.5).astype(np.float32))
    return (mul, add)


def stage_for(m: ChainMatch, scale: float, in_bits: int = 8,
              bn_eps: float = 1e-3,
              conv_lowering: Optional[str] = None) -> Stage:
    """Build the fused stage for one matched chain — the op dispatch point."""
    td = _threshold_for_chain(m, scale, bn_eps)
    mm_float = _float_mm_safe(td.w_int, in_bits)
    affine = _exact_affine(m, td, scale, mm_float, in_bits)
    if m.kind == "conv":
        a = m.head.attrs
        ih, iw, ic = a["in_shape"]
        oh, ow, oc = a["out_shape"]
        geom = ConvGeom(kernel=int(a.get("kernel", m.params["w"].shape[0])),
                        stride=int(a.get("stride", 1)),
                        padding=a.get("padding", "SAME"),
                        in_h=int(ih), in_w=int(iw), in_ch=int(ic),
                        out_h=int(oh), out_w=int(ow), out_ch=int(oc))
        kind = conv_lowering or default_conv_lowering()
        if kind not in CONV_LOWERINGS:
            raise ValueError(f"conv_lowering={kind!r}; "
                             f"expected one of {CONV_LOWERINGS}")
        return FusedConvThresholdStage(name=m.head.name, stage=td, geom=geom,
                                       in_scale=scale, in_bits=in_bits,
                                       mm_float=mm_float, affine=affine,
                                       lowering=kind)
    w = m.params["w"]
    return FusedThresholdStage(name=m.head.name, stage=td,
                               in_dim=int(w.shape[0]),
                               out_dim=int(w.shape[1]),
                               in_scale=scale, in_bits=in_bits,
                               mm_float=mm_float, affine=affine)


def lower_graph(graph: Graph, in_scale: float = 1.0 / 127.0,
                bn_eps: float = 1e-3,
                conv_lowering: Optional[str] = None) -> StageSchedule:
    """Compile a QIR graph to a stage schedule (tensors on the CPU).

    ``in_scale`` is the float value of one integer step of the (already
    quantized) network input. ``conv_lowering`` selects the conv stage
    algorithm ("direct" fused kernel by default, "im2col"); None defers to
    the REPRO_CONV_LOWERING environment override.
    """
    stages: List[Stage] = []
    nodes = graph.nodes
    scale = in_scale
    in_bits = 8   # MLPerf-Tiny 8-bit input layer contract
    i = 0
    while i < len(nodes):
        m = _match_chain(graph, nodes, i)
        if m is not None:
            st = stage_for(m, scale, in_bits, bn_eps,
                           conv_lowering=conv_lowering)
            stages.append(st)
            scale = st.out_scale
            in_bits = st.stage.act_bits
            i += m.n_consumed
            continue
        node = nodes[i]
        if (node.op == "MaxPool" and "in_shape" in node.attrs
                and _is_passthrough_value(graph, node.outputs[0])):
            ih, iw, ch = (int(v) for v in node.attrs["in_shape"])
            win = int(node.attrs.get("window", 2))
            stride = int(node.attrs.get("stride", win))
            if "out_shape" in node.attrs:
                oh, ow = int(node.attrs["out_shape"][0]), int(node.attrs["out_shape"][1])
            elif node.attrs.get("padding", "VALID") == "SAME":
                oh, ow = -(-ih // stride), -(-iw // stride)
            else:
                oh, ow = (ih - win) // stride + 1, (iw - win) // stride + 1
            stages.append(IntPoolStage(
                name=node.name, window=win, stride=stride,
                padding=node.attrs.get("padding", "VALID"),
                in_h=ih, in_w=iw, ch=ch, out_h=oh, out_w=ow,
                in_scale=scale, in_bits=in_bits))
            i += 1
            continue
        if (node.op == "Flatten"
                and _is_passthrough_value(graph, node.outputs[0])):
            if "in_shape" in node.attrs:
                in_dim = int(np.prod(node.attrs["in_shape"]))
            else:
                in_dim = stages[-1].out_dim if stages else 1
            stages.append(FlattenStage(name=node.name, in_dim=in_dim,
                                       in_scale=scale, in_bits=in_bits))
            i += 1
            continue
        if node.op == "Dense" and i == len(nodes) - 1:
            params = _head_params(graph, node)
            if params is not None:
                stages.append(FloatHeadStage(
                    name=node.name,
                    w=_t(params["w"]),
                    b=_t(params["b"]),
                    in_dim=int(params["w"].shape[0]),
                    out_dim=int(params["w"].shape[1]),
                    in_scale=scale, in_bits=in_bits))
                i += 1
                continue
        # fallback: sweep the rest of the graph into one reference chain
        rest = nodes[i:]
        in_name = rest[0].inputs[0]
        out_name = graph.outputs[0] if graph.outputs else rest[-1].outputs[0]
        in_dim = stages[-1].out_dim if stages else _guess_dim(graph, in_name)
        out_dim = _guess_dim(graph, out_name, default=in_dim)
        stages.append(RefChainStage(
            name=f"ref[{rest[0].name}..{rest[-1].name}]",
            nodes=list(rest),
            initializers=dict(graph.initializers),
            in_name=in_name,
            out_name=out_name,
            in_dim=in_dim,
            out_dim=out_dim,
            in_scale=scale, in_bits=in_bits))
        i = len(nodes)
    return StageSchedule(stages=stages, in_scale=in_scale,
                         meta=dict(graph.meta))


def _guess_dim(graph: Graph, name: str, default: int = 1) -> int:
    """Best-effort feature dim for fallback bookkeeping."""
    for node in graph.nodes:
        if name in node.outputs and node.op in ("Dense",):
            wname = node.inputs[1]
            if wname in graph.initializers:
                return int(graph.initializers[wname].shape[1])
    if name in graph.initializers:
        return int(graph.initializers[name].shape[-1])
    return default

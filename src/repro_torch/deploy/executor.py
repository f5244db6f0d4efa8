"""Executable form of a lowered QIR graph, on torch.

The port of ``repro.deploy.executor``. ``compile_graph`` lowers a QIR graph
(``deploy.lower``), moves the stage schedule to the device and returns a
``CompiledTinyModel`` with the reference's execution modes:

  * **offline** — the whole batch through every stage in order (MLPerf
    Offline);
  * **streaming_compiled** — the schedule grouped into *segments*
    (``lower.group_segments``, split at host boundaries); each segment runs
    the whole micro-batched wave as one segment program, a Python function
    that loops over the wave's micro-batches (the reference's
    ``jax.lax.map`` program);
  * **streaming_host** — the queue-loop pipeline whose per-stage queue
    capacities come from ``core.dataflow.optimize_fifo_depths``, kept for
    its observable occupancy; bit-identical to the other two;
  * **submit_wave** — one partly filled wave through the segment
    programs, the serving router's entry point.

Every fused integer stage calls a kernel wrapper (``kernels.ops``):
``threshold_matmul`` for dense stages and im2col conv stages,
``conv_threshold`` for direct conv stages. By default (``megakernel=None``,
the reference's "auto") the planner (``lower.plan_megakernel``) picks, per
segment, the longest run of dense stages that fits the Hopper budgets, and
offline and the segment programs run it as ONE ``mlp_megakernel`` launch
over the flattened wave; ``megakernel=False`` runs every stage on its own
kernel. On CUDA the wrappers launch the hand-written kernels and never
reach a plain version; on the CPU they run the plain versions, which give
the reference's integers. The unfused per-node interpreter
(``reference``) is kept as the baseline.

Each segment program is rebuilt per call; capturing one CUDA graph per
(segment, wave shape) is later work (it would bypass the launch counters).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dataflow import micro_batch_stage, optimize_fifo_depths
from repro_torch.core.qir import Graph, resolve_device
from repro_torch.deploy.lower import (
    FlattenStage,
    FloatHeadStage,
    FusedConvThresholdStage,
    FusedThresholdStage,
    IntPoolStage,
    MegakernelSegment,
    RefChainStage,
    Segment,
    StageSchedule,
    group_segments,
    lower_graph,
    plan_megakernel,
)
from repro_torch.kernels import ops
from repro_torch.obs import timer as obs_timer
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve.faults import WaveError

#: Default streaming micro-batch (the reference's, without a tuned config).
DEFAULT_MICRO_BATCH = 16


def stage_work(s) -> int:
    """Per-sample element count driving the FIFO cost model for one stage:
    ``fifo_work`` where the stage defines it (lowering-aware for convs),
    MACs for matmul-like stages, in*out as the last resort."""
    work = getattr(s, "fifo_work", None)
    if work is None:
        work = getattr(s, "macs", None)
    if work is None:
        work = s.in_dim * s.out_dim
    return int(work)


@dataclasses.dataclass
class StreamingStats:
    """What the FIFO pass decided and what the pipeline actually did.

    ``mode`` distinguishes the host queue loop ("host": ``max_occupancy`` is
    *observed*) from the segment-wave path ("compiled": ``max_occupancy`` is
    the FIFO simulator's modeled occupancy — the segment programs have no
    per-hop queues to observe). ``segments`` lists the (start, stop) stage
    ranges of the segment grouping; ``megakernel`` the ranges that ran as
    one ``mlp_megakernel`` launch (empty/None when every segment ran
    staged).
    """

    micro_batch: int
    n_micro: int
    fifo_depths: List[int]
    max_occupancy: List[int]
    sim_cycles: int
    mode: str = "host"
    segments: Optional[List[Tuple[int, int]]] = None
    megakernel: Optional[List[Tuple[int, int]]] = None


class CompiledTinyModel:
    """A compiled integer-dataflow executor for one lowered QIR graph,
    holding its schedule on one device."""

    def __init__(self, schedule: StageSchedule, graph: Optional[Graph] = None,
                 device=None, megakernel: Optional[bool] = None,
                 megakernel_budget_bytes: Optional[int] = None,
                 tracer=None):
        self.device = resolve_device(device)
        self.schedule = schedule.to(self.device)
        self.graph = graph
        #: megakernel dispatch: None = auto (one launch whenever the planner
        #: admits a run), True = the same, stated as intent, False = every
        #: stage on its own kernel
        self.megakernel = megakernel
        self.megakernel_budget_bytes = megakernel_budget_bytes
        #: obs.Tracer sink for segment/stage spans and FIFO occupancy
        #: counters; NULL_TRACER keeps every instrumentation site a no-op
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._rebuild()

    def set_tracer(self, tracer) -> "CompiledTinyModel":
        """Install (or clear, with ``None``) the obs tracer; returns self."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        return self

    def set_megakernel(self, mode: Optional[bool],
                       budget_bytes: Optional[int] = None
                       ) -> "CompiledTinyModel":
        """Re-plan megakernel dispatch (None = auto / True / False);
        ``budget_bytes`` overrides the planner's L2 budget for weights and
        banks (tests force the staged fallback with a tiny one) and None
        restores the default. Returns self."""
        self.megakernel = mode
        self.megakernel_budget_bytes = budget_bytes
        self._rebuild()
        return self

    def _rebuild(self):
        """Group the schedule into segments and plan one megakernel run per
        segment; the offline path and the segment programs dispatch
        through the plans."""
        self._mega_plans: Dict[int, MegakernelSegment] = {}
        self._mega_by_start: Dict[int, MegakernelSegment] = {}
        #: each plan's banks transposed once to the kernel's (S, N) layout
        self._mega_banks: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.segments: List[Segment] = group_segments(self.schedule.stages)
        if self.megakernel is not False:
            for k, seg in enumerate(self.segments):
                plan = plan_megakernel(
                    self.schedule.stages, seg,
                    budget_bytes=self.megakernel_budget_bytes)
                if plan is not None:
                    self._mega_plans[k] = plan
                    self._mega_by_start[plan.start] = plan
                    self._mega_banks[plan.start] = tuple(
                        s.stage.thresholds.t().contiguous()
                        for s in self.schedule.stages[plan.start:plan.stop])
        self._plan_cache: Dict[Tuple[int, int], Tuple[List[int], int]] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _input(self, x_int) -> torch.Tensor:
        return torch.as_tensor(x_int, device=self.device)

    # -- single-program (offline) path -----------------------------------
    def _apply_stage(self, s, h):
        if isinstance(s, (FusedThresholdStage, FusedConvThresholdStage)):
            return s.apply_kernel(h)
        if isinstance(s, (IntPoolStage, FlattenStage, FloatHeadStage)):
            return s.apply_ref(h)
        if isinstance(s, RefChainStage):
            if not h.dtype.is_floating_point:
                h = h.to(torch.float32) * s.in_scale
            return s.apply_ref(h)
        raise TypeError(type(s))  # pragma: no cover

    def _apply_mega(self, plan: MegakernelSegment, h):
        """One planned stage run as a single ``mlp_megakernel`` launch (its
        plain version on the CPU): integer-exact against the stages one by
        one, since accumulation and threshold counting are order-free."""
        stages = self.schedule.stages[plan.start:plan.stop]
        return ops.mlp_megakernel(
            h.to(torch.int32).contiguous(),
            [s.stage.w_int for s in stages], self._mega_banks[plan.start])

    def _run_all(self, h):
        stages = self.schedule.stages
        i = 0
        while i < len(stages):
            plan = self._mega_by_start.get(i)
            if plan is not None:
                h = self._apply_mega(plan, h)
                i = plan.stop
            else:
                h = self._apply_stage(stages[i], h)
                i += 1
        return h

    def offline(self, x_int) -> torch.Tensor:
        """Full batch through every stage (MLPerf Offline), planned runs as
        one megakernel launch each; returns the last stage's output on the
        model's device (work may still be queued on the card: synchronise
        before reading a clock)."""
        return self._run_all(self._input(x_int))

    def stage_outputs(self, x_int) -> List[torch.Tensor]:
        """Per-stage outputs (integer codes for fused stages), every stage on
        its own kernel — the parity surface the exactness tests check."""
        outs, h = [], self._input(x_int)
        for s in self.schedule.stages:
            h = self._apply_stage(s, h)
            outs.append(h)
        return outs

    def predict(self, x_int) -> torch.Tensor:
        return torch.argmax(self.offline(x_int), dim=-1)

    # -- unfused reference (what the benchmarks beat) ---------------------
    def reference(self, x_int) -> torch.Tensor:
        """Per-node interpretation of the source QIR graph on the model's
        device, in full float32."""
        if self.graph is None:
            raise ValueError("compile with graph= to keep the reference path")
        x = np.asarray(torch.as_tensor(x_int).cpu(), np.float32) \
            * self.schedule.in_scale
        out = self.graph.run({self.graph.inputs[0]: x}, device=self.device)
        return torch.as_tensor(out[self.graph.outputs[0]], device=self.device)

    # -- per-stage timing -------------------------------------------------
    def stage_latencies(self, x, iters: int = 5) -> List[Dict[str, object]]:
        """Median wall time per stage on one representative batch.

        Per stage: one discarded warm call, then ``iters`` timed calls, each
        ending in a device synchronise, median reported. Stages run in
        schedule order on the previous stage's real output. Every timed
        sample is also recorded as a ``stage`` span on the tracer."""
        tr = self.tracer
        out = []
        h = self._input(x)
        for s in self.schedule.stages:
            y = self._apply_stage(s, h)
            self._sync()
            times = []
            for it in range(max(iters, 1)):
                t0 = obs_timer.now()
                self._apply_stage(s, h)
                self._sync()
                t1 = obs_timer.now()
                if tr.enabled:
                    tr.add_span("stage", t0, t1, cat="probe",
                                args={"stage": s.name,
                                      "kind": type(s).__name__, "iter": it})
                times.append(t1 - t0)
            times.sort()
            out.append({"stage": s.name, "kind": type(s).__name__,
                        "ms": times[len(times) // 2] * 1e3})
            h = y
        return out

    # -- streaming (micro-batched pipeline) -------------------------------
    def plan_streaming(self, n_micro: int, micro_batch: int = 1
                       ) -> Tuple[List[int], int]:
        """Size the inter-stage queues with the paper's FIFO pass.

        Each stage's simulated service time scales with its per-sample work
        (``stage_work``) times the micro-batch size, plus a fixed per-hop
        overhead (``core.dataflow.micro_batch_stage``). Plans are memoized
        per (n_micro, micro_batch): the simulation is deterministic, and
        the streaming entry points re-plan every call."""
        cached = self._plan_cache.get((n_micro, micro_batch))
        if cached is not None:
            return list(cached[0]), cached[1]
        sim = [micro_batch_stage(s.name, stage_work(s), micro_batch)
               for s in self.schedule.stages]
        res = optimize_fifo_depths(sim, n_tokens=n_micro)
        plan = (list(res["optimized_depths"]), int(res["optimized_cycles"]))
        self._plan_cache[(n_micro, micro_batch)] = plan
        return list(plan[0]), plan[1]

    def _pad_micro(self, x_int, micro_batch: int):
        x_int = self._input(x_int)
        n = x_int.shape[0]
        pad = (-n) % micro_batch
        if pad:
            x_int = torch.cat(
                [x_int, x_int.new_zeros((pad,) + tuple(x_int.shape[1:]))])
        return x_int, n, x_int.shape[0] // micro_batch

    def streaming_host(self, x_int, micro_batch: Optional[int] = None,
                       fifo_depths: Optional[Sequence[int]] = None,
                       feed_order: Optional[Sequence[int]] = None,
                       ) -> Tuple[torch.Tensor, StreamingStats]:
        """The queue-loop pipeline: bounded host-side queues.

        Numerically identical to ``offline`` / ``streaming_compiled``; the
        difference is the execution schedule: at most ``depth[i]``
        micro-batches may queue in front of stage i, the capacities coming
        from the FIFO optimizer. Every stage runs on its own kernel, once
        per micro-batch. ``micro_batch=None`` resolves to the same default
        as ``streaming_compiled``. ``fifo_depths`` overrides the optimizer's
        capacities (backpressure testing: depth-1 FIFOs must still make
        progress); ``feed_order`` permutes micro-batch admission (the idx
        bookkeeping restores batch order regardless).
        """
        micro_batch = (int(micro_batch) if micro_batch
                       else DEFAULT_MICRO_BATCH)
        x_int, n, n_micro = self._pad_micro(x_int, micro_batch)
        depths, sim_cycles = self.plan_streaming(n_micro,
                                                 micro_batch=micro_batch)
        if fifo_depths is not None:
            if len(fifo_depths) != len(depths):
                raise ValueError(
                    f"fifo_depths has {len(fifo_depths)} entries for "
                    f"{len(depths)} pipeline queues: {list(fifo_depths)}")
            depths = [max(1, int(d)) for d in fifo_depths]

        stages = self.schedule.stages
        n_stages = len(stages)
        queues = [collections.deque() for _ in range(n_stages + 1)]
        max_occ = [0] * (n_stages + 1)
        order = list(feed_order) if feed_order is not None \
            else list(range(n_micro))
        if sorted(order) != list(range(n_micro)):
            raise ValueError(
                f"feed_order must be a permutation of range({n_micro}), "
                f"got {order}")
        feed = [(i, x_int[i * micro_batch:(i + 1) * micro_batch])
                for i in order]
        feed_i = 0
        done: List[Optional[torch.Tensor]] = [None] * n_micro

        tr = self.tracer
        while feed_i < n_micro or any(len(q) > 0 for q in queues[:-1]):
            # admit into the input queue while its FIFO has room
            while feed_i < n_micro and len(queues[0]) < depths[0]:
                queues[0].append(feed[feed_i])
                max_occ[0] = max(max_occ[0], len(queues[0]))
                feed_i += 1
            if tr.enabled:
                tr.counter("fifo0", len(queues[0]), cat="fifo", tid=1)
            # fire stages downstream-first so space frees upstream
            for si in reversed(range(n_stages)):
                out_cap = depths[si + 1] if si + 1 < n_stages else n_micro + 1
                if queues[si] and len(queues[si + 1]) < out_cap:
                    idx, h = queues[si].popleft()
                    t0 = obs_timer.now() if tr.enabled else 0.0
                    h = self._apply_stage(stages[si], h)
                    queues[si + 1].append((idx, h))
                    max_occ[si + 1] = max(max_occ[si + 1], len(queues[si + 1]))
                    if tr.enabled:
                        tr.add_span("fire", t0, obs_timer.now(), cat="fifo",
                                    tid=si + 1,
                                    args={"stage": stages[si].name,
                                          "micro": idx})
                        tr.counter(f"fifo{si + 1}", len(queues[si + 1]),
                                   cat="fifo", tid=si + 2)
            while queues[-1]:
                idx, y = queues[-1].popleft()
                done[idx] = y
        y = torch.cat(done)[:n]
        return y, StreamingStats(micro_batch=micro_batch, n_micro=n_micro,
                                 fifo_depths=depths, max_occupancy=max_occ,
                                 sim_cycles=sim_cycles, mode="host",
                                 segments=[(s.start, s.stop)
                                           for s in self.segments])

    # the historical name stays pointed at the observable reference path
    streaming = streaming_host

    # -- wave submission (the serve router's entry point) ------------------
    def submit_wave(self, x_int, valid: Optional[Sequence[bool]] = None,
                    micro_batch: Optional[int] = None
                    ) -> Tuple[torch.Tensor, np.ndarray]:
        """Run ONE (possibly partially filled) micro-batch wave.

        Accepts ``n <= micro_batch`` rows plus an optional ``valid`` mask,
        zero-pads up to the wave size (code 0 is value 0 under the export
        contract, so padding rows are inert) and pushes the wave through
        the same segment programs as ``streaming_compiled`` (shape
        ``(1, micro_batch, ...)``). Returns ``(y, mask)`` where ``y`` covers
        the full wave and ``mask`` marks the rows that carry real queries;
        ``y[mask]`` is bit-identical to ``offline`` on the valid rows.

        The padding contract: invalid rows are forced to zero codes on the
        host before execution (whatever the caller left in them), so the
        device only ever sees the one wave shape per lane; stages are
        row-independent, so an invalid row cannot perturb a valid one.
        Validation errors are ``ValueError``s; a failure inside execution
        comes out as ``serve.faults.WaveError``.
        """
        mb = int(micro_batch) if micro_batch else DEFAULT_MICRO_BATCH
        xb = (x_int.cpu().numpy() if isinstance(x_int, torch.Tensor)
              else np.asarray(x_int))
        n = xb.shape[0]
        if n > mb:
            raise ValueError(f"wave of {n} rows exceeds micro_batch={mb}")
        mask = np.ones(n, bool) if valid is None \
            else np.asarray(valid, bool).reshape(-1)
        if mask.shape[0] != n:
            raise ValueError(f"valid mask has {mask.shape[0]} entries "
                             f"for a wave of {n} rows")
        mask = np.concatenate([mask, np.zeros(mb - n, bool)])
        # pad and zero the invalid rows on the host: one wave shape per lane
        buf = np.zeros((mb,) + xb.shape[1:], xb.dtype)
        buf[:n][mask[:n]] = xb[mask[:n]]
        wave = torch.as_tensor(buf[None], device=self.device)
        try:
            wave = self._run_segments(wave, 1, mode="submit_wave")
        except Exception as e:
            # a raw runtime exception must not escape the serving entry
            # point untyped; the validation ValueErrors above stay raw
            raise WaveError(
                f"wave of {n}/{mb} rows failed in the compiled segment "
                f"pipeline: {type(e).__name__}: {e}") from e
        return wave[0], mask

    def _run_segments(self, wave, n_micro: int, mode: str):
        """Push a stacked wave through every segment program, recording one
        ``segment`` span per segment when a tracer is installed. Spans
        measure host-side dispatch (tid = segment index + 1); on the card
        the kernels may still be running when a span closes."""
        tr = self.tracer
        for k, seg in enumerate(self.segments):
            t0 = obs_timer.now() if tr.enabled else 0.0
            if seg.compiled:
                wave = self._segment_fn(k)(wave)
            else:
                # host boundary: the fallback interpreter, per micro-batch
                wave = torch.stack([self._chain(
                    self.schedule.stages[seg.start:seg.stop], wave[i])
                    for i in range(n_micro)])
            if tr.enabled:
                tr.add_span("segment", t0, obs_timer.now(), cat="executor",
                            tid=k + 1,
                            args={"segment": k, "mode": mode,
                                  "compiled": bool(seg.compiled),
                                  "megakernel": k in self._mega_plans,
                                  "stages": [seg.start, seg.stop]})
        return wave

    # -- streaming, segment programs (the deployment hot path) -------------
    def _chain(self, stages, h):
        for s in stages:
            h = self._apply_stage(s, h)
        return h

    def _per_micro(self, stages, wave):
        """``stages`` on each micro-batch of a (n_micro, mb, ...) wave."""
        return torch.stack([self._chain(stages, wave[i])
                            for i in range(wave.shape[0])])

    def _segment_fn(self, k: int) -> Callable:
        """The program running segment k's whole micro-batch wave.

        Staged form: every micro-batch through the segment's stage chain
        in turn. When the planner admitted a megakernel for this segment,
        the planned run executes as ONE launch over the *flattened* wave
        instead (row-independent stages make the flattening exact); only
        the segment's remainder stages before and after it (e.g. the float
        head) still go micro-batch by micro-batch."""
        seg = self.segments[k]
        plan = self._mega_plans.get(k)
        stages = self.schedule.stages
        if plan is None:
            return lambda wave: self._per_micro(stages[seg.start:seg.stop],
                                                wave)
        pre = stages[seg.start:plan.start]
        post = stages[plan.stop:seg.stop]

        def run_wave(wave):
            if pre:
                wave = self._per_micro(pre, wave)
            n_micro, mb = wave.shape[0], wave.shape[1]
            flat = self._apply_mega(plan, wave.reshape(
                (n_micro * mb,) + tuple(wave.shape[2:])))
            wave = flat.reshape((n_micro, mb) + tuple(flat.shape[1:]))
            if post:
                wave = self._per_micro(post, wave)
            return wave

        return run_wave

    def streaming_compiled(self, x_int, micro_batch: Optional[int] = None
                           ) -> Tuple[torch.Tensor, StreamingStats]:
        """Run the batch as a micro-batched pipeline without the host queue
        loop: the batch is cut into micro-batches, stacked into one wave
        and pushed through each segment program (``_segment_fn``).
        Bit-identical to ``offline`` and ``streaming_host``.
        ``micro_batch=None`` uses ``DEFAULT_MICRO_BATCH``."""
        mb = int(micro_batch) if micro_batch else DEFAULT_MICRO_BATCH
        x_int, n, n_micro = self._pad_micro(x_int, mb)
        depths, sim_cycles = self.plan_streaming(n_micro, micro_batch=mb)
        wave = x_int.reshape((n_micro, mb) + tuple(x_int.shape[1:]))
        wave = self._run_segments(wave, n_micro, mode="streaming_compiled")
        y = wave.reshape((n_micro * mb,) + tuple(wave.shape[2:]))[:n]
        # no host queues to observe: report the FIFO model's occupancy
        # (depth = max occupancy + 1 by construction of the optimizer)
        return y, StreamingStats(micro_batch=mb, n_micro=n_micro,
                                 fifo_depths=depths,
                                 max_occupancy=[d - 1 for d in depths],
                                 sim_cycles=sim_cycles, mode="compiled",
                                 segments=[(s.start, s.stop)
                                           for s in self.segments],
                                 megakernel=[(p.start, p.stop) for p in
                                             self._mega_plans.values()])


def compile_graph(graph: Graph, in_scale: float = 1.0 / 127.0,
                  conv_lowering: Optional[str] = None,
                  megakernel: Optional[bool] = None, tracer=None,
                  device=None) -> CompiledTinyModel:
    """The one-call deployment entry point: QIR graph -> executor.

    ``device`` None means CUDA and raises when no card is present (there is
    no silent CPU fallback); ``device="cpu"`` runs the plain CPU path.
    ``conv_lowering`` picks the conv stage algorithm ("direct" kernel by
    default, "im2col"); None defers to ``REPRO_CONV_LOWERING``.
    ``megakernel`` None (the default) lets the planner decide per segment,
    True states the same intent, False runs every stage on its own kernel.
    """
    schedule = lower_graph(graph, in_scale=in_scale,
                           conv_lowering=conv_lowering)
    return CompiledTinyModel(schedule, graph=graph, device=device,
                             megakernel=megakernel, tracer=tracer)

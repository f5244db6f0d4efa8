"""Executable form of a lowered QIR graph, on torch.

The port of ``repro.deploy.executor``'s offline half. ``compile_graph``
lowers a QIR graph (``deploy.lower``), moves the stage schedule to the
device and returns a ``CompiledTinyModel`` whose ``offline`` runs the whole
batch through every stage in order (MLPerf Offline).

Every fused integer stage calls a kernel wrapper — ``threshold_matmul``
for dense stages and im2col conv stages, ``conv_threshold`` for direct conv
stages (``kernels.ops``). On CUDA the wrapper launches its hand-written
kernel (torch has no int32 matmul on CUDA, and the CUDA path never reaches
a plain version); on the CPU it runs the kernel's plain version, which
gives the integers of the reference with ``use_pallas=False``.

This slice runs the staged configuration (the reference's
``megakernel=False``); the megakernel, the autotuner, the streaming paths
and ``submit_wave`` come with later slices. The unfused per-node
interpreter (``reference``) is kept as the baseline.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.qir import Graph, resolve_device
from repro_torch.deploy.lower import (
    FlattenStage,
    FloatHeadStage,
    FusedConvThresholdStage,
    FusedThresholdStage,
    IntPoolStage,
    RefChainStage,
    StageSchedule,
    lower_graph,
)
from repro_torch.obs import timer as obs_timer
from repro_torch.obs.tracer import NULL_TRACER


class CompiledTinyModel:
    """A compiled integer-dataflow executor for one lowered QIR graph,
    holding its schedule on one device."""

    def __init__(self, schedule: StageSchedule, graph: Optional[Graph] = None,
                 device=None, tracer=None):
        self.device = resolve_device(device)
        self.schedule = schedule.to(self.device)
        self.graph = graph
        #: obs.Tracer sink for stage spans; NULL_TRACER keeps every
        #: instrumentation site a no-op
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def set_tracer(self, tracer) -> "CompiledTinyModel":
        """Install (or clear, with ``None``) the obs tracer; returns self."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        return self

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

    def offline(self, x_int) -> torch.Tensor:
        """Full batch through every stage (MLPerf Offline); returns the last
        stage's output on the model's device (work may still be queued on
        the card: synchronise before reading a clock)."""
        h = self._input(x_int)
        for s in self.schedule.stages:
            h = self._apply_stage(s, h)
        return h

    def stage_outputs(self, x_int) -> List[torch.Tensor]:
        """Per-stage outputs (integer codes for fused stages) — the parity
        surface the exactness tests check."""
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


def compile_graph(graph: Graph, in_scale: float = 1.0 / 127.0,
                  conv_lowering: Optional[str] = None, tracer=None,
                  device=None) -> CompiledTinyModel:
    """The one-call deployment entry point: QIR graph -> executor.

    ``device`` None means CUDA and raises when no card is present (there is
    no silent CPU fallback); ``device="cpu"`` runs the plain CPU path.
    ``conv_lowering`` picks the conv stage algorithm ("direct" kernel by
    default, "im2col"); None defers to ``REPRO_CONV_LOWERING``.
    """
    schedule = lower_graph(graph, in_scale=in_scale,
                           conv_lowering=conv_lowering)
    return CompiledTinyModel(schedule, graph=graph, device=device,
                             tracer=tracer)

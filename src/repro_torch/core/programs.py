"""Compiled programs: one captured CUDA graph per input shape.

The port's counterpart of ``jax.jit`` for a function of fixed-shape
tensors on one device. The reference turns each of its serving entry
points into one compiled program per input shape (``offline``, the
segment wave programs, ``CompiledJaxModel.offline``, ``ServeEngine``'s
decode and prefill steps); on the card the counterpart of one compiled
program is one CUDA graph, captured once and replayed.

``Program(fn, device)`` is called with tensors, on the host or on the
device, and:

  * on a CUDA device, looks up the graph of the call's key (the inputs'
    shapes and dtypes, and the current stream: callers on two streams,
    the replicas of a pool, never share buffers). The first call with a
    key runs ``fn`` once on a side stream (the warm-up: it builds the
    kernels, makes cuBLAS's handle and takes the first launches of each
    kernel; it is the call's own run and its result is the call's), then
    captures ``fn`` into a graph over static input buffers. Every later
    call copies its inputs into those buffers, replays the graph on the
    current stream and returns a clone of the outputs: two calls never
    return aliased tensors, as the reference returns a fresh array each
    time;
  * on the CPU, calls ``fn`` (the plain path, as every CPU test runs it).

``fn`` runs under ``torch.no_grad`` on every path: a program has no
autograd tape, as a jit program has none. A bound method is held
weakly, so that an object keeping a program of its own method (an
executor's ``offline``, an engine's decode step) is freed, with its
graphs and their memory, when its last reference goes, not at the next
garbage collection. Its outputs are a tensor or a
tree of tensors (``core.pytree``); what it writes in place into tensors
it holds (a decode step's caches) is written by every replay.

Launch counts: a replay launches the kernels without passing through the
wrappers of ``kernels.ops``, so the capture reads how many launches of
each kernel the graph holds (the counters' change across the capture,
which launches nothing and is taken back) and every replay adds them to
``ops.launches``. The warm-up's launches are counted by the wrappers, as
every eager launch is.

No fallback: a capture or a replay that fails on the card raises
``RuntimeError``; the program never carries on eagerly. Treat it as the
process's end: after an aborted capture (torch 2.11) the caching
allocator was seen to keep tens of GiB it could no longer hand back. ``fn`` runs as
it is (no graph) only where a graph cannot be what the caller wants:
while another capture is running on the current stream (the enclosing
graph takes ``fn``'s launches, as a jit program inlines a jit call) and
while ``ops.kernel_observers`` count every kernel call (the op-trace
analysis must see each op). ``eager(*args)`` runs ``fn`` so on purpose
(the eager baseline a caller holds the graphs against, a step under a
mesh, whose ``gloo`` collectives a graph cannot hold).
"""

from __future__ import annotations

import dataclasses
import inspect
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.pytree import leaves, tree_map
from repro_torch.kernels import ops

__all__ = ["Program"]


@dataclasses.dataclass
class _Graph:
    """One captured graph: its static inputs and outputs, and the kernel
    launches one replay makes."""

    graph: Any
    inputs: Tuple[torch.Tensor, ...]
    outputs: Any
    launches: Dict[str, int]


def _key(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype) for a in args)


class Program:
    """``fn`` compiled per input shape on ``device``: a captured CUDA
    graph per (shapes, dtypes, stream) on the card, ``fn`` itself on the
    CPU (module docstring)."""

    def __init__(self, fn: Callable, device, name: Optional[str] = None):
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)
        self.device = torch.device(device)
        self.name = name or getattr(fn, "__name__", "program")
        self._graphs: Dict[tuple, _Graph] = {}

    @property
    def fn(self) -> Callable:
        """The function (a bound method while its object lives)."""
        fn = self._fn()
        if fn is None:
            raise RuntimeError(f"program {self.name}: its object is gone")
        return fn

    def __len__(self) -> int:
        """Graphs held."""
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph (and its memory pool)."""
        self._graphs.clear()

    def replay_launches(self) -> Dict[tuple, Dict[str, int]]:
        """Per graph key, the kernel launches one replay makes."""
        return {k: dict(g.launches) for k, g in self._graphs.items()}

    def eager(self, *args):
        """``fn`` on the arguments moved to the device, no graph."""
        with torch.no_grad():
            return self.fn(*(a.to(self.device, non_blocking=True)
                             for a in args))

    def __call__(self, *args):
        if (self.device.type != "cuda" or ops.kernel_observers
                or torch.cuda.is_current_stream_capturing()):
            return self.eager(*args)
        stream = torch.cuda.current_stream(self.device)
        key = _key(args) + (stream.cuda_stream,)
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, args, stream)
        try:
            for buf, a in zip(entry.inputs, args):
                if buf.data_ptr() != a.data_ptr():
                    buf.copy_(a, non_blocking=True)
            entry.graph.replay()
        except Exception as e:
            raise RuntimeError(f"program {self.name}: replay of "
                               f"{_key(args)} failed: {type(e).__name__}: "
                               f"{e}") from e
        for k, n in entry.launches.items():
            ops.launches[k] += n
        return tree_map(lambda t: t.clone(), entry.outputs)

    def _capture(self, key, args, stream):
        """Warm up on a side stream (the call's result), then capture."""
        with torch.inference_mode(False):
            inputs = tuple(torch.empty(a.shape, dtype=a.dtype,
                                       device=self.device) for a in args)
        for buf, a in zip(inputs, args):
            buf.copy_(a, non_blocking=True)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.no_grad(), torch.cuda.stream(side):
            out = self.fn(*inputs)
        stream.wait_stream(side)
        for t in leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(stream)
        before = dict(ops.launches)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                outputs = self.fn(*inputs)
        except Exception as e:
            raise RuntimeError(f"program {self.name}: capture of "
                               f"{_key(args)} failed: {type(e).__name__}: "
                               f"{e}") from e
        finally:
            launched = {k: ops.launches[k] - n for k, n in before.items()}
            ops.launches.update(before)
        self._graphs[key] = _Graph(graph, inputs, outputs,
                                   {k: n for k, n in launched.items() if n})
        return out

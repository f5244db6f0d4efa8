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
    kernel; it is the call's own run and its result is the call's, an
    output that is a view of an input buffer cloned), then captures
    ``fn`` into a graph over static input buffers. Every later
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

``StepProgram(fn, device)`` is the same for a training step, the
counterpart of ``jax.jit(step, donate_argnums=(0,))``: ``fn(state,
batch) -> (state, metrics)`` runs with autograd (it takes gradients
inside) and updates ``state``, a tree of tensors, in place. The program
adopts the caller's state tensors as its graphs' static buffers (the
donation): it copies no state, neither at capture nor at any step, and
returns the same tensors as the new state. Only the batch is copied in
(host arrays and tensors, outside the graph) and only the metrics are
cloned out. The warm-up is the call's own step, as above. A call with
another state's tensors drops the graphs of the old one. What the caller
writes into the state between calls (a restored checkpoint) must be
copied into those tensors in place, never put in their stead.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import leaves, tree_map, unflatten_like
from repro_torch.kernels import ops

__all__ = ["Program", "StepProgram"]

log = logging.getLogger("repro_torch.programs")


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


class _Compiled:
    """What both kinds of program share: the function (a bound method held
    weakly), the device and the graphs by key."""

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

    def _graphed(self) -> bool:
        """Whether this call may take a graph (module docstring)."""
        return (self.device.type == "cuda" and not ops.kernel_observers
                and not torch.cuda.is_current_stream_capturing())

    def _replay(self, entry: _Graph, args, key) -> None:
        """Copy ``args`` into the graph's inputs, replay it and count its
        launches."""
        try:
            for buf, a in zip(entry.inputs, args):
                if buf.data_ptr() != a.data_ptr():
                    buf.copy_(a, non_blocking=True)
            entry.graph.replay()
        except Exception as e:
            raise RuntimeError(f"program {self.name}: replay of {key} "
                               f"failed: {type(e).__name__}: {e}") from e
        for k, n in entry.launches.items():
            ops.launches[k] += n

    def _static(self, args) -> Tuple[torch.Tensor, ...]:
        """Static device buffers holding ``args``' values."""
        with torch.inference_mode(False):
            bufs = tuple(torch.empty(a.shape, dtype=a.dtype,
                                     device=self.device) for a in args)
        for buf, a in zip(bufs, args):
            buf.copy_(a, non_blocking=True)
        return bufs

    def _warm_up(self, fn: Callable, stream, inputs):
        """``fn()`` on a side stream that ``stream`` then waits for (the
        call's own run, before its capture); its outputs are kept for
        ``stream``, and an output that is a view of a static input buffer
        (a reshape) is cloned: the next call overwrites the buffer."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = fn()
            held = {b.untyped_storage().data_ptr() for b in inputs}
            out = tree_map(
                lambda t: (t.clone() if isinstance(t, torch.Tensor)
                           and t.untyped_storage().data_ptr() in held
                           else t), out)
        stream.wait_stream(side)
        for t in leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(stream)
        return out

    def _record(self, fn: Callable, key) -> Tuple[Any, Any, Dict[str, int]]:
        """(graph, ``fn()``'s outputs in it, the launches it holds):
        ``fn`` captured on the current device, the counters' change taken
        back."""
        before = dict(ops.launches)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = fn()
        except Exception as e:
            raise RuntimeError(f"program {self.name}: capture of {key} "
                               f"failed: {type(e).__name__}: {e}") from e
        finally:
            launched = {k: ops.launches[k] - n for k, n in before.items()}
            ops.launches.update(before)
        return graph, outputs, {k: n for k, n in launched.items() if n}


class Program(_Compiled):
    """``fn`` compiled per input shape on ``device``: a captured CUDA
    graph per (shapes, dtypes, stream) on the card, ``fn`` itself on the
    CPU (module docstring)."""

    def eager(self, *args):
        """``fn`` on the arguments moved to the device, no graph."""
        with torch.no_grad():
            return self.fn(*(a.to(self.device, non_blocking=True)
                             for a in args))

    def __call__(self, *args):
        if not self._graphed():
            return self.eager(*args)
        stream = torch.cuda.current_stream(self.device)
        key = _key(args) + (stream.cuda_stream,)
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, args, stream)
        self._replay(entry, args, _key(args))
        return tree_map(lambda t: t.clone(), entry.outputs)

    def _capture(self, key, args, stream):
        """Warm up on a side stream (the call's result), then capture."""
        inputs = self._static(args)

        def run():
            with torch.no_grad():
                return self.fn(*inputs)

        out = self._warm_up(run, stream, inputs)
        graph, outputs, launched = self._record(run, _key(args))
        self._graphs[key] = _Graph(graph, inputs, outputs, launched)
        return out


def _as_tensor(leaf):
    """A batch leaf as a tensor (a host array becomes a host tensor), or
    the leaf itself when it is no array."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, np.ndarray):
        return torch.as_tensor(leaf)
    return leaf


class StepProgram(_Compiled):
    """A training step ``fn(state, batch) -> (state, metrics)`` compiled
    per batch shape on ``device`` with ``state`` donated: a captured CUDA
    graph per (batch shapes, dtypes, stream) over the caller's state
    tensors on the card, ``fn`` itself on the CPU (module docstring)."""

    def __init__(self, fn: Callable, device, name: Optional[str] = None):
        super().__init__(fn, device, name)
        #: the adopted state's tensors, which the graphs read and write
        self._state: Optional[List[Any]] = None
        self._told_eager = False

    def eager(self, state, batch):
        """``fn`` on ``state`` and the batch moved to the device, no
        graph."""
        return self.fn(state, tree_map(
            lambda a: (a.to(self.device, non_blocking=True)
                       if isinstance(a, torch.Tensor) else a),
            tree_map(_as_tensor, batch)))

    def _adopt(self, state) -> None:
        """Make ``state``'s tensors the program's; another state's graphs
        are dropped."""
        held = leaves(state)
        if self._state is None or len(held) != len(self._state) or any(
                a is not b for a, b in zip(held, self._state)):
            self.clear()
            self._state = held

    def _donated(self, new_state, key) -> None:
        """The step must return the state it was given, updated in place."""
        got = leaves(new_state)
        if len(got) != len(self._state) or any(
                a is not b for a, b in zip(got, self._state)):
            raise RuntimeError(f"program {self.name}: the step of {key} "
                               f"returned other tensors than its state; a "
                               f"donated state is updated in place")

    def clear(self) -> None:
        super().clear()
        self._state = None

    def __call__(self, state, batch):
        if not self._graphed():
            if self.device.type == "cuda" and not self._told_eager:
                self._told_eager = True
                log.info("program %s: steps run eagerly (kernel observers "
                         "or an enclosing capture)", self.name)
            return self.eager(state, batch)
        batch = tree_map(_as_tensor, batch)
        args = [a for a in leaves(batch) if isinstance(a, torch.Tensor)]
        consts = tuple(repr(a) for a in leaves(batch)
                       if not isinstance(a, torch.Tensor))
        self._adopt(state)
        stream = torch.cuda.current_stream(self.device)
        key = _key(args) + (consts, stream.cuda_stream)
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, state, batch, args, stream)
        self._replay(entry, args, _key(args))
        return state, tree_map(lambda t: t.clone(), entry.outputs)

    def _capture(self, key, state, batch, args, stream):
        """The call's own step on a side stream (the warm-up), then the
        step captured over the same state tensors and static batch
        buffers."""
        inputs = self._static(args)
        it = iter(inputs)
        static = unflatten_like(batch, [
            next(it) if isinstance(a, torch.Tensor) else a
            for a in leaves(batch)])
        new_state, out = self._warm_up(lambda: self.fn(state, static),
                                       stream, inputs)
        self._donated(new_state, _key(args))
        graph, (new_state, outputs), launched = self._record(
            lambda: self.fn(state, static), _key(args))
        self._donated(new_state, _key(args))
        self._graphs[key] = _Graph(graph, inputs, outputs, launched)
        return state, out

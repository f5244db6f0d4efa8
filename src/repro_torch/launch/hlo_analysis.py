"""Op-trace analysis of a traced call: FLOPs, bytes, collectives and live
memory, the port's counterpart of ``repro.launch.hlo_analysis``.

The name is kept so that a reader finds the counterpart, but nothing here
reads HLO. The reference parses the compiled, SPMD-partitioned HLO text
of a jitted step: dot and convolution FLOPs per computation, while-loop
trip counts from the loop conditions, collective output bytes, summed
bottom-up through the call graph. The port has no XLA, no HLO and no
partitioner; it runs the call itself, eagerly, under a
``TorchDispatchMode`` (``OpCounter``) that sees every aten op the call
issues below autograd, on any device: on ``meta`` (shapes only, nothing
allocated: the dry run), on the CPU, on the card. What it counts:

  * dots (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``addbmm``, ``mv``,
    ``dot``, ``_int_mm``): the reference's ``2 * out * contract``;
    convolutions (forward, and each gradient ``convolution_backward``
    computes): ``2 * out * k * cin``, cin the kernel's input features
    per group, as the reference's ``_conv_flops`` reads them;
  * a kernel call (``kernels.ops``' wrappers tell the counter of each
    call, ``ops.kernel_observers``) once, by its own formula
    (``KERNEL_COUNTS``: the operation and byte counts ``chip_smoke.py``
    bounds each kernel by), the same on meta, on the CPU and on the card;
    the ops the call issues (its plain version on the CPU, the output's
    allocation) count nothing. A kernel without a formula raises, so no
    work goes uncounted unseen;
  * collectives: the output bytes of each ``torch.distributed`` op on
    this rank (what it returns, or the output argument that a c10d op
    which returns only its work handle writes), by the reference's kinds: the reference's
    measure, a collective's output bytes on the device. The port issues
    its collectives as c10d ops (``parallel.collectives``, the step's
    gradient reductions), which reach the dispatch mode below autograd
    on any backend, torch's fake one on meta tensors too (the dry run's
    rank-local steps);
  * bytes accessed: every op's operand and result bytes (views and bare
    allocations aside), a kernel's once;
  * memory: the bytes of every live storage, as the caching allocator
    would hold them, from the call's arguments on; the peak, the
    arguments' and the result's bytes.

Python loops over layers take the place of scan trip counts: the trace
sees every iteration. Recomputed activations (remat) are counted again,
as the reference's HLO holds the duplicated dots.

On ``meta`` a functional op's output depends only on its operands'
shapes, strides and dtypes and on its other arguments, and torch computes
it in Python (about 0.2 ms an elementwise op), which the scans of the
mamba layers repeat hundreds of thousands of times a step. So the counter
keeps each such op's output layout by that key and makes the next
identical call's outputs directly (``torch.empty_strided``): every op is
still seen and counted; only the shape arithmetic is not redone.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: torch.distributed ops (c10d and functional) -> the reference's kinds
COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

_DOTS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
         "vdot", "_int_mm")
#: ops that write no data: allocations, and what only reads metadata
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh",
               "_local_scalar_dense")


def shape_bytes(*specs) -> int:
    """Bytes of tensors, or of ``(dtype, shape)`` pairs: the reference's
    ``shape_bytes`` of a type string such as ``(f32[4], s32[2])``."""
    total = 0
    for s in specs:
        if isinstance(s, torch.Tensor):
            total += s.numel() * s.element_size()
        else:
            dtype, shape = s
            total += int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return int(total)


@dataclasses.dataclass
class HloStats:
    flops: float = 0.0
    collective_bytes: float = 0.0
    by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_count: Dict[str, int] = dataclasses.field(default_factory=dict)

    def scaled(self, k: float) -> "HloStats":
        return HloStats(
            flops=self.flops * k,
            collective_bytes=self.collective_bytes * k,
            by_type={t: v * k for t, v in self.by_type.items()},
            by_count={t: int(v * k) for t, v in self.by_count.items()},
        )

    def add(self, other: "HloStats"):
        self.flops += other.flops
        self.collective_bytes += other.collective_bytes
        for t, v in other.by_type.items():
            self.by_type[t] = self.by_type.get(t, 0.0) + v
        for t, v in other.by_count.items():
            self.by_count[t] = self.by_count.get(t, 0) + v


# ---------------------------------------------------------------------------
# the kernels' own counts
# ---------------------------------------------------------------------------

def flash_live_pairs(sq, sk, causal, window, q_offset, kv_len) -> int:
    """Unmasked (query, key) pairs of one head: what K6 computes
    (``chip_smoke.flash_live_pairs``)."""
    kv_len = sk if kv_len is None else kv_len
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, kv_len) if causal else np.full(sq, kv_len)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo, 0, None).sum())


def _qmatmul_counts(d) -> Tuple[float, float]:
    """K5: 2 m k n operations; the codes, the scale (and bias) read once,
    the output written once (4 bytes an element in float32 and in the
    accumulator mode, which reads no scale)."""
    m, k, n = d["m"], d["k"], d["n"]
    vectors = 0 if d["acc_out"] else 4 * n * (2 if d["bias"] else 1)
    nbytes = m * k + k * n + vectors + m * n * (1 if d["int8_out"] else 4)
    return 2.0 * m * k * n, float(nbytes)


def _flash_counts(d) -> Tuple[float, float]:
    """K6: 4 b h d operations a live pair (the two products); q, k, v
    read once, the output (and the lse) written once."""
    pairs = flash_live_pairs(d["sq"], d["sk"], d["causal"], d["window"],
                             d["q_offset"], d["kv_len"])
    q = d["b"] * d["h"] * d["sq"] * d["d"]
    kv = d["b"] * d["hkv"] * d["sk"] * d["d"]
    nbytes = (2 * q + 2 * kv) * d["esize"]
    if d["lse"]:
        nbytes += 4 * d["b"] * d["h"] * d["sq"]
    return 4.0 * d["b"] * d["h"] * d["d"] * pairs, float(nbytes)


def _flash_bwd_counts(d) -> Tuple[float, float]:
    """K6's backward: 10 b h d operations a live pair (the five products
    of the gradients); q, k, v, out, d_out and lse read once, dq, dk, dv
    written once."""
    pairs = flash_live_pairs(d["sq"], d["sk"], d["causal"], d["window"],
                             d["q_offset"], d["kv_len"])
    q = d["b"] * d["h"] * d["sq"] * d["d"]
    kv = d["b"] * d["hkv"] * d["sk"] * d["d"]
    nbytes = (4 * q + 4 * kv) * d["esize"] + 4 * d["b"] * d["h"] * d["sq"]
    return 10.0 * d["b"] * d["h"] * d["d"] * pairs, float(nbytes)


#: kernel -> (operations, bytes) of one call from its dims
#: (``kernels.ops``' observers): the counts ``chip_smoke.py``'s kernel rows
#: bound each kernel by
KERNEL_COUNTS: Dict[str, Callable[[dict], Tuple[float, float]]] = {
    "qmatmul": _qmatmul_counts,
    "flash_attention": _flash_counts,
    "flash_attention_bwd": _flash_bwd_counts,
}


# ---------------------------------------------------------------------------
# aten ops
# ---------------------------------------------------------------------------

def _dot_flops(name: str, args) -> float:
    """2 * out * contract, as ``2 * |a| * (b's last dim)``."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addbmm",
                                          "addmv") else (args[0], args[1])
    return 2.0 * a.numel() * (b.shape[-1] if b.dim() >= 2 else 1)


def _conv_out_flops(out_numel: int, weight: torch.Tensor,
                    transposed: bool) -> float:
    """The reference's ``2 * out * k * cin`` (cin per group; a transposed
    conv's weight holds (cin, cout / groups, *k), so its products are
    counted from its input side)."""
    k = int(np.prod(weight.shape[2:], dtype=np.int64))
    return 2.0 * out_numel * k * weight.shape[0 if transposed else 1]


def _conv_flops(name: str, args, out) -> float:
    if name == "convolution":
        x, w, transposed = args[0], args[1], args[6]
        if transposed:
            return 2.0 * x.numel() * int(np.prod(w.shape[1:],
                                                 dtype=np.int64))
        return _conv_out_flops(out.numel(), w, False)
    # convolution_backward(grad_out, input, weight, ..., transposed, ...,
    # output_mask): each gradient costs the forward's products
    grad_out, x, w, transposed, mask = args[0], args[1], args[2], args[7], \
        args[10]
    fwd = (2.0 * x.numel() * int(np.prod(w.shape[1:], dtype=np.int64))
           if transposed else _conv_out_flops(grad_out.numel(), w, False))
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


@dataclasses.dataclass(frozen=True)
class _OpInfo:
    """What the counter needs of an op, read once from its schema."""
    name: str
    composite: bool     # has a composite decomposition to count through
    functional: bool    # neither mutates nor returns an alias
    traffic: bool       # moves data (not a view or a bare allocation)
    kind: Optional[str]  # the collective's kind, if it is one


_INFO: Dict[Any, _OpInfo] = {}


def _info(func) -> _OpInfo:
    info = _INFO.get(func)
    if info is None:
        name = func.overloadpacket.__name__
        schema = func._schema
        info = _OpInfo(
            name=name,
            composite=torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"),
            functional=not (schema.is_mutable or any(
                r.alias_info is not None for r in schema.returns)),
            traffic=not (func.is_view or name in _NO_TRAFFIC),
            kind=COLLECTIVE_OPS.get(name))
        _INFO[func] = info
    return info


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format)


def _leaf(x, tensors: list, key: Optional[list]) -> Optional[list]:
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        if key is not None:
            if not x.is_meta:
                return None
            key.append((x.shape, x.stride(), x.dtype))
    elif isinstance(x, (list, tuple)):
        if key is not None:
            key.append(len(x))
        for y in x:
            key = _leaf(y, tensors, key)
    elif key is not None:
        if x is None or isinstance(x, _PLAIN):
            key.append((type(x), x))
        else:
            return None
    return key


def _walk(args, kwargs, tensors: list, key: Optional[list]
          ) -> Optional[list]:
    """Collect an op's argument tensors into ``tensors`` and extend ``key``
    with their meta layout key; returns the key, or None once an argument
    has no plain key (or a tensor is not on meta)."""
    for x in args:
        if isinstance(x, torch.Tensor):     # the common case, inline
            tensors.append(x)
            if key is not None:
                if not x.is_meta:
                    key = None
                else:
                    key.append((x.shape, x.stride(), x.dtype))
        else:
            key = _leaf(x, tensors, key)
    for k in sorted(kwargs):
        if key is not None:
            key.append(k)
        key = _leaf(kwargs[k], tensors, key)
    return key


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceReport:
    """What ``OpCounter`` saw: the HLO statistics' counterpart, the bytes
    accessed, the memory figures (bytes; ``temp_bytes`` is the peak above
    the arguments, ``alias_bytes`` the result's bytes that are argument
    storages) and the kernel calls, ``(name, dims, ops, bytes)`` each."""
    stats: HloStats
    bytes_accessed: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0
    kernels: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def memory_analysis(self) -> Dict[str, int]:
        """The reference's ``memory_analysis`` keys."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.temp_bytes,
                "alias_size_in_bytes": self.alias_bytes}


class OpCounter(TorchDispatchMode):
    """Counts a call's work as the module docstring says. Use
    ``analyze_call``, or: ``with OpCounter() as c: c.track_arguments(...);
    out = fn(...)``, then ``c.report(out)``."""

    def __init__(self):
        super().__init__()
        self.stats = HloStats()
        self.bytes_accessed = 0.0
        self.kernels: List[tuple] = []
        self._live: Dict[int, int] = {}       # id(storage) -> bytes
        self._refs: Dict[int, Any] = {}       # id(storage) -> weak ref
        self._live_bytes = 0
        self.peak_bytes = 0
        self._arguments: Dict[int, int] = {}
        #: meta op key -> its outputs' layouts (None: not a plain tuple or
        #: tensor of tensors)
        self._layouts: Dict[tuple, Any] = {}

    # -- memory ------------------------------------------------------------
    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def _hold(self, t: torch.Tensor) -> int:
        """Register ``t``'s storage if it is new; its id."""
        st = t.untyped_storage()
        key = id(st)
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
            self._live_bytes += n
            if self._live_bytes > self.peak_bytes:
                self.peak_bytes = self._live_bytes
        return key

    def track_arguments(self, *trees) -> None:
        """The call's arguments: live from the start, not temporaries."""
        for t in _tensors(trees):
            key = self._hold(t)
            self._arguments[key] = self._live[key]

    def report(self, result=None) -> TraceReport:
        out_keys = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in _tensors(result)}
        return TraceReport(
            stats=self.stats, bytes_accessed=self.bytes_accessed,
            argument_bytes=sum(self._arguments.values()),
            output_bytes=sum(out_keys.values()),
            alias_bytes=sum(n for k, n in out_keys.items()
                            if k in self._arguments),
            peak_bytes=self.peak_bytes, kernels=list(self.kernels))

    # -- kernels -------------------------------------------------------------
    def _on_kernel(self, name: str, dims: dict) -> None:
        if name not in KERNEL_COUNTS:
            raise NotImplementedError(
                f"kernel {name!r} reached the op counter and has no "
                f"operation count (launch.hlo_analysis.KERNEL_COUNTS)")
        n_ops, nbytes = KERNEL_COUNTS[name](dims)
        self.stats.flops += n_ops
        self.bytes_accessed += nbytes
        self.kernels.append((name, dict(dims), n_ops, nbytes))

    def __enter__(self):
        ops.kernel_observers.append(self._on_kernel)
        try:
            return super().__enter__()
        except BaseException:
            ops.kernel_observers.remove(self._on_kernel)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops.kernel_observers.remove(self._on_kernel)

    # -- aten ops --------------------------------------------------------
    def _run(self, func, info: _OpInfo, args, kwargs):
        """``func(*args, **kwargs)`` and its argument tensors; on meta, a
        functional op's outputs made from the layouts the first identical
        call gave."""
        tensors: list = []
        key = _walk(args, kwargs, tensors, [func] if info.functional
                    else None)
        if key is None or not tensors:
            return func(*args, **kwargs), tensors
        key = tuple(key)
        layouts = self._layouts.get(key)
        if layouts is not None:
            made = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in layouts[1]]
            return (made[0] if layouts[0] else tuple(made)), tensors
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else out
        if isinstance(outs, tuple) and all(
                isinstance(t, torch.Tensor) for t in outs):
            self._layouts[key] = (single, [(tuple(t.shape), t.stride(),
                                            t.dtype) for t in outs])
        return out, tensors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = _info(func)
        if info.composite:
            # an op with a composite decomposition (``matmul``, ``einsum``,
            # ``linear``: they reach the mode whole where autograd is off,
            # as under ``inference_mode``) is counted by its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out, ins = self._run(func, info, args, kwargs)
        if isinstance(out, torch.Tensor):
            outs = [out]
        else:
            outs = []
            _leaf(out, outs, None)
        for t in outs:
            self._hold(t)
        if ops.inside_kernel():
            return out
        if info.kind is not None:
            nbytes = float(sum(shape_bytes(t) for t in _collective_outputs(
                args, outs)))
            stats = self.stats
            stats.collective_bytes += nbytes
            stats.by_type[info.kind] = stats.by_type.get(info.kind, 0.0) \
                + nbytes
            stats.by_count[info.kind] = stats.by_count.get(info.kind, 0) + 1
            return out
        if info.name in _DOTS:
            self.stats.flops += _dot_flops(info.name, args)
        elif info.name in ("convolution", "convolution_backward"):
            self.stats.flops += _conv_flops(info.name, args, outs[0])
        if info.traffic:
            self.bytes_accessed += float(
                sum(t.numel() * t.element_size() for t in ins)
                + sum(t.numel() * t.element_size() for t in outs))
        return out


def _collective_outputs(args, outs) -> List[torch.Tensor]:
    """The tensors a collective writes: what it returns (the functional
    ops; the c10d ops that return their outputs), else its first
    argument, the output c10d takes first (``alltoall_base_`` and
    ``send`` return only a work handle)."""
    if outs or not args:
        return outs
    written: list = []
    _leaf(args[0], written, None)
    return written


def analyze_call(fn: Callable, *args, **kwargs) -> Tuple[Any, TraceReport]:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter`` (the arguments
    tracked as live from the start); returns (its result, the report)."""
    with OpCounter() as counter:
        counter.track_arguments(args, kwargs)
        out = fn(*args, **kwargs)
    return out, counter.report(out)

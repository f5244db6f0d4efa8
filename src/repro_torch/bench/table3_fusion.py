"""Paper Table 3: what the generic optimisations (FIFO-depth sizing, ReLU/BN
merging, both) save, on the AD-family dense stack.

    python -m repro_torch.bench.table3_fusion [--device cuda]

The port of ``benchmarks/table3_fusion.py``. The paper's FPGA resources
map to what a torch program has:

  * buffer elements <- the FIFO depths of the dataflow simulation (BRAM),
    from ``core.dataflow`` as in the reference;
  * graph ops       <- the reference's HLO op count (LUT): the
    ``call_function`` nodes of the forward's aten graph (``make_fx``) that
    lie on the input's path. Nodes that read only the parameters (the BN
    fold's ``sqrt`` and products) are computed once at export in a
    deployment, as the paper's HLS merge is, so they are reported apart
    (``graph_ops_total`` counts every node);
  * temp bytes      <- XLA's temporary allocation of the compiled forward
    (FF/BRAM): on the card, the caching allocator's peak over one call
    less the bytes live before it; on the CPU there is no allocator to
    read, and the field is ``None``.

Four rows, the paper's Table 3 ladder: unfused with unbounded buffers,
with the FIFO pass, with ReLU/BN merged, with both. The forwards are the
reference's, op for op, on numpy-seeded parameters.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench.common import banner, print_rows, row, time_ms
from repro_torch.core.dataflow import (BIG_DEPTH, mlp_pipeline_stages,
                                       optimize_fifo_depths)
from repro_torch.core.qir import resolve_device
from repro_torch.obs import timer as obs_timer

DIMS = [128, 72, 72, 8, 72, 72, 128]
#: Rows of the input batch (the reference's ``x``: 196 x 128).
ROWS = 196

Params = List[Dict[str, torch.Tensor]]


def params_numpy(seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """The reference's parameters (``_params``) from a numpy generator:
    He-scaled normal weights, zero bias, identity BN statistics."""
    rng = np.random.default_rng(seed)
    ps = []
    for d_in, d_out in zip(DIMS[:-1], DIMS[1:]):
        ps.append({
            "w": (rng.standard_normal((d_in, d_out))
                  * d_in ** -0.5).astype(np.float32),
            "b": np.zeros(d_out, np.float32),
            "gamma": np.ones(d_out, np.float32),
            "beta": np.zeros(d_out, np.float32),
            "mu": np.zeros(d_out, np.float32),
            "sigma2": np.ones(d_out, np.float32)})
    return ps


def to_torch(params, device) -> Params:
    return [{k: torch.as_tensor(v, device=device) for k, v in p.items()}
            for p in params]


def _unfused_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Separate dataflow stages: matmul, +bias, BN, ReLU, quant."""
    h = x
    for p in params:
        h = h @ p["w"]
        h = h + p["b"]
        h = p["gamma"] * (h - p["mu"]) / torch.sqrt(p["sigma2"] + 1e-3) \
            + p["beta"]
        h = torch.relu(h)
        s = torch.max(torch.abs(h)) / 127.0 + 1e-9
        h = torch.round(h / s) * s
    return h


def _fused_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Folded BN, merged ReLU and quant in one affine stage (paper C3)."""
    h = x
    for p in params:
        v = p["gamma"] / torch.sqrt(p["sigma2"] + 1e-3)
        w = p["w"] * v[None, :]
        b = v * (p["b"] - p["mu"]) + p["beta"]
        h = torch.relu(h @ w + b)
        s = torch.max(torch.abs(h)) / 127.0 + 1e-9
        h = torch.round(h / s) * s
    return h


def graph_ops(fn, params: Params, x: torch.Tensor) -> Tuple[int, int]:
    """(ops on the input's path, all ops): ``call_function`` nodes of the
    aten graph ``make_fx`` traces from ``fn(params, x)``, the parameters
    closed over as constants."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(lambda xx: fn(params, xx))(x)
    on_path, n_path, n_all = set(), 0, 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            on_path.add(node)
        elif node.op == "call_function":
            n_all += 1
            if any(a in on_path for a in node.all_input_nodes):
                on_path.add(node)
                n_path += 1
    return n_path, n_all


def temp_bytes(fn, params: Params, x: torch.Tensor) -> Optional[int]:
    """Bytes the caching allocator held at its peak during one call beyond
    those live before it (the output included); None off the card."""
    if x.device.type != "cuda":
        return None
    torch.cuda.synchronize(x.device)
    before = torch.cuda.memory_allocated(x.device)
    torch.cuda.reset_peak_memory_stats(x.device)
    y = fn(params, x)
    torch.cuda.synchronize(x.device)
    peak = torch.cuda.max_memory_allocated(x.device)
    del y
    return int(peak - before)


def time_us(fn, params: Params, x: torch.Tensor) -> float:
    """Microseconds a call: device time by CUDA-graph replay on the card,
    the median of 5 host-clock calls after 2 warm ones on the CPU."""
    if x.device.type == "cuda":
        return time_ms(lambda: fn(params, x)) * 1e3
    for _ in range(2):
        fn(params, x)
    times = []
    for _ in range(5):
        t0 = obs_timer.now()
        fn(params, x)
        times.append(obs_timer.now() - t0)
    return statistics.median(times) * 1e6


def buffer_elems() -> Tuple[int, int]:
    """Buffer elements of the stack's pipeline: every FIFO at
    ``BIG_DEPTH`` (no pass), and the FIFO pass's depths."""
    stages = mlp_pipeline_stages(DIMS, reuse_factor=4)
    fifo = optimize_fifo_depths(stages, n_tokens=256)
    return BIG_DEPTH * (len(stages) + 1), int(fifo["total_buffer_elems"])


def run(device=None, seed: int = 0):
    banner("Table 3: fusion + buffer-opt resource ladder (AD-family stack)")
    dev = resolve_device(device)
    params = to_torch(params_numpy(seed), dev)
    x = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(
        (ROWS, DIMS[0])).astype(np.float32), device=dev)

    stats = {}
    for label, fn in (("unfused", _unfused_forward),
                      ("fused", _fused_forward)):
        ops, ops_all = graph_ops(fn, params, x)
        stats[label] = {"graph_ops": ops, "graph_ops_total": ops_all,
                        "temp_bytes": temp_bytes(fn, params, x),
                        "us": time_us(fn, params, x)}

    big_elems, opt_elems = buffer_elems()

    def ladder(name, label, elems, paper):
        s = stats[label]
        return row(name, s["us"], graph_ops=s["graph_ops"],
                   graph_ops_total=s["graph_ops_total"],
                   temp_bytes=s["temp_bytes"], buffer_elems=elems,
                   paper_row=paper)

    rows = [
        ladder("table3/without_opt", "unfused", big_elems,
               "477 BRAM / 79177 FF / 66838 LUT"),
        ladder("table3/with_fifo_opt", "unfused", opt_elems,
               "278 BRAM / 72686 FF / 58515 LUT"),
        ladder("table3/with_relu_bn_merge", "fused", big_elems,
               "345 BRAM / 72921 FF / 55292 LUT"),
        ladder("table3/with_all_opt", "fused", opt_elems,
               "146 BRAM / 66430 FF / 46969 LUT"),
    ]
    print_rows(rows)
    ops_u, ops_f = stats["unfused"]["graph_ops"], stats["fused"]["graph_ops"]
    print(f"op reduction from merging: {ops_u} -> {ops_f} "
          f"({1 - ops_f / ops_u:.0%}); buffer reduction: "
          f"{big_elems} -> {opt_elems} elems", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()

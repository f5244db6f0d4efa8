"""The paper's full §5 methodology, end to end, on the AD task, on the
card:

  float baseline -> hardware-aware NAS (ASHA, scored by quality + BOPs)
  -> bit-width descent (smallest width retaining quality, Fig. 4's
  procedure) -> QONNX-style export -> the compiled deployment (QIR ->
  streamlined integer stages -> the executor's kernels) -> MLPerf-Tiny
  scenarios.

The port of ``examples/mlperf_tiny_codesign.py``. Every training runs
``core.codesign.train_tiny`` on the device; the exported graph is written
to ``--out`` (default ``build/ad_model.qir.json`` in the repository).

Run: PYTHONPATH=src python -m repro_torch.examples.mlperf_tiny_codesign
     [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from repro_torch.bench.table1_models import train_ad
from repro_torch.core.bops import ModelCost, dense_cost
from repro_torch.core.codesign import bitwidth_descent, deploy_report
from repro_torch.core.qir import Graph, LayerBits, export_qmlp, resolve_device
from repro_torch.core.search import Choice, asha_search
from repro_torch.data.synthetic import SyntheticMelWindows
from repro_torch.deploy import compile_graph
from repro_torch.deploy.scenarios import offline as offline_scenario
from repro_torch.deploy.scenarios import single_stream
from repro_torch.models.tiny import ADAutoencoder

DATA = SyntheticMelWindows(dim=64, rank=8, seed=0)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def train_eval(width, bottleneck, bits, steps, device):
    model = ADAutoencoder(in_dim=64, width=width, bottleneck=bottleneck,
                          weight_bits=bits, act_bits=bits)
    r = train_ad(steps, device, seed=width * 31 + bits, model=model,
                 data=DATA, n_eval=300)
    return r["quality"], model, r["net"]


def model_bops(width, bottleneck, bits):
    dims = [64, width, width, bottleneck, width, width, 64]
    return ModelCost([dense_cost(f"fc{i}", dims[i], dims[i + 1], bits, bits)
                      for i in range(6)])


def run(device=None, out: str = None) -> Dict:
    dev = resolve_device(device)
    out = out or os.path.join(ROOT, "build", "ad_model.qir.json")

    print("[1] float baseline (width=96, bottleneck=8)")
    auc_ref, _, _ = train_eval(96, 8, 32, 100, dev)
    print(f"    reference AUC = {auc_ref:.3f}")

    print("[2] ASHA architecture search (quality - cost penalty)")
    ref_cost = model_bops(96, 8, 32)

    def objective(cfg, budget, rng):
        auc, _, _ = train_eval(cfg["width"], cfg["bottleneck"], 32,
                               20 * budget, dev)
        c = model_bops(cfg["width"], cfg["bottleneck"], 32).cost_vs(ref_cost)
        return auc - 0.05 * c

    space = [Choice("width", (24, 48, 72)), Choice("bottleneck", (4, 8, 16))]
    best, trials = asha_search(objective, space, n_trials=6, r_min=1, eta=2,
                               max_rung=2, seed=0)
    w, b = best.config["width"], best.config["bottleneck"]
    print(f"    chosen: width={w} bottleneck={b} (score {best.score:.3f}, "
          f"{sum(t.budget_used for t in trials)} budget units)")

    print("[3] bit-width descent")

    def eval_at_bits(bits):
        auc, _, _ = train_eval(w, b, bits, 80, dev)
        return auc, model_bops(w, b, bits).bops

    scan = bitwidth_descent(eval_at_bits, bit_ladder=(32, 8, 6, 4, 3),
                            tolerance=0.03)
    for e in scan.entries:
        print(f"    W{e['bits']}A{e['bits']}: AUC={e['quality']:.3f} "
              f"BOPs={e['bops']:.2e}")
    print(f"    chosen bits = {scan.chosen_bits}")

    print("[4] final model, QIR export, deploy report")
    auc, model, net = train_eval(w, b, scan.chosen_bits, 150, dev)
    graph = export_qmlp([LayerBits(l.weight_bits, l.act_bits)
                         for l in net.hidden],
                        [l.to_numpy() for l in net.hidden],
                        net.head.to_numpy(),
                        meta={"task": "AD", "bits": scan.chosen_bits})
    os.makedirs(os.path.dirname(out), exist_ok=True)
    graph.save(out)
    rep = deploy_report(model_bops(w, b, scan.chosen_bits), batch=1,
                        bits=scan.chosen_bits)
    print(f"    AUC={auc:.3f}  exported {len(graph.nodes)} QIR nodes -> "
          f"{out}")
    print(f"    deploy: latency={rep['latency_us']:.4f}us "
          f"energy={rep['energy_uJ']:.4f}uJ ({rep['bound']}-bound)  "
          f"params={rep['params']}")

    print("[5] compiled deployment (QIR -> fused integer stages -> kernels)")
    in_scale = 1.0 / 127.0
    compiled = compile_graph(Graph.load(out), in_scale=in_scale, device=dev)
    for line in compiled.schedule.describe().splitlines():
        print(f"    {line}")
    rng = np.random.default_rng(0)
    mk = lambda i: rng.integers(-127, 128, (64,)).astype(np.int32)  # noqa
    cost = model_bops(w, b, scan.chosen_bits)
    ss = single_stream(compiled.offline, mk, n_queries=32, model_cost=cost,
                       bits=scan.chosen_bits)
    off = offline_scenario(compiled.offline, mk, n_samples=256,
                           model_cost=cost, bits=scan.chosen_bits)
    xb = np.stack([mk(i) for i in range(64)])
    # compiled segment waves (the hot path) and the host queue loop: both
    # equal offline
    y_off = compiled.offline(xb)
    y_cmp, fifo = compiled.streaming_compiled(xb, micro_batch=8)
    y_str, _ = compiled.streaming_host(xb, micro_batch=8)
    same = bool(torch.equal(y_off, y_cmp)) and bool(torch.equal(y_off,
                                                                 y_str))
    if not same:
        raise RuntimeError("streamed outputs differ from offline")
    print(f"    SingleStream: p50={ss.p50_ms:.3f}ms p99={ss.p99_ms:.3f}ms "
          f"(roofline energy proxy {ss.energy_proxy_uJ:.4f}uJ)")
    print(f"    Offline:      {off.throughput_qps:.0f} inf/s (batch "
          f"{off.extras['batch']})")
    print(f"    Streaming:    fifo_depths={fifo.fifo_depths} "
          f"segments={fifo.segments} (sized by core.dataflow, compiled "
          f"waves match offline)")
    return {"auc": auc, "chosen_bits": scan.chosen_bits, "width": w,
            "bottleneck": b, "single_stream": ss, "offline": off}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="where the exported QIR JSON goes")
    args = ap.parse_args(argv)
    run(args.device, args.out)


if __name__ == "__main__":
    main()

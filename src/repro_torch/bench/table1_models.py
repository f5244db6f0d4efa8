"""Paper Table 1 on the card: the submitted models' flow, precision,
parameter count and quality, trained with QAT and then deployed.

The port of ``benchmarks/table1_models.py``. KWS (490-256-256-256-12,
3-bit, 150 steps of batch 64, the paper's class-weighted cross-entropy)
and AD (128-72-72-8-72-72-128, 8-bit, 120 steps) are trained at full width
by ``core.codesign.train_tiny`` on the card and scored on the synthetic
stand-ins (accuracy, AUC), as the reference does. Then what was trained is
deployed: ``export_qmlp(..., freeze_scales=True)`` and ``compile_graph``
in both dispatch modes (auto: one ``mlp_megakernel`` launch a batch;
staged: one ``threshold_matmul`` launch a stage), and the deployed
accuracy / AUC is printed beside the QAT figure. They are not expected to
be equal: the deployed head is unquantised, the activations use frozen
po2 scales and the input is quantised to 8 bits (``input_scale``).

    python -m repro_torch.bench.table1_models [--device cuda]

IC and CNV report their parameter counts only, as in the reference (their
QAT runs on the CPU tests: the reference's 1-bit conv weights are NaN, so
CNV does not train).
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench.common import banner, print_rows, row
from repro_torch.core.codesign import train_tiny
from repro_torch.core.qir import Graph, LayerBits, export_qmlp, resolve_device
from repro_torch.core.quantizers import quantize_po2
from repro_torch.data.synthetic import SyntheticMelWindows, SyntheticMFCC
from repro_torch.deploy import compile_graph
from repro_torch.models.tiny import ADAutoencoder, CNVModel, ICModel, KWSMLP
from repro_torch.obs import timer

#: the two dispatch modes a trained model is deployed in: (label,
#: ``compile_graph``'s ``megakernel=``)
MODES = (("auto", None), ("staged", False))


def auc(scores, labels) -> float:
    """Rank AUC of ``scores`` for the positive ``labels`` (the reference's
    ``_auc``)."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=float)
    ranks[order] = np.arange(len(scores))
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return (ranks[pos].sum() - n_pos * (n_pos - 1) / 2) / max(n_pos * n_neg,
                                                               1)


def input_scale(x: np.ndarray) -> float:
    """The 8-bit input grid of a deployment: the po2 step that puts the
    largest |x| of ``x`` at code 127 or below."""
    return float(quantize_po2(torch.tensor(float(np.abs(x).max()) / 127.0)))


def quantize_input(x: np.ndarray, in_scale: float) -> np.ndarray:
    return np.clip(np.round(x / in_scale), -127, 127).astype(np.int32)


class StepClock:
    """``batch_fn`` wrapper that stamps the host clock, after a
    synchronise, at the start of every step: the differences are the train
    steps' times (the last one is closed by ``stop``)."""

    def __init__(self, batch_fn: Callable, device: torch.device):
        self.batch_fn, self.device, self.stamps = batch_fn, device, []

    def _stamp(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stamps.append(timer.now())

    def __call__(self, t):
        self._stamp()
        return self.batch_fn(t)

    def stop(self) -> List[float]:
        self._stamp()
        return [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]


def _train(model, loss_fn, batches, steps, lr, device, seed):
    net = model.init(torch.Generator().manual_seed(seed)).to(device)
    clock = StepClock(lambda t: batches[t], device)
    net, losses = train_tiny(loss_fn, net, clock, steps=steps, lr=lr)
    step_ms = clock.stop()
    return net, losses, step_ms


def kws_problem(steps: int, device, model: KWSMLP):
    """(loss_fn, the ``steps`` batches on ``device``, the data) of the KWS
    MLP's QAT: batches of 64 from ``SyntheticMFCC(seed=0)``,
    class-weighted CE."""
    dev = resolve_device(device)
    data = SyntheticMFCC(dim=model.in_dim, n_classes=model.n_classes,
                         seed=0)
    w = torch.tensor(1.0 / data.class_probs(), dtype=torch.float32)
    w = (w / torch.sum(w) * model.n_classes).to(dev)
    batches = []
    for s in range(steps):
        x, y = data.batch(s, 64)
        batches.append((torch.tensor(x, device=dev),
                        torch.tensor(y, dtype=torch.int64, device=dev)))

    def loss_fn(net, batch):
        x, y = batch
        logits = model.apply(net, x, train=False)
        lse = torch.logsumexp(logits, dim=-1)
        lab = logits.gather(1, y[:, None])[:, 0]
        return torch.mean((lse - lab) * w[y])

    return loss_fn, batches, data


def train_kws(steps: int = 150, device=None, seed: int = 0,
              model: Optional[KWSMLP] = None, lr: float = 2e-3) -> Dict:
    """Train the KWS MLP with QAT (the reference's ``_kws_quality``,
    ``kws_problem``). Returns the net, its losses, each step's host ms,
    and the QAT accuracy on 500 balanced samples."""
    dev = resolve_device(device)
    model = model or KWSMLP()
    loss_fn, batches, data = kws_problem(steps, dev, model)
    net, losses, step_ms = _train(model, loss_fn, batches, steps, lr, dev,
                                  seed)
    x, y = data.batch(77_777, 500, balanced=True)
    with torch.no_grad():
        logits = model.apply(net, torch.tensor(x, device=dev), train=False)
    acc = float((torch.argmax(logits, -1).cpu().numpy() == y).mean())
    return {"model": model, "net": net, "losses": losses,
            "step_ms": step_ms, "quality": acc, "eval": (x, y),
            "calibration": data.batch(0, 64)[0]}


def ad_problem(steps: int, device, model: ADAutoencoder,
               data: SyntheticMelWindows):
    """(loss_fn, the ``steps`` batches on ``device``) of the AD
    autoencoder's QAT: batches of 64 normals from ``data``, MSE."""
    dev = resolve_device(device)
    batches = [torch.tensor(data.batch(s, 64)[0], device=dev)
               for s in range(steps)]

    def loss_fn(net, x):
        return torch.mean(torch.square(model.apply(net, x, train=False) - x))

    return loss_fn, batches


def train_ad(steps: int = 120, device=None, seed: int = 0,
             model: Optional[ADAutoencoder] = None, lr: float = 2e-3,
             data: Optional[SyntheticMelWindows] = None,
             n_eval: int = 400) -> Dict:
    """Train the AD autoencoder with QAT (the reference's
    ``_ad_quality``): batches of 64 normals from
    ``SyntheticMelWindows(seed=0)``, MSE. Returns the net, its losses,
    each step's host ms and the QAT AUC on 400 windows, a quarter of them
    anomalous."""
    dev = resolve_device(device)
    model = model or ADAutoencoder()
    data = data or SyntheticMelWindows(dim=model.in_dim, seed=0)
    loss_fn, batches = ad_problem(steps, dev, model, data)
    net, losses, step_ms = _train(model, loss_fn, batches, steps, lr, dev,
                                  seed)
    x, y = data.batch(10_000, n_eval, anomaly_frac=0.25)
    with torch.no_grad():
        score = model.anomaly_score(net, torch.tensor(x, device=dev))
    return {"model": model, "net": net, "losses": losses,
            "step_ms": step_ms, "quality": auc(score.cpu().numpy(), y),
            "eval": (x, y), "calibration": data.batch(0, 64)[0]}


def export_trained(run: Dict, name: str) -> Tuple[Graph, float]:
    """The trained net as a QIR graph with frozen po2 activation scales,
    chained from the 8-bit input scale of its calibration batch; returns
    (graph, input scale)."""
    net, model = run["net"], run["model"]
    in_scale = input_scale(run["calibration"])
    layers = [LayerBits(l.weight_bits, l.act_bits) for l in net.hidden]
    g = export_qmlp(layers, [l.to_numpy() for l in net.hidden],
                    net.head.to_numpy(), freeze_scales=True,
                    in_scale=in_scale, meta={"model": name})
    return g, in_scale


def deployed_quality(kind: str, cm, x: np.ndarray, y: np.ndarray,
                     in_scale: float) -> float:
    """Accuracy (KWS) or AUC (AD) of a compiled deployment on the same
    evaluation samples as the QAT figure: the inputs quantised to the
    8-bit grid, the integer stages, the float head."""
    out = cm.offline(quantize_input(x, in_scale)).cpu().numpy()
    if kind == "kws":
        return float((np.argmax(out, -1) == y).mean())
    return auc(np.mean(np.square(out - x), axis=-1), y)


def deploy(run: Dict, name: str, device=None) -> Dict:
    """Export the trained net and compile it in both dispatch modes;
    returns the graph, its input scale and {mode: (compiled model,
    deployed quality)}."""
    dev = resolve_device(device)
    g, in_scale = export_trained(run, name)
    x, y = run["eval"]
    out = {"graph": g, "in_scale": in_scale, "modes": {}}
    for mode, mk in MODES:
        cm = compile_graph(g, in_scale=in_scale, device=dev, megakernel=mk)
        out["modes"][mode] = (cm, deployed_quality(name, cm, x, y,
                                                   in_scale))
    return out


def float_ref_codes(g: Graph, x_int: np.ndarray,
                    in_scale: float) -> List[np.ndarray]:
    """Every integer stage's codes by the streamlined float reference
    (``core.streamline.float_ref_dense``: fold, quantise the weights,
    ReLU, half-up quant at the frozen scale), chained on the host from the
    graph's initializers: the exactness oracle of an MLP export
    (``tests/test_golden.py``)."""
    from repro_torch.core.streamline import float_ref_dense

    init = g.initializers
    denses = [n for n in g.nodes if n.op == "Dense" and n.name != "head"]
    quants = [n for n in g.nodes if n.op == "Quant"]
    h = torch.as_tensor(x_int, dtype=torch.float32) * in_scale
    out = []
    for i, (dn, qn) in enumerate(zip(denses, quants)):
        keys = ["w", "b"] + (["gamma", "beta", "mu", "sigma2"]
                             if f"gamma{i}" in init else [])
        params = {k: torch.as_tensor(np.asarray(init[f"{k}{i}"]))
                  for k in keys}
        s_out = float(qn.attrs["scale"])
        codes = float_ref_dense(params, h, weight_bits=dn.attrs["weight_bits"],
                                act_bits=qn.quant.bits, s_out=s_out)
        out.append(codes.numpy())
        h = codes.to(torch.float32) * s_out
    return out


def graph_codes(g: Graph, x_int: np.ndarray, in_scale: float,
                device=None) -> List[np.ndarray]:
    """Every activation Quant node's codes under ``Graph.run`` (the
    unfused interpreter, whose Dense nodes keep the float weights) with
    the graph's frozen scales."""
    quant = [n for n in g.nodes if n.op == "Quant"]
    g2 = Graph(nodes=g.nodes, initializers=g.initializers, inputs=g.inputs,
               outputs=[n.outputs[0] for n in quant], meta=g.meta)
    out = g2.run({"x": x_int.astype(np.float32) * np.float32(in_scale)},
                 device=device)
    return [np.round(out[n.outputs[0]] / n.attrs["scale"]).astype(np.int32)
            for n in quant]


def run(device=None, kws_steps: int = 150, ad_steps: int = 120):
    banner("Table 1: submitted models (params / precision / quality), "
           "trained and deployed")
    paper = {
        "IC-hls4ml": dict(prec="8-12", params=58_115, quality="83.5% acc"),
        "IC-FINN-CNV": dict(prec="1", params=1_542_848, quality="84.5% acc"),
        "AD-hls4ml": dict(prec="6-12", params=22_285, quality="0.83 AUC"),
        "KWS-FINN": dict(prec="3", params=259_584, quality="82.5% acc"),
    }
    ad, kws = train_ad(ad_steps, device), train_kws(kws_steps, device)
    deployed = {"ad": deploy(ad, "ad", device), "kws": deploy(kws, "kws",
                                                               device)}
    ours = {
        "IC-hls4ml": dict(params=sum(l.n_params for l in
                                     ICModel().cost().layers),
                          quality="n/a (synthetic)"),
        "IC-FINN-CNV": dict(params=CNVModel().n_weights(),
                            quality="n/a (synthetic)"),
        "AD-hls4ml": dict(params=ADAutoencoder().n_params(),
                          quality=f"{ad['quality']:.3f} AUC*", run=ad,
                          dep=deployed["ad"]),
        "KWS-FINN": dict(params=KWSMLP().n_weights(),
                         quality=f"{kws['quality']:.1%} acc*", run=kws,
                         dep=deployed["kws"]),
    }
    rows = []
    for name, p in paper.items():
        o = ours[name]
        extra = {}
        if "run" in o:
            r, d = o["run"], o["dep"]
            extra = dict(
                train_step_ms_median=f"{statistics.median(r['step_ms']):.3f}",
                loss_first_last=f"{r['losses'][0]:.4f}->"
                                f"{r['losses'][-1]:.4f}",
                deployed_auto=f"{d['modes']['auto'][1]:.4f}",
                deployed_staged=f"{d['modes']['staged'][1]:.4f}",
                in_scale=d["in_scale"])
        rows.append(row(
            f"table1/{name}",
            paper_params=p["params"], our_params=o["params"],
            match=("EXACT" if p["params"] == o["params"]
                   else f"{o['params'] / p['params']:.2f}x"),
            precision_bits=p["prec"], paper_quality=p["quality"],
            our_quality_synthetic=o["quality"], **extra))
    print_rows(rows)
    print("* quality on synthetic stand-in data (real datasets unavailable "
          "offline) - relative signal only; deployed_*: the same samples "
          "through the compiled integer deployment", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--kws-steps", type=int, default=150)
    ap.add_argument("--ad-steps", type=int, default=120)
    args = ap.parse_args(argv)
    run(args.device, args.kws_steps, args.ad_steps)


if __name__ == "__main__":
    main()

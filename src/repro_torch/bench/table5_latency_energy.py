"""Paper Table 5 on the card: latency and energy per inference of each
submitted model.

The port of ``benchmarks/table5_latency_energy.py``. The FPGA wall-clock /
Joulescope columns become ``core.codesign.deploy_report``'s roofline
model with the card's constants (NVIDIA H100 80GB HBM3 at 700 W: latency
= max(compute, memory) term, energy = power x latency), beside the
paper's Pynq-Z2 numbers and the measured time of each model's batch-1 QAT
forward (``apply(net, x, train=False)``): on the card its device time by
CUDA-graph replay (``bench.common.time_ms``), on the CPU the host clock.

    python -m repro_torch.bench.table5_latency_energy [--device cuda]
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List

import torch

from repro_torch.bench.common import banner, print_rows, row, time_ms
from repro_torch.core.codesign import deploy_report
from repro_torch.core.qir import resolve_device
from repro_torch.models.tiny import ADAutoencoder, CNVModel, ICModel, KWSMLP
from repro_torch.obs import timer

#: name -> (model, batch-1 input shape, deploy bits, the paper's row)
MODELS = {
    "IC-hls4ml": (ICModel(), (1, 32, 32, 3), 8,
                  "27.3 ms / 44330 uJ (paper Pynq-Z2)"),
    "IC-FINN-CNV": (CNVModel(), (1, 32, 32, 3), 1,
                    "1.5 ms / 2535 uJ (paper)"),
    "AD-hls4ml": (ADAutoencoder(), (1, 128), 8, "19 us / 30.1 uJ (paper)"),
    "KWS-FINN": (KWSMLP(), (1, 490), 3, "17 us / 30.9 uJ (paper)"),
}


def forward_ms(model, shape, device, seed: int = 0) -> float:
    """ms of one QAT forward (eval mode) of ``model`` on ones of
    ``shape`` on ``device``: device time by graph replay on the card, the median of 21
    synchronised host-clock calls on the CPU."""
    net = model.init(torch.Generator().manual_seed(seed)).to(device)
    x = torch.ones(shape, device=device)

    def fwd():
        with torch.no_grad():
            return model.apply(net, x, train=False)

    if device.type == "cuda":
        return time_ms(fwd)
    fwd()
    samples = []
    for _ in range(21):
        t0 = timer.now()
        fwd()
        samples.append((timer.now() - t0) * 1e3)
    return statistics.median(samples)


def run(device=None) -> List[Dict]:
    dev = resolve_device(device)
    banner("Table 5: latency + energy per inference (H100 roofline model)")
    rows = []
    for name, (model, shape, bits, paper) in MODELS.items():
        ms = forward_ms(model, shape, dev)
        rep = deploy_report(model.cost(), batch=1, bits=bits)
        rows.append(row(
            f"table5/{name}", ms * 1e3,
            device=str(dev) if dev.type == "cpu"
            else torch.cuda.get_device_name(dev),
            qat_forward_batch1_ms=f"{ms:.6f}",
            h100_roofline_latency_us=f"{rep['latency_us']:.6f}",
            h100_energy_uJ=f"{rep['energy_uJ']:.6f}",
            bound=rep["bound"], bops=f"{rep['bops']:.3e}",
            wm_kbits=f"{rep['wm_bits'] / 1e3:.0f}", paper_row=paper))
    print_rows(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()

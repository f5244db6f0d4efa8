"""The deployment report of the codesign flow: roofline latency and energy
per inference on one card.

The port of the deploy part of ``repro.core.codesign`` (``deploy_report``);
``train_tiny`` and ``bitwidth_descent`` come with the QAT slice
(``core/qlayers.py`` and the training half of ``core/codesign.py``). The reference prices a TPU v5e; the port prices the card
it runs on, one NVIDIA H100 80GB HBM3 at its 700.00 W power limit (NVIDIA's
H100 SXM data sheet, dense rates without sparsity). The scenario runtime
(``deploy.scenarios``) multiplies measured latencies by ``CHIP_WATTS``;
``chip_smoke.py`` checks the card's power limit against it.
"""

from __future__ import annotations

from typing import Dict

#: int8 tensor-core operations per second, dense (NVIDIA H100 80GB HBM3,
#: 700.00 W)
PEAK_INT8_OPS = 1979e12
#: bf16 tensor-core FLOP per second, dense (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_BF16_FLOPS = 989e12
#: device-memory bytes per second (NVIDIA H100 80GB HBM3, 700.00 W)
HBM_BW = 3.35e12
#: the card's power limit, the energy model's power (NVIDIA H100 80GB HBM3)
CHIP_WATTS = 700.0


def deploy_report(model_cost, batch: int = 1, bits: int = 8
                  ) -> Dict[str, float]:
    """Roofline latency and energy per inference of a tiny model on one
    card: latency = max(compute term, memory term), energy = power x
    latency. The reference's arithmetic with the card's constants."""
    peak = PEAK_INT8_OPS if bits <= 8 else PEAK_BF16_FLOPS
    compute_s = model_cost.flops * batch / peak
    bytes_moved = model_cost.wm_bits / 8 + model_cost.flops * batch / 4
    memory_s = bytes_moved / HBM_BW
    latency = max(compute_s, memory_s, 1e-9)
    return {
        "latency_us": latency * 1e6,
        "energy_uJ": latency * CHIP_WATTS * 1e6,
        "bound": "memory" if memory_s > compute_s else "compute",
        "bops": model_cost.bops,
        "wm_bits": model_cost.wm_bits,
        "params": model_cost.n_params,
    }

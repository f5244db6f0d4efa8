"""The codesign driver on torch: QAT training, bit-width descent and the
deployment report.

The port of ``repro.core.codesign`` (the paper's §5 methodology):

  * ``train_tiny`` — Adam on a tiny model's parameters, written as the
    reference writes it (bias-corrected ``mh / (sqrt(vh) + eps)``, each
    op in float32), not ``torch.optim.Adam``, whose rounding differs;
    every parameter is trained, the BN statistics ``mu`` / ``sigma2``
    included, as the reference differentiates every leaf;
  * ``bitwidth_descent`` — lower the precision until quality drops
    (Fig. 4's procedure);
  * ``deploy_report`` — roofline latency and energy per inference.

The reference prices a TPU v5e; the port prices the card it runs on, one
NVIDIA H100 80GB HBM3 at its 700.00 W power limit (NVIDIA's H100 SXM data
sheet, dense rates without sparsity). The scenario runtime
(``deploy.scenarios``) multiplies measured latencies by ``CHIP_WATTS``;
``chip_smoke.py`` checks the card's power limit against it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.qir import full_fp32

# ---------------------------------------------------------------------------
# Adam for tiny models
# ---------------------------------------------------------------------------

def _tensors(params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)


def train_tiny(
    loss_fn: Callable,            # (params, batch) -> scalar tensor
    params,
    batch_fn: Callable[[int], Any],
    steps: int = 200,
    lr: float = 1e-3,
    seed: int = 0,
) -> Tuple[Any, List[float]]:
    """Adam on every parameter of ``params`` (an ``nn.Module`` or a list of
    tensors), updated in place; returns (params, losses).

    The update is the reference's: m = b1 m + (1 - b1) g, v = b2 v +
    (1 - b2) g^2, p -= lr * mh / (sqrt(vh) + eps) with mh, vh corrected
    by 1 - b^(t+1) in float32. A parameter the loss does not reach gets a
    zero gradient. The losses stay on the device and are read once at the
    end (one synchronisation, not one a step). The steps run in full
    float32 (``full_fp32``: no TF32 on the card)."""
    del seed                      # the reference's step takes no key either
    ps = _tensors(params)
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    with full_fp32():
        for t in range(steps):
            loss = loss_fn(params, batch_fn(t))
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
            tf = torch.tensor(t + 1, dtype=torch.float32)
            c1 = float(1 - b1 ** tf)
            c2 = float(1 - b2 ** tf)
            with torch.no_grad():
                for p, m_, v_, g in zip(ps, m, v, grads):
                    if g is None:
                        g = torch.zeros_like(p)
                    m_.copy_(b1 * m_ + (1 - b1) * g)
                    v_.copy_(b2 * v_ + (1 - b2) * g ** 2)
                    mh = m_ / c1
                    vh = v_ / c2
                    p.copy_(p - lr * mh / (torch.sqrt(vh) + eps))
            losses.append(loss.detach())
    return params, torch.stack(losses).tolist() if losses else []


# ---------------------------------------------------------------------------
# bit-width descent (Fig. 4 procedure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BitwidthScanResult:
    entries: List[Dict]           # bits, quality, bops
    chosen_bits: int


def bitwidth_descent(
    eval_at_bits: Callable[[int], Tuple[float, float]],  # bits -> (q, bops)
    bit_ladder: Sequence[int] = (32, 8, 6, 4, 3, 2, 1),
    tolerance: float = 0.02,
) -> BitwidthScanResult:
    """Lower precision until quality drops more than ``tolerance`` below
    the first (float) rung; choose the smallest width that retains it
    (paper §5)."""
    entries = []
    baseline = None
    chosen = bit_ladder[0]
    for bits in bit_ladder:
        q, bops = eval_at_bits(bits)
        entries.append({"bits": bits, "quality": q, "bops": bops})
        if baseline is None:
            baseline = q
        if q >= baseline - tolerance:
            chosen = bits
    return BitwidthScanResult(entries=entries, chosen_bits=chosen)


# ---------------------------------------------------------------------------
# deployment report (the per-model rows of paper Tables 1 / 5)
# ---------------------------------------------------------------------------

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

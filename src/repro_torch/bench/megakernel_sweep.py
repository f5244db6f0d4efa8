"""Cluster sizes and row tiles of ``mlp_megakernel`` (K3) on the card.

    python -m repro_torch.bench.megakernel_sweep     # PYTHONPATH=src

A K3 launch runs each row tile of ``block_m`` rows on a cluster of
``cluster`` CTAs, each holding its share of every stage's channels, so the
two trade one CTA's chain (its channels x its rows x the k steps) against
the clusters the card runs at once (``ops.MEGAKERNEL_ACTIVE_CLUSTERS``:
large clusters leave SMs idle). This sweep times K3 on seeded chains of
the main path's widths — KWS 490-256-256-256 (S 7), AD
128-72-72-8-72-72 (S 255), CNV's golden FC 32-32-32 and full-width FC
256-512-512 (S 1) — at 1, 16, 1024 and 4096 rows, for every cluster of 1
to 8 CTAs and every row tile of ``ops.MEGAKERNEL_ROW_TILES`` whose plan
fits, beside the default that ``ops.megakernel_plan`` picks (device time,
``common.time_ms``; weights packed once, as the executor does; each
configuration held equal to the plain version first). It prints one row
per (rows, chain) and exits non-zero without a card.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.bench.common import banner, print_rows, row, time_ms
from repro_torch.kernels import ops, ref

#: (label, widths, bank steps, code range): the chains the sweep times
CHAINS = [("kws", (490, 256, 256, 256), (7, 7, 7), (-127, 128)),
          ("ad", (128, 72, 72, 8, 72, 72), (255,) * 5, (-127, 128)),
          ("cnv_fc_golden", (32, 32, 32), (1, 1), (0, 2)),
          ("cnv_fc_full", (256, 512, 512), (1, 1), (0, 2))]
ROWS = (1, 16, 1024, 4096)


def chain(g, m, dims, steps, lo, hi, device):
    """Seeded codes, int8 weights and sorted step-major banks drawn from
    each stage's accumulators (so counts spread), on ``device``."""
    x = torch.randint(lo, hi, (m, dims[0]), generator=g, dtype=torch.int32)
    weights, banks, h = [], [], x
    for k, n, s in zip(dims[:-1], dims[1:], steps):
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        acc = ref.int_matmul(h, w).reshape(-1)
        idx = torch.randint(0, acc.numel(), (n * s,), generator=g)
        t = torch.sort(acc[idx].reshape(n, s), dim=1).values
        h = ref.threshold_matmul_ref(h, w, t)
        weights.append(w)
        banks.append(t.t().contiguous())
    return (x.to(device), [w.to(device) for w in weights],
            [b.to(device) for b in banks])


def sweep(device="cuda", seed: int = 0):
    """One row per (rows, chain): the device µs of every (cluster, row
    tile) that fits, and the default's."""
    g = torch.Generator().manual_seed(seed)
    rows = []
    for m in ROWS:
        for label, dims, steps, (lo, hi) in CHAINS:
            x, weights, banks = chain(g, m, dims, steps, lo, hi, device)
            packed = [ops.megakernel_pack_weights(w) for w in weights]
            want = ref.mlp_megakernel_ref(x, weights, banks)
            plan0 = ops.megakernel_plan(dims, steps, m)
            default = f"{plan0['cluster']}/{plan0['block_m']}"
            times = {}
            for c in range(ops.MEGAKERNEL_MAX_CLUSTER, 0, -1):
                for bm in ops.MEGAKERNEL_ROW_TILES:
                    plan = ops.megakernel_plan(dims, steps, m, c, bm)
                    if not plan["fits"]:
                        continue

                    def call(c=c, bm=bm):
                        return ops.mlp_megakernel(x, packed, banks,
                                                  cluster=c, block_m=bm)
                    if not torch.equal(call(), want):
                        raise RuntimeError(f"{label} M={m} cluster {c} x "
                                           f"{bm} rows: kernel != plain")
                    times[f"{c}/{bm}"] = time_ms(call) * 1e3
            best = min(times, key=times.get)
            rows.append(row(f"megakernel_sweep/{label}/M{m}", times[default],
                            default=default, fastest=best,
                            fastest_us=f"{times[best]:.3f}",
                            default_over_fastest=f"{times[default] / times[best]:.3f}",
                            candidates_us=";".join(f"{key}:{v:.3f}"
                                                   for key, v in
                                                   times.items())))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("megakernel_sweep: no CUDA device; it times the kernel on the "
              "card", file=sys.stderr)
        return 2
    banner("K3 clusters and row tiles (cluster/block_m: us)")
    print_rows(sweep())
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

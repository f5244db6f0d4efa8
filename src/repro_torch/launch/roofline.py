"""Roofline analysis over the dry run's records, on the H100's constants.

The port of ``repro.launch.roofline``: the same rows, formulas and table.
For every (arch x shape x mesh) JSON that ``launch.dryrun`` writes it
derives the roofline terms per device, with the card's constants in place
of the TPU v5e's:

    compute term    = FLOPs per device / peak (bf16 989e12 FLOP/s; the
                      int8 tensor-core peak, 1979e12, for cells with
                      quant_bits <= 8)
    memory term     = max(bytes accessed / devices, the working set that
                      must stream once a step) / 3.35e12 B/s
    collective term = collective bytes per device / NVLink 4's 450e9 B/s
                      per direction

The dry run records the collective bytes of each cell's rank-local step
(``launch.dryrun``). A record without them (a strategy with no
rank-local form in the port, ``"not_ported"``) prints ``n/a`` in that
column, and the term is left out of ``dominant`` and of the overlapped
step time.

MODEL_FLOPS = 6 * N_active * D (train) / 2 * N_active * D (inference)
gives the useful fraction of the traced FLOPs (``useful_ratio``), which
catches remat and padding waste.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.bops import lm_model_flops
from repro_torch.core import codesign

#: bf16 tensor-core FLOP/s, dense (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_BF16 = codesign.PEAK_BF16_FLOPS
#: int8 tensor-core OP/s, dense (NVIDIA H100 80GB HBM3, 700.00 W): the
#: int8 serve path's K5 runs here
PEAK_INT8 = codesign.PEAK_INT8_OPS
#: device-memory B/s (NVIDIA H100 80GB HBM3, 700.00 W)
HBM_BW = codesign.HBM_BW
#: NVLink 4 B/s per direction, per card (NVIDIA H100 80GB HBM3, 700.00 W)
NVLINK_BW = 450e9

__all__ = ["PEAK_BF16", "PEAK_INT8", "HBM_BW", "NVLINK_BW", "RooflineRow",
           "compute_seconds", "memory_seconds", "load_artifacts", "analyze",
           "render_table", "summary_lines", "main"]


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    tag: str
    status: str
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: Optional[float] = 0.0   # None: no collective bytes known
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops_per_dev: float = 0.0
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    reason: str = ""

    @property
    def t_total_overlap(self) -> float:
        """Lower-bound step time if compute/memory/collectives fully overlap
        (the collective term left out where it is not known)."""
        return max(t for t in (self.t_compute, self.t_memory,
                               self.t_collective) if t is not None)


def compute_seconds(flops_per_device: float, quant_bits: int = 16) -> float:
    """The compute term: int8-quantized work runs at the int8 peak."""
    return flops_per_device / (PEAK_INT8 if quant_bits <= 8 else PEAK_BF16)


def memory_seconds(bytes_per_device: float) -> float:
    """The memory term."""
    return bytes_per_device / HBM_BW


def load_artifacts(dirname: str = "artifacts/dryrun") -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def analyze(rec: dict) -> RooflineRow:
    row = RooflineRow(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                      tag=rec.get("tag", "baseline"), status=rec["status"])
    if rec["status"] != "ok":
        row.reason = rec.get("reason", rec.get("error", ""))
        return row

    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    n_dev = rec["n_devices"]

    # --- compute term: int8-quantized cells run at the int8 peak ----------
    flops_dev = rec["hlo_flops_per_device"]
    row.hlo_flops_per_dev = flops_dev
    row.t_compute = compute_seconds(flops_dev, rec.get("quant_bits", 16))

    # --- memory term ---------------------------------------------------------
    # floor with the working set that must stream at least once per step:
    # params + opt state + caches + outputs
    xla_bytes = max(rec["xla_cost_analysis"].get("bytes_accessed", 0.0), 0.0)
    mem = rec.get("memory_analysis", {})
    working_set = (rec.get("state_local_bytes", 0)
                   + rec.get("cache_local_bytes", 0)
                   + mem.get("output_size_in_bytes", 0) / max(n_dev, 1))
    bytes_dev = max(xla_bytes / max(n_dev, 1), working_set)
    row.t_memory = memory_seconds(bytes_dev)

    # --- collective term (n/a without collective bytes) ----------------------
    coll_dev = rec.get("collective_bytes_per_device")
    row.t_collective = None if coll_dev is None else coll_dev / NVLINK_BW

    terms = {"compute": row.t_compute, "memory": row.t_memory,
             "collective": row.t_collective}
    terms = {k: v for k, v in terms.items() if v is not None}
    row.dominant = max(terms, key=terms.get)

    # --- useful-FLOPs ratio ---------------------------------------------
    if shape.kind == "train":
        n_tokens = shape.global_batch * shape.seq_len
        row.model_flops = lm_model_flops(cfg.n_active_params(), n_tokens, True)
    elif shape.kind == "prefill":
        n_tokens = shape.global_batch * shape.seq_len
        row.model_flops = lm_model_flops(cfg.n_active_params(), n_tokens, False)
    else:  # decode: one new token per sequence
        row.model_flops = lm_model_flops(cfg.n_active_params(),
                                         shape.global_batch, False)
    total_hlo = flops_dev * n_dev
    row.useful_ratio = row.model_flops / total_hlo if total_hlo else 0.0

    # roofline fraction: useful model FLOPs per second at the overlapped step
    # time, against the bf16 peak of all the devices
    t = row.t_total_overlap
    if t > 0:
        achieved = row.model_flops / t
        row.roofline_fraction = achieved / (n_dev * PEAK_BF16)
    return row


def _seconds(t: Optional[float]) -> str:
    return f"{'n/a':>10s}" if t is None else f"{t:>10.4f}"


def render_table(rows: List[RooflineRow], mesh: str = "single",
                 tag: Optional[str] = "baseline") -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'collect_s':>10s} {'bound':>10s} {'useful':>7s} {'roofline':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.mesh != mesh or (tag and r.tag != tag):
            continue
        if r.status == "skipped":
            lines.append(f"{r.arch:22s} {r.shape:12s} "
                         f"{'— skipped: ' + r.reason:s}")
            continue
        if r.status != "ok":
            lines.append(f"{r.arch:22s} {r.shape:12s} ERROR {r.reason[:60]}")
            continue
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.t_compute:>10.4f} "
            f"{r.t_memory:>10.4f} {_seconds(r.t_collective)} "
            f"{r.dominant:>10s} {r.useful_ratio:>7.2f} "
            f"{r.roofline_fraction:>8.1%}")
    return "\n".join(lines)


def summary_lines(rows: List[RooflineRow], mesh: str = "single",
                  tag: Optional[str] = "baseline") -> List[str]:
    """The worst roofline fraction and the most collective-bound cell
    among the ok rows of ``mesh`` and ``tag``."""
    ok = [r for r in rows if r.status == "ok" and r.mesh == mesh
          and (not tag or r.tag == tag)]
    if not ok:
        return []
    worst = min(ok, key=lambda r: r.roofline_fraction)
    out = ["", f"worst roofline fraction : {worst.arch} x {worst.shape} "
               f"({worst.roofline_fraction:.1%}, {worst.dominant}-bound)"]
    known = [r for r in ok if r.t_collective is not None]
    if known:
        coll = max(known, key=lambda r: r.t_collective /
                   max(r.t_total_overlap, 1e-12))
        out.append(f"most collective-bound   : {coll.arch} x {coll.shape} "
                   f"(collective {coll.t_collective:.4f}s of "
                   f"{coll.t_total_overlap:.4f}s)")
    else:
        out.append("most collective-bound   : n/a (the records hold no "
                   "collective bytes)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    rows = [analyze(rec) for rec in load_artifacts(args.dir)]
    print(render_table(rows, mesh=args.mesh, tag=args.tag))

    for line in summary_lines(rows, args.mesh, args.tag):
        print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.__dict__ for r in rows], f, indent=1)


if __name__ == "__main__":
    main()

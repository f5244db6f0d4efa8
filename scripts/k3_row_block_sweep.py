#!/usr/bin/env python3
"""Sweep the megakernel's row block and block size on one CUDA card.

    python3 scripts/k3_row_block_sweep.py

Builds ``src/repro_torch/kernels/csrc/mlp_megakernel.cu`` once per
(BM, THREADS) variant into ``build/k3_sweep/`` (the source's two
constants rewritten), checks each variant exactly against the plain
version, and times it (``chip_smoke.time_ms``: CUDA-graph replay, device
time) on seeded chains at the main path's widths — KWS 490-256-256-256
(S = 7), AD 128-72-72-8-72-72 (S = 255), CNV's golden FC 32-32-32 and
full-width FC 256-512-512 (S = 1) — at 16, 1024 and 4096 rows, in the
order A, B, ..., B, A. Prints one line per (rows, chain) and writes
``chiprun_out/k3_row_block_sweep.json``. The variant the package ships is
``core.bops.MEGAKERNEL_BLOCK_M`` rows by ``THREADS`` in the source.
"""

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = [(16, 256), (8, 256), (8, 128), (4, 128), (32, 256)]
CHAINS = {"kws": ([490, 256, 256, 256], [7, 7, 7], -127, 128),
          "ad": ([128, 72, 72, 8, 72, 72], [255] * 5, -127, 128),
          "cnv-fc-golden": ([32, 32, 32], [1, 1], 0, 2),
          "cnv-fc-full": ([256, 512, 512], [1, 1], 0, 2)}


def build(variants):
    from repro_torch.kernels import _build

    src = (_build.CSRC / "mlp_megakernel.cu").read_text()
    out_dir = os.path.join(ROOT, "build", "k3_sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for bm, th in variants:
        text = re.sub(r"constexpr int BM = \d+;", f"constexpr int BM = {bm};",
                      src)
        text = re.sub(r"constexpr int THREADS = \d+;",
                      f"constexpr int THREADS = {th};", text)
        cu = os.path.join(out_dir, f"k3_{bm}_{th}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[(bm, th)] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", cu[:-3] + ".so",
             cu])
    fns = {}
    for key, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {key}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"k3_{key[0]}_{key[1]}.so")
                         ).mlp_megakernel_launch
        fn.argtypes, fn.restype = _build.ENTRY_POINTS["mlp_megakernel"][1], \
            ctypes.c_int
        fns[key] = fn
    return fns


def launch(fn, x, weights, banks_sn):
    """The marshalling of ``ops.mlp_megakernel``, for a variant's library."""
    import torch

    n = len(weights)
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.int32,
                      device=x.device)
    w_p = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    t_p = (ctypes.c_void_p * n)(*[b.data_ptr() for b in banks_sn])
    c_d = (ctypes.c_int * (n + 1))(*dims)
    c_s = (ctypes.c_int * n)(*[b.shape[0] for b in banks_sn])
    err = fn(x.data_ptr(), out.data_ptr(), ctypes.addressof(w_p),
             ctypes.addressof(t_p), ctypes.addressof(c_d),
             ctypes.addressof(c_s), n, x.shape[0],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_row_block_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import ref

    fns = build(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    rows = []
    for m in (16, 1024, 4096):
        for name, (dims, steps, lo, hi) in CHAINS.items():
            x, ws, bs = chip_smoke._random_chain(g, m, dims, steps, lo, hi)
            bsn = [b.t().contiguous() for b in bs]
            want = ref.mlp_megakernel_ref(x, ws, bsn)
            x, ws = x.cuda(), [w.cuda() for w in ws]
            bsn = [b.cuda() for b in bsn]
            times = {key: [] for key in VARIANTS}
            for key in VARIANTS + VARIANTS[::-1]:
                fn = fns[key]
                if not torch.equal(launch(fn, x, ws, bsn).cpu(), want):
                    raise RuntimeError(f"variant {key} differs on {name}")
                times[key].append(chip_smoke.time_ms(
                    lambda: launch(fn, x, ws, bsn)))
            row = {"rows": m, "chain": name,
                   "us": {f"BM{k[0]}/T{k[1]}": 1e3 * statistics.mean(v)
                          for k, v in times.items()}}
            rows.append(row)
            print(m, name, " ".join(f"{k}={v:.1f}us"
                                    for k, v in row["us"].items()),
                  flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k3_row_block_sweep.json"),
              "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

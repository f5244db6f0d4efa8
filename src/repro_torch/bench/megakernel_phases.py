"""Where one ``mlp_megakernel`` (K3) CTA spends its cycles, on the card.

    python -m repro_torch.bench.megakernel_phases     # PYTHONPATH=src

Builds a copy of ``csrc/mlp_megakernel.cu`` into ``build/k3_phases/``
with ``clock64()`` stamps at the phase boundaries of the first CTA of the
first cluster (the copy only; the package's kernel has none), launches it
through the package's own plan and arguments on seeded chains of the main
path's widths (``bench.megakernel_sweep.CHAINS``) at 1 and 1024 rows, and
prints, per chain, the cycles of: issuing the row tile's input copies, the
slices' copies, zeroing, the prologue's cluster barrier, then per stage
the products, the epilogue, and the cluster barrier with the next stage's
bank-order check inside it. Each launch's codes are held equal to the
plain version. The fifth of five launches is reported (warm caches). It
exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from repro_torch.bench.megakernel_sweep import CHAINS, chain
from repro_torch.kernels import _build, ops, ref

OUT = _build.BUILD_DIR.parent / "k3_phases"
SLOTS = 64


def _mark(i: str) -> str:
    return (f"if (threadIdx.x == 0 && blockIdx.x == 0) "
            f"mk_phase[{i}] = clock64();")


def instrumented_source() -> str:
    """The kernel source with the stamps inserted; raises if a phase
    boundary it looks for has moved."""
    src = (_build.CSRC / "mlp_megakernel.cu").read_text()
    edits = [
        ("namespace {\n\nusing namespace thr_epi;",
         f"__device__ long long mk_phase[{SLOTS}];\n"
         "namespace {\n\nusing namespace thr_epi;"),
        ("  int32_t* acc_s = smem + c.acc_off;\n",
         "  int32_t* acc_s = smem + c.acc_off;\n  " + _mark("0") + "\n"),
        ("  for (int d = 0; d < D; ++d) {\n    const Stage s = c.st[d];\n"
         "    const int T = (s.n + 7) / 8;\n"
         "    const int t_lo = rank * T / C, nt = (rank + 1) * T / C - t_lo;"
         "\n    if (s.w_off >= 0)",
         "  " + _mark("60") + "\n  for (int d = 0; d < D; ++d) {\n"
         "    const Stage s = c.st[d];\n    const int T = (s.n + 7) / 8;\n"
         "    const int t_lo = rank * T / C, nt = (rank + 1) * T / C - t_lo;"
         "\n    if (s.w_off >= 0)"),
        ("  for (int e = threadIdx.x; e < c.block_m * c.ldc; e += NT) "
         "acc_s[e] = 0;",
         "  " + _mark("61") + "\n  for (int e = threadIdx.x; "
         "e < c.block_m * c.ldc; e += NT) acc_s[e] = 0;"),
        ("  if (threadIdx.x == 0) *vote = 0;",
         "  if (threadIdx.x == 0) *vote = 0;\n  " + _mark("62")),
        ("  cluster.sync();\n\n  // ---- the stages",
         "  cluster.sync();\n  " + _mark("1") + "\n\n  // ---- the stages"),
        ("    __syncthreads();\n\n    // threshold epilogue",
         "    __syncthreads();\n    " + _mark("3 + 4 * d")
         + "\n\n    // threshold epilogue"),
        ("    if (!last) {\n      cluster_arrive();",
         "    " + _mark("4 + 4 * d") + "\n    if (!last) {\n"
         "      cluster_arrive();"),
        ("      cluster_wait();\n    }\n",
         "      cluster_wait();\n    }\n    " + _mark("5 + 4 * d") + "\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"phase boundary not found once: {old!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int mk_phase_read(long long* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, mk_phase, "
                  f"sizeof(long long) * {SLOTS});\n}}\n")


def build():
    """The instrumented library: (launch function, stamp reader)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    cu = OUT / "mlp_megakernel_phases.cu"
    cu.write_text(instrumented_source())
    lib = OUT / "mlp_megakernel_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True)
    dll = ctypes.CDLL(str(lib))
    launch = dll.mlp_megakernel_launch
    launch.argtypes = _build.ENTRY_POINTS["mlp_megakernel"][1]
    launch.restype = ctypes.c_int
    read = dll.mk_phase_read
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    return launch, read


def phases(launch, read, x, weights, banks):
    """(plan, {phase: cycles}) of the fifth launch on (x, weights, banks)."""
    packed = [ops.megakernel_pack_weights(w) for w in weights]
    dims, steps = ops._mk_chain(x, packed, banks)
    plan = ops.megakernel_plan(dims, steps, x.shape[0])
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.int32,
                      device=x.device)
    stamps = (ctypes.c_longlong * SLOTS)()
    for _ in range(5):
        _keep, args = ops._mk_args(x, out, packed, banks, plan, dims, steps)
        if launch(*args, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the instrumented launch failed")
        torch.cuda.synchronize()
    read(stamps)
    if not torch.equal(out, ref.mlp_megakernel_ref(x, weights, banks)):
        raise RuntimeError("the instrumented kernel differs from the plain "
                           "version")
    t = list(stamps)
    n = len(weights)
    out_ph = {"input copies": t[60] - t[0], "slice copies": t[61] - t[60],
              "zero": t[62] - t[61], "prologue barrier": t[1] - t[62]}
    for d in range(n):
        start = t[1] if d == 0 else t[1 + 4 * d]
        out_ph[f"s{d} products"] = t[3 + 4 * d] - start
        out_ph[f"s{d} epilogue"] = t[4 + 4 * d] - t[3 + 4 * d]
        if d < n - 1:
            out_ph[f"s{d} barrier"] = t[5 + 4 * d] - t[4 + 4 * d]
    out_ph["total"] = t[4 + 4 * (n - 1)] - t[0]
    return plan, out_ph


def main() -> int:
    if not torch.cuda.is_available():
        print("megakernel_phases: no CUDA device; it times the kernel on the "
              "card", file=sys.stderr)
        return 2
    launch, read = build()
    g = torch.Generator().manual_seed(0)
    for label, dims, steps, (lo, hi) in CHAINS:
        for m in (1, 1024):
            x, weights, banks = chain(g, m, dims, steps, lo, hi, "cuda")
            plan, ph = phases(launch, read, x, weights, banks)
            print(f"{label} M={m} ({plan['cluster']} CTAs x "
                  f"{plan['block_m']} rows): "
                  + ", ".join(f"{k} {v}" for k, v in ph.items())
                  + " cycles", flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

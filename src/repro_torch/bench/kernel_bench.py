"""Kernel-level benchmark of the port on the card: the fused dataflow stage
(K5 ``qmatmul``) against the unfused op chain, the standalone FINN
activation (K4 ``multi_threshold``), the two conv lowerings, and the
megakernel against staged dispatch.

    python -m repro_torch.bench.kernel_bench      # writes BENCH_torch_kernels.json

The counterpart of ``benchmarks/kernel_bench.py``, whose sections it keeps.
On a machine without a TPU the reference can time only its XLA chains and
reports the Pallas row as a traffic model; here every kernel runs and is
timed as device time (CUDA-graph replay, ``common.time_ms``):

  * **qmatmul** at M = K = N = 512, ReLU, ``out_scale`` 0.125: the unfused
    torch chain (``torch._int_mm`` and one launch per epilogue op, the
    int32 and float32 intermediates through device memory; also the
    library yardstick), the plain version (``kernels.ref.qmatmul_ref``) and
    K5, with the traffic model of each;
  * **multi_threshold** (a row the reference has no means to fill): K4 at
    AD's bank (1024 rows x 72 channels, S 255) and on the deep-bank path
    (S 511), beside its plain version and one ``torch.searchsorted``;
  * **conv lowerings**: K2 direct against im2col + K1 on one streamlined
    3x3 stage, with ``deploy.autotune.plan_block_h``'s table;
  * **megakernel against staged**: full-width KWS and AD
    (``bench.models``) through ``streaming_compiled`` at micro-batch 4 in
    both dispatch modes, host clock, best of 7.

Every kernel output is held against its plain version first (exact).
``kernel_cases``, ``check_cases`` and ``time_cases`` are separate so that
``chip_smoke.py`` can count the launches of the checking pass alone.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bench.common import (banner, emit_json, print_rows, row,
                                      time_ms)
from repro_torch.core.codesign import HBM_BW, PEAK_INT8_OPS
from repro_torch.kernels import ops, ref

SEED = 0

#: the reference's qmatmul section: shape, ReLU and requant scale
QMM_M = QMM_K = QMM_N = 512
QMM_OUT_SCALE = 0.125

#: K4 cases: (label, rows, channels, steps): AD's widest bank and the
#: deep-bank (slab) path of the TPU kernel
MT_CASES = (("ad_bank", 1024, 72, 255), ("deep_bank", 1024, 72, 511))

#: int32 operations per second of the H100's CUDA cores: 64 INT32 lanes
#: per SM x 132 SMs x 1.98 GHz boost (NVIDIA Hopper architecture white
#: paper); the rate K4's compares run at
CUDA_CORE_INT32_OPS = 64 * 132 * 1.98e9

#: the peak each case's operations are bounded by
PEAK_OPS = {"qmatmul": PEAK_INT8_OPS, "multi_threshold": CUDA_CORE_INT32_OPS}


def bound_ms(kernel: str, n_bytes: float, n_ops: float) -> float:
    """Least time for the work: bytes over the memory rate or operations
    over the kernel's peak, whichever is larger."""
    return max(n_bytes / HBM_BW, n_ops / PEAK_OPS[kernel]) * 1e3


def bound_by(kernel: str, n_bytes: float, n_ops: float) -> str:
    return ("bytes" if n_bytes / HBM_BW >= n_ops / PEAK_OPS[kernel]
            else "operations")


def _epilogue(acc, s, b, out_scale):
    """The kernel's epilogue as one launch per op: float32 cast, scale,
    bias, ReLU, the multiply by the float32 reciprocal, rounding, clip."""
    y = torch.clamp_min(acc.to(torch.float32) * s + b, 0.0)
    # the float32 reciprocal as a Python scalar: torch multiplies float32
    # tensors by it in float32 (and, unlike a tensor, it needs no copy to
    # the card, so the call can be captured in a CUDA graph)
    inv = float(np.float32(1.0 / out_scale))
    return torch.clamp(torch.round(y * inv), -128, 127).to(torch.int8)


def _unfused(x, w, s, b, out_scale):
    """The unfused chain: ``torch._int_mm`` (cuBLAS int8) where the card
    has it, the plain version's exact product elsewhere, then the
    epilogue op by op."""
    acc = (torch._int_mm(x, w) if x.device.type == "cuda"
           else ref.int_matmul(x, w))
    return _epilogue(acc, s, b, out_scale)


def qmatmul_cases(device, seed: int = SEED) -> List[Dict]:
    """K5 at the reference's section shape, on seeded int8 codes."""
    rng = np.random.default_rng(seed)
    m, k, n = QMM_M, QMM_K, QMM_N
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    x = t(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = t(rng.integers(-127, 128, (k, n)).astype(np.int8))
    s = t(rng.uniform(1e-3, 1e-2, n).astype(np.float32))
    b = t(rng.standard_normal(n).astype(np.float32))
    kw = dict(relu=True, out_scale=QMM_OUT_SCALE)
    io = m * k + k * n + 8 * n + m * n            # in/out tensors once
    inter = m * n * 4 * 2 * 2                     # int32 + f32, write+read
    return [{
        "kernel": "qmatmul", "label": "fused",
        "shape": f"M={m} K={k} N={n} relu out_scale={QMM_OUT_SCALE}",
        "run": lambda: ops.qmatmul(x, w, s, b, **kw),
        "plain": lambda: ref.qmatmul_ref(x, w, s, b, **kw),
        "library": lambda: _unfused(x, w, s, b, QMM_OUT_SCALE),
        "library_is": "torch._int_mm + epilogue ops (the unfused chain)",
        "bytes": io, "ops": 2 * m * n * k,
        "traffic": {"unfused_bytes_model": io + inter,
                    "fused_bytes_model": io,
                    "traffic_saving": f"{inter / (io + inter):.0%}"},
    }]


def multi_threshold_cases(device, seed: int = SEED) -> List[Dict]:
    """K4 on seeded accumulators and sorted banks drawn from their range,
    so the counts spread over [0, S]."""
    rng = np.random.default_rng(seed + 1)
    cases = []
    for label, m, c, steps in MT_CASES:
        acc_np = rng.integers(-30000, 30000, (m, c)).astype(np.int32)
        thr_np = np.sort(rng.integers(-32000, 32000, (c, steps)),
                         axis=1).astype(np.int32)
        acc = torch.as_tensor(acc_np, device=device)
        thr = torch.as_tensor(thr_np, device=device)
        acc_t = acc.t().contiguous()
        cases.append({
            "kernel": "multi_threshold", "label": label,
            "shape": f"M={m} C={c} S={steps}",
            "run": lambda acc=acc, thr=thr: ops.multi_threshold(acc, thr),
            "plain": lambda acc=acc, thr=thr: ref.multi_threshold_ref(acc,
                                                                      thr),
            # for sorted banks the count is the insertion point
            "library": lambda thr=thr, acc_t=acc_t: torch.searchsorted(
                thr, acc_t, right=True),
            "library_is": "torch.searchsorted (sorted banks)",
            "library_transposed": True,
            "bytes": 4 * (2 * m * c + c * steps), "ops": m * c * steps,
        })
    return cases


def kernel_cases(device="cuda", seed: int = SEED) -> List[Dict]:
    """The K5 and K4 cases of the bench, inputs on ``device``."""
    return qmatmul_cases(device, seed) + multi_threshold_cases(device, seed)


def check_cases(cases: List[Dict]) -> Dict[str, int]:
    """One call of each case's kernel (wrapper) against its plain version
    and its library call, exact; returns the worst |kernel - plain| per
    kernel. Raises on any difference."""
    worst: Dict[str, int] = {}
    for c in cases:
        got, want, lib = c["run"](), c["plain"](), c["library"]()
        if c.get("library_transposed"):
            lib = lib.t()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0), err)
        if err != 0 or not torch.equal(got, want):
            raise RuntimeError(f"{c['kernel']} {c['shape']}: kernel != "
                               f"plain version (max err {err})")
        if not torch.equal(lib.to(got.dtype), got):
            raise RuntimeError(f"{c['kernel']} {c['shape']}: "
                               f"{c['library_is']} != kernel")
    return worst


def time_cases(cases: List[Dict], reps: int = 7, inner: int = 20
               ) -> List[Dict]:
    """Kernel, plain-version and library device times of each case, with
    its bound; one row each."""
    rows = []
    for c in cases:
        k = c["kernel"]
        ms = time_ms(c["run"], reps=reps, inner=inner)
        rows.append(row(
            f"kernel/{k}_{c['label']}_cuda", ms * 1e3, kernel=k,
            shape=c["shape"], ms=ms,
            plain_ms=time_ms(c["plain"], reps=3, inner=3),
            library_ms=time_ms(c["library"], reps=reps, inner=inner),
            library_is=c["library_is"],
            bound_ms=bound_ms(k, c["bytes"], c["ops"]),
            bound_by=bound_by(k, c["bytes"], c["ops"]),
            bytes=c["bytes"], ops=c["ops"], **c.get("traffic", {})))
    return rows


def conv_lowering_rows(device="cuda", samples: int = 64,
                       seed: int = SEED) -> List[Dict]:
    """K2 direct against im2col + K1 on one streamlined 3x3 SAME stage
    (the reference's section: 32x32x16 -> 32 channels, 4-bit), the two
    held equal, timed, beside the lowering-aware traffic model and
    ``plan_block_h``'s table at ``samples`` samples."""
    from repro_torch.core.bops import stage_cost
    from repro_torch.core.streamline import make_threshold_stage
    from repro_torch.deploy.autotune import plan_block_h
    from repro_torch.deploy.lower import (ConvGeom, FusedConvThresholdStage,
                                          _float_mm_safe)

    banner("Kernel bench: fused direct conv (K2) vs materialised im2col (K1)")
    rng = np.random.default_rng(seed + 2)
    h = w = 32
    c, f, k, bits = 16, 32, 3, 4
    w_int = torch.as_tensor(rng.integers(-7, 8, (k * k * c, f)),
                            dtype=torch.int32)
    td = make_threshold_stage(w_int, torch.full((f,), 2.0 ** -4),
                              torch.zeros(f), in_scale=2.0 ** -5,
                              act_bits=bits, s_out=2.0 ** -3).to(device)
    geom = ConvGeom(kernel=k, stride=1, padding="SAME", in_h=h, in_w=w,
                    in_ch=c, out_h=h, out_w=w, out_ch=f)
    mm = _float_mm_safe(td.w_int.cpu(), bits)

    def stage(kind):
        return FusedConvThresholdStage(
            name=f"conv[{kind}]", stage=td, geom=geom, in_scale=2.0 ** -5,
            in_bits=bits, mm_float=mm, lowering=kind)

    direct, i2c = stage("direct"), stage("im2col")
    x = torch.as_tensor(rng.integers(0, 2 ** bits, (samples, h, w, c)),
                        dtype=torch.int32, device=device)
    if not torch.equal(direct.apply_kernel(x).reshape(-1),
                       i2c.apply_kernel(x).reshape(-1)):
        raise RuntimeError("direct and im2col conv lowerings differ")
    t_direct = time_ms(lambda: direct.apply_kernel(x))
    t_i2c = time_ms(lambda: i2c.apply_kernel(x))
    traffic_d = stage_cost(direct).traffic_bytes
    traffic_i = stage_cost(i2c).traffic_bytes
    plan = plan_block_h(geom, samples=samples)
    return [
        row("kernel/conv_threshold_direct", t_direct * 1e3,
            samples=samples, hbm_bytes_model=int(traffic_d)),
        row("kernel/conv_threshold_im2col", t_i2c * 1e3, samples=samples,
            hbm_bytes_model=int(traffic_i),
            im2col_bytes=int(traffic_i - traffic_d),
            direct_speedup=f"{t_i2c / max(t_direct, 1e-9):.2f}x"),
        row("kernel/conv_threshold_block_h", 0.0,
            tuned_block_h=plan["block_h"],
            slot_passes=plan["slot_passes"],
            banded_input_bytes=int(plan["input_bytes"]),
            candidates=";".join(
                f"{r['block_h']}:{r['slot_passes']}:{int(r['input_bytes'])}"
                for r in plan["candidates"])),
    ]


def megakernel_rows(device="cuda", batch: int = 1024, micro_batch: int = 4,
                    iters: int = 7) -> List[Dict]:
    """Staged dispatch against one megakernel launch per segment wave on
    full-width KWS and AD: the same pool through ``streaming_compiled`` in
    both modes (outputs held equal), host clock, best of ``iters``, beside
    the residency traffic model's saving."""
    from repro_torch.bench.models import AD_BITS, AD_DIMS, KWS_BITS, KWS_DIMS
    from repro_torch.bench.models import mlp_graph
    from repro_torch.core.bops import (megakernel_traffic_bytes,
                                       staged_traffic_bytes)
    from repro_torch.deploy import compile_graph
    from repro_torch.obs import timer

    banner("Kernel bench: megakernel vs staged segment dispatch (KWS/AD)")

    def best(run, x):
        run(x, micro_batch=micro_batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            t0 = timer.now()
            run(x, micro_batch=micro_batch)
            torch.cuda.synchronize()
            times.append(timer.now() - t0)
        return min(times)

    rng = np.random.default_rng(2022)
    rows = []
    for name, dims, bits, seed in (("kws", KWS_DIMS, KWS_BITS, 2023),
                                   ("ad", AD_DIMS, AD_BITS, 2024)):
        graph = mlp_graph(dims, bits, seed, name=name)
        cm = compile_graph(graph, in_scale=1.0 / 127.0, device=device,
                           megakernel=False)
        x = torch.as_tensor(rng.integers(-127, 128, (batch, dims[0])),
                            dtype=torch.int32, device=device)
        y_staged, _ = cm.streaming_compiled(x, micro_batch=micro_batch)
        t_staged = best(cm.streaming_compiled, x)
        cm.set_megakernel(True)
        if not cm._mega_plans:
            raise RuntimeError(f"{name}: the planner admitted no megakernel")
        plan = next(iter(cm._mega_plans.values()))
        y_mega, stats = cm.streaming_compiled(x, micro_batch=micro_batch)
        if stats.megakernel != [(plan.start, plan.stop)]:
            raise RuntimeError(f"{name}: megakernel runs {stats.megakernel}")
        t_mega = best(cm.streaming_compiled, x)
        torch.testing.assert_close(y_mega, y_staged, rtol=1e-5, atol=1e-5)
        run_stages = cm.schedule.stages[plan.start:plan.stop]
        n_micro = -(-batch // micro_batch)
        mega_b = megakernel_traffic_bytes(run_stages, batch)
        staged_b = n_micro * staged_traffic_bytes(run_stages, micro_batch)
        rows.append(row(
            f"kernel/megakernel_{name}", t_mega * 1e6,
            staged_us=round(t_staged * 1e6, 1),
            megakernel_speedup=f"{t_staged / max(t_mega, 1e-9):.2f}x",
            batch=batch, micro_batch=micro_batch,
            fused_stages=plan.n_stages, resident_bytes=plan.total_bytes,
            modeled_bytes_saved=int(staged_b - mega_b),
            hbm_bytes_model=int(mega_b)))
    return rows


def run(directory=None) -> Dict:
    """Every section on the card; prints the rows and writes
    ``BENCH_torch_kernels.json``. Returns the artifact's payload."""
    device = torch.device("cuda")
    banner("Kernel bench: fused dataflow stage (K5 qmatmul) and the FINN "
           "activation (K4 multi_threshold)")
    cases = kernel_cases(device)
    worst = check_cases(cases)
    rows = time_cases(cases)
    print_rows(rows)
    rows += conv_lowering_rows(device)
    print_rows(rows[-3:])
    rows += megakernel_rows(device)
    print_rows(rows[-2:])
    payload = {"rows": rows, "max_abs_err": worst,
               "device": torch.cuda.get_device_name(device)}
    emit_json("BENCH_torch_kernels.json", payload, directory)
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="where BENCH_torch_kernels.json goes "
                         "(default: REPRO_BENCH_DIR or .)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device; the bench times device work",
              file=sys.stderr)
        return 2
    run(args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

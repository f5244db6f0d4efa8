#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME``, default ``/usr/local/cuda``)
and the repository around this file; it adds ``src/`` to ``sys.path``
itself and imports nothing of JAX or of the JAX package. Phases, each of
which fails the run with a non-zero exit:

  1. build   — compile every kernel of the path from ``csrc/`` (one nvcc
               per source, in parallel), time printed;
  2. kernels — each kernel against its plain PyTorch version on the card,
               exact integer equality: K1/K2 at ragged shapes, S in
               {1, 7, 255}, K = 5 / stride 2 / C = 1; K3 on chains of 1 to
               5 stages, ragged M, widths up to 512, S in {1, 7, 255},
               signed first-layer codes;
  3. main path — ``compile_graph(device="cuda")`` of the full-width KWS
               MLP (490-256x3-12, 3-bit) and AD autoencoder
               (128-72-72-8-72-72-128, 8-bit), built with ``export_qmlp``
               from numpy-seeded parameters, and of the IC and CNV golden
               graphs, each in both dispatch modes (staged,
               ``megakernel=False``; auto, the default); launch counters
               set to 0, one ``offline`` call of each model in each mode on
               a 1024-row batch, counters read (staged: K1 3 / 5 times for
               KWS / AD; auto: K3 once for KWS, AD and CNV, K1 never for
               KWS and AD); then ``predict``. Every fused stage's kernel,
               and every planned K3 run, is then held against its plain
               version on its real main-path input, and every model's
               outputs against the port on the CPU (integers exact, logits
               within 1e-5);
  4. goldens — the four golden graphs on the card under both conv
               lowerings equal their ``.golden.npz`` stage outputs;
  5. streaming — ``streaming_host``, ``streaming_compiled`` and a partly
               filled ``submit_wave`` of each model in both modes equal
               ``offline``: the integer codes (the schedule without its
               float head) bit for bit, the logits within 1e-5; K3
               launched once per ``streaming_compiled`` call in auto mode;
  6. times   — per kernel and main-path shape: kernel, plain version and
               library yardstick (device time: CUDA-graph replay timed with
               CUDA events, ``time_ms``), with the bound from bytes
               and int8 operations; K3 also beside the summed K1 times of
               the same stages; ``offline`` ms per 1024-row batch in both
               modes;
  7. full width — the kernels at the paper's IC and CNV stage shapes on
               seeded codes, held against their plain versions and timed
               (``FULL_WIDTH_CONVS``, ``FULL_WIDTH_DENSE``, and K3 on CNV's
               256-512-512 FC chain);
  8. attention — ``flash_attention`` (K6) against its plain version on
               seeded q/k/v (``FLASH_CASES``): GQA 32/8 and 4/2, head dims
               16/80/128, causal, not causal, window 32, a decode chunk
               (q_offset > 0, Sq < Sk), ragged lengths and ``kv_len``, as
               strided (B, S, H, D) views and contiguous; float32 within
               1e-5, bf16 within 2e-2;
  9. LM path — ``Model(get_config("llama3-8b"))`` at full width, bf16,
               seeded ``init`` on the card; counters set to 0, one
               ``prefill`` of 1 x 4096 seeded tokens (the chunked branch
               under "auto"), counters read: exactly 32 K6 launches, no
               other kernel, finite logits; the first and last layers' K6
               launches held against the plain version on their real
               inputs; prefill and decode times. Then the same config cut to
               2 layers at full width, float32, S 512, "chunked", TF32
               off: logits on the card equal the port on the CPU within
               1e-4. Then ``ServeEngine`` (4 slots, max_len 256) on the
               full-width model in float32 (TF32 off) serves 8 seeded
               requests of 8-32 prompt tokens and 8 new tokens; every
               request finishes with the tokens of its own sequential
               greedy decode; last, a ``torch.profiler`` breakdown of one
               prefill and one decode step of the bf16 model (device time
               by kernel family, idle share, costliest kernels and host
               ops);
 10. K6 times — at the main path's shape on its layer-0 inputs: kernel,
               plain version and ``scaled_dot_product_attention`` (the
               library yardstick, never on the path), with the bound from
               bytes and bf16 tensor-core operations.

The last lines are the kernels JSON line, the card's name and power limit
(``nvidia-smi``), and ``{"ok": true, "device": {...}}``. Per-shape details
go to ``chiprun_out/chip_smoke_details.json``. Each kernel's ``launches``
comes from its own main path's counted run: phase 3 for K1-K3, phase 9's
prefill for K6.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "golden")
BATCH = 1024
SEED = 2022
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
LM_CONFIG = "llama3-8b"
LM_SEQ = 4096                    # prefill length: "auto" takes K6 above 2048
REPLACES = {
    "threshold_matmul": ("src/repro_torch/kernels/csrc/threshold_matmul.cu",
                         "src/repro/kernels/multi_threshold.py:163"),
    "conv_threshold": ("src/repro_torch/kernels/csrc/conv_threshold.cu",
                       "src/repro/kernels/conv_threshold.py:127"),
    "mlp_megakernel": ("src/repro_torch/kernels/csrc/mlp_megakernel.cu",
                       "src/repro/kernels/megakernel.py:81"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:96"),
}
#: the peak each kernel's operations are bounded by: integer codes on the
#: int8 tensor-core rate, attention on the bf16 rate
PEAK_OPS_PER_S = {"threshold_matmul": INT8_OPS_PER_S,
                  "conv_threshold": INT8_OPS_PER_S,
                  "mlp_megakernel": INT8_OPS_PER_S,
                  "flash_attention": BF16_OPS_PER_S}
#: the kernels of the integer path (phase 3) and of the LM path (phase 9)
TINY_KERNELS = ("threshold_matmul", "conv_threshold", "mlp_megakernel")
LM_KERNELS = ("flash_attention",)
#: the two dispatch modes of the main path: (label, ``megakernel=``)
MODES = (("staged", False), ("auto", None))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def mlp_graph(dims, bits, seed):
    """A full-width QIR MLP from numpy-seeded parameters, BN statistics
    away from the identity so the BN fold is exercised."""
    import numpy as np
    from repro_torch.core.qir import LayerBits, export_qmlp

    rng = np.random.default_rng(seed)
    hidden = []
    scale, in_qmax, qmax = 1.0 / 127.0, 2 ** (bits - 1) - 1, 2 ** bits - 1
    for i in range(len(dims) - 2):
        fan_in, fan_out = dims[i], dims[i + 1]
        p = {"w": (rng.standard_normal((fan_in, fan_out))
                   * np.sqrt(2.0 / fan_in)).astype(np.float32),
             "b": (0.05 * rng.standard_normal(fan_out)).astype(np.float32),
             "gamma": rng.uniform(0.5, 1.5, fan_out).astype(np.float32),
             "mu": (0.2 * rng.standard_normal(fan_out)).astype(np.float32),
             "sigma2": rng.uniform(0.5, 2.0, fan_out).astype(np.float32)}
        # the frozen scale covers the worst-case reach, which random inputs
        # never approach; a BN shift of -10..20% of that reach keeps about
        # half of every layer's codes off zero, so deep stages see
        # non-trivial inputs
        v = p["gamma"] / np.sqrt(p["sigma2"] + 1e-3)
        reach = np.abs(p["w"] * v).sum(axis=0) * scale * in_qmax
        p["beta"] = (rng.uniform(-0.1, 0.2, fan_out) * reach.max()
                     ).astype(np.float32)
        b_f = v * (p["b"] - p["mu"]) + p["beta"]
        scale = 2.0 ** np.round(np.log2((reach + np.abs(b_f)).max() / qmax))
        hidden.append(p)
    w = rng.standard_normal((dims[-2], dims[-1])) * np.sqrt(1.0 / dims[-2])
    # zero column sums: the codes' common offset does not pick the class
    head = {"w": (w - w.mean(axis=0)).astype(np.float32),
            "b": (0.01 * rng.standard_normal(dims[-1])).astype(np.float32)}
    layers = [LayerBits(weight_bits=bits, act_bits=bits)] * (len(dims) - 2)
    return export_qmlp(layers, hidden, head, freeze_scales=True,
                       in_scale=1.0 / 127.0)


def load_models():
    """(name, graph, in_scale, x) for the four models of the main path."""
    import numpy as np
    from repro_torch.core.qir import Graph

    rng = np.random.default_rng(SEED)
    models = [("kws", mlp_graph([490, 256, 256, 256, 12], 3, SEED + 1),
               1.0 / 127.0, (BATCH, 490)),
              ("ad", mlp_graph([128, 72, 72, 8, 72, 72, 128], 8, SEED + 2),
               1.0 / 127.0, (BATCH, 128))]
    for name in ("ic", "cnv"):
        g = Graph.load(os.path.join(GOLDEN, f"{name}.qir.json"))
        shape = tuple(g.nodes[0].attrs["in_shape"])
        models.append((name, g, g.meta["in_scale"], (BATCH,) + shape))
    return [(n, g, s, rng.integers(-127, 128, shp).astype(np.int32))
            for n, g, s, shp in models]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps=7, inner=20):
    """Median over ``reps`` of the mean per-call device time of ``inner``
    back-to-back calls (CUDA events), after one warm call. The calls are
    captured once in a CUDA graph and the graph is replayed, so the time
    is the device's: the host's dispatch of each call (Python, ctypes,
    allocation; tens of µs) would otherwise leave the card idle between
    small kernels and be timed instead. Weights and banks stay in L2
    between calls, as they do between the blocks of one wave."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        vals.append(a.elapsed_time(b) / inner)
    del graph
    return statistics.median(vals)


def bound_ms(n_bytes, n_ops, ops_per_s=INT8_OPS_PER_S):
    """Least time for the work: bytes over HBM rate or operations over the
    kernel's tensor-core peak, whichever is larger (published H100 SXM
    peaks)."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s) * 1e3


def bound_by(n_bytes, n_ops, ops_per_s):
    return ("bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / ops_per_s
            else "operations")


def tmm_cost(x, w, t):
    m, k = x.shape
    n, s = t.shape
    return (x.numel() * 4 + w.numel() + t.numel() * 4 + m * n * 4,
            2 * m * n * k)


def conv_cost(x, w, t, kernel, out_h, out_w):
    n, _, _, c = x.shape
    f = w.shape[1]
    return (x.numel() * 4 + w.numel() + t.numel() * 4
            + n * out_h * out_w * f * 4,
            2 * n * out_h * out_w * kernel * kernel * c * f)


def tmm_case(model, stage, x, w, t):
    """A timing case for ``threshold_matmul`` on (x, w, t)."""
    from repro_torch.kernels import ops, ref

    nbytes, nops = tmm_cost(x, w, t)
    return {"kernel": "threshold_matmul", "model": model, "stage": stage,
            "shape": f"M={x.shape[0]} K={x.shape[1]} N={w.shape[1]} "
                     f"S={t.shape[1]}",
            "run": lambda: ops.threshold_matmul(x, w, t),
            "plain": lambda: ref.threshold_matmul_ref(x, w, t),
            "library": _mm_library(x, w),
            "bytes": nbytes, "ops": nops}


def conv_case(model, stage, x, w, t, kw):
    """A timing case for ``conv_threshold`` on (x, w, t) with the conv
    geometry ``kw`` (kernel, stride, padding, out_h, out_w)."""
    from repro_torch.kernels import ops

    nbytes, nops = conv_cost(x, w, t, kw["kernel"], kw["out_h"], kw["out_w"])
    return {"kernel": "conv_threshold", "model": model, "stage": stage,
            "shape": f"N={x.shape[0]} {x.shape[1]}x{x.shape[2]}x"
                     f"{x.shape[3]} F={w.shape[1]} K={kw['kernel']} "
                     f"stride={kw['stride']} {kw['padding']} S={t.shape[1]}",
            "run": lambda: ops.conv_threshold(x, w, t, **kw),
            "plain": lambda: _conv_plain(x, w, t, **kw),
            "library": _conv_library(x, w, **kw),
            "bytes": nbytes, "ops": nops}


def chain_codes(x, weights, banks):
    """Each stage's input codes along a dense chain (plain versions): the
    inputs the staged K1 launches of the same run see."""
    from repro_torch.kernels import ref

    hs = [x]
    for w, b in zip(weights[:-1], banks[:-1]):
        hs.append(ref.threshold_matmul_ref(hs[-1], w, b))
    return hs


def mega_case(model, stages, x, weights, banks):
    """A timing case for ``mlp_megakernel`` on one dense run: x (M, K_0)
    int32, per-stage int8 weights and (N, S) banks (the stages'
    ``thresholds``), all on the card; the kernel and its plain version
    take the banks step-major, as the executor passes them. Beside them:
    the staged K1 launches of the same stages, and the fp32
    ``torch.matmul`` chain of the accumulators alone (TF32 off)."""
    import torch
    from repro_torch.kernels import ops, ref

    banks_sn = [b.t().contiguous() for b in banks]
    hs = chain_codes(x, weights, banks)
    hf = [h.to(torch.float32) for h in hs]
    wf = [w.to(torch.float32) for w in weights]
    torch.backends.cuda.matmul.allow_tf32 = False
    m = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    nbytes = (x.numel() * 4 + m * dims[-1] * 4
              + sum(w.numel() for w in weights)
              + sum(b.numel() * 4 for b in banks))
    nops = 2 * m * sum(w.shape[0] * w.shape[1] for w in weights)
    return {"kernel": "mlp_megakernel", "model": model, "stage": stages,
            "shape": f"M={m} dims={'-'.join(map(str, dims))} "
                     f"S={'/'.join(str(b.shape[1]) for b in banks)}",
            "run": lambda: ops.mlp_megakernel(x, weights, banks_sn),
            "plain": lambda: ref.mlp_megakernel_ref(x, weights, banks_sn),
            "library": lambda: [torch.matmul(h, w) for h, w in zip(hf, wf)],
            "staged": lambda: [ops.threshold_matmul(h, w, b) for h, w, b
                               in zip(hs, weights, banks)],
            "bytes": nbytes, "ops": nops}


def _random_chain(g, m, dims, steps, lo, hi):
    """Seeded codes (M, dims[0]) in [lo, hi), int8 weights, and sorted
    (N, S) banks drawn from each stage's own accumulator so counts
    spread."""
    import torch
    from repro_torch.kernels import ref

    x = torch.randint(lo, hi, (m, dims[0]), generator=g, dtype=torch.int32)
    weights, banks, h = [], [], x
    for k, n, s in zip(dims[:-1], dims[1:], steps):
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        b = _banks(ref.int_matmul(h, w), n, s, g)
        h = ref.threshold_matmul_ref(h, w, b)
        weights.append(w)
        banks.append(b)
    return x, weights, banks


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels_synthetic():
    """Each kernel against its plain version at ragged shapes and the bank
    depths the models use; returns the largest |kernel - plain| per kernel."""
    import torch
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(SEED)
    worst = dict.fromkeys(REPLACES, 0)
    for m, k, n, s, lo, hi in [(1, 1, 1, 1, -127, 128),
                               (37, 19, 70, 1, -127, 128),
                               (130, 65, 129, 7, 0, 8),
                               (257, 300, 100, 255, 0, 256),
                               (1000, 33, 3, 255, -127, 128)]:
        x = torch.randint(lo, hi, (m, k), generator=g, dtype=torch.int32)
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        acc = ref.int_matmul(x, w)
        t = torch.sort(torch.randint(int(acc.min()), int(acc.max()) + 1,
                                     (n, s), generator=g, dtype=torch.int32),
                       dim=1).values
        x, w, t = x.cuda(), w.cuda(), t.cuda()
        got = ops.threshold_matmul(x, w, t)
        want = ref.threshold_matmul_ref(x, w, t)
        err = int((got - want).abs().max())
        worst["threshold_matmul"] = max(worst["threshold_matmul"], err)
        check(err == 0, f"threshold_matmul {m}x{k}x{n} S={s}: max err {err}")
        log(f"kernel-check threshold_matmul M={m} K={k} N={n} S={s}: exact")
    for nb, h, wd, c, f, kk, st, pad, s in [
            (3, 11, 9, 1, 5, 5, 2, "SAME", 7),
            (2, 13, 13, 3, 6, 5, 2, "VALID", 255),
            (2, 7, 9, 5, 3, 3, 1, "SAME", 1),
            (1, 5, 5, 1, 2, 1, 1, "SAME", 3),
            # wide outputs: row blocks of 2 and 3 rows, the last one partial
            (2, 9, 120, 3, 4, 3, 1, "SAME", 7),
            (1, 11, 150, 2, 3, 4, 2, "VALID", 255)]:
        x = torch.randint(0, 256, (nb, h, wd, c), generator=g,
                          dtype=torch.int32).cuda()
        oh = -(-h // st) if pad == "SAME" else (h - kk) // st + 1
        ow = -(-wd // st) if pad == "SAME" else (wd - kk) // st + 1
        w = torch.randint(-127, 128, (kk * kk * c, f), generator=g,
                          dtype=torch.int8).cuda()
        t = torch.sort(torch.randint(-30000, 30000, (f, s), generator=g,
                                     dtype=torch.int32), dim=1).values.cuda()
        kw = dict(kernel=kk, stride=st, padding=pad, out_h=oh, out_w=ow)
        got = ops.conv_threshold(x, w, t, **kw)
        want = _conv_plain(x, w, t, **kw)
        err = int((got - want).abs().max())
        worst["conv_threshold"] = max(worst["conv_threshold"], err)
        check(err == 0, f"conv_threshold K={kk} s={st} {pad} C={c}: err {err}")
        log(f"kernel-check conv_threshold N={nb} {h}x{wd}x{c} F={f} K={kk} "
            f"stride={st} {pad} S={s}: exact")
    for m, dims, steps, lo, hi in [
            (1, [1, 1], [1], -127, 128),
            (37, [19, 70, 9], [7, 255], -127, 128),
            (1000, [490, 256, 256, 256], [7, 7, 7], -127, 128),
            (1023, [128, 72, 72, 8, 72, 72], [255] * 5, -127, 128),
            (333, [33, 5, 11, 512, 3], [1, 7, 255, 7], 0, 256),
            (129, [512, 512, 512, 500], [1, 7, 1], 0, 2)]:
        x, ws, bs = _random_chain(g, m, dims, steps, lo, hi)
        x, ws = x.cuda(), [w.cuda() for w in ws]
        bs = [b.t().contiguous().cuda() for b in bs]
        got = ops.mlp_megakernel(x, ws, bs)
        want = ref.mlp_megakernel_ref(x, ws, bs)
        err = int((got - want).abs().max())
        worst["mlp_megakernel"] = max(worst["mlp_megakernel"], err)
        check(err == 0, f"mlp_megakernel M={m} dims={dims}: max err {err}")
        log(f"kernel-check mlp_megakernel M={m} dims={dims} S={steps}: "
            f"exact (nonzero share {float((want > 0).float().mean()):.3f})")
    return worst


def _conv_plain(x, w, t, *, kernel, stride, padding, out_h, out_w):
    from repro_torch.kernels import ref
    from repro_torch.kernels.conv_threshold import pad_input

    xp = pad_input(x, kernel=kernel, stride=stride, padding=padding,
                   out_h=out_h, out_w=out_w)
    return ref.conv_threshold_ref(xp, w, t, kernel=kernel, stride=stride,
                                  out_h=out_h, out_w=out_w)


def phase_main_path(models):
    """Counters to 0, one ``offline`` call of each of the four models in
    each dispatch mode on the card, counters read; then ``predict``,
    outside the counted run. Returns ({(name, mode): (model, logits,
    pred)}, launches, launches per "name/mode")."""
    import torch
    from repro_torch.deploy import compile_graph
    from repro_torch.kernels import ops

    compiled = {(n, mode): compile_graph(g, in_scale=s, device="cuda",
                                         conv_lowering="direct",
                                         megakernel=mk)
                for n, g, s, _ in models for mode, mk in MODES}
    xs = {n: torch.as_tensor(x).cuda() for n, _, _, x in models}
    torch.cuda.synchronize()
    per_run, logits = {}, {}
    ops.reset_launches()
    for (n, mode), cm in compiled.items():
        before = dict(ops.launches)
        logits[(n, mode)] = cm.offline(xs[n])
        per_run[f"{n}/{mode}"] = {k: ops.launches[k] - before[k]
                                  for k in before}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    results = {key: (cm, logits[key], cm.predict(xs[key[0]]))
               for key, cm in compiled.items()}
    log(f"main-path launches per offline call: {json.dumps(per_run)}")
    log(f"main-path launches (one offline call of each of the 4 models in "
        f"each of the 2 modes): {json.dumps(launches)}")
    for n, want in (("kws", 3), ("ad", 5)):
        got = per_run[f"{n}/staged"]["threshold_matmul"]
        check(got == want, f"staged {n} offline launched threshold_matmul "
                           f"{got} times, expected {want}")
        got = per_run[f"{n}/auto"]["threshold_matmul"]
        check(got == 0, f"auto {n} offline launched threshold_matmul "
                        f"{got} times, expected 0")
    for n in ("kws", "ad", "cnv"):
        got = per_run[f"{n}/auto"]["mlp_megakernel"]
        check(got == 1, f"auto {n} offline launched mlp_megakernel {got} "
                        f"times, expected 1")
    for n, _, _, _ in models:
        check(per_run[f"{n}/staged"]["mlp_megakernel"] == 0,
              f"staged {n} offline launched mlp_megakernel")
    for name in TINY_KERNELS:
        check(launches[name] > 0, f"{name} was never launched on the main "
                                  f"path")
    for name in LM_KERNELS:
        check(launches[name] == 0, f"{name} launched on the integer path")
    return results, launches, per_run


def _plans(cm):
    """The megakernel runs the planner admits for ``cm``'s segments."""
    from repro_torch.deploy import plan_megakernel

    plans = [plan_megakernel(cm.schedule.stages, seg) for seg in cm.segments]
    return [p for p in plans if p is not None]


def phase_main_path_checks(models, results):
    """Both modes' outputs on the card equal the port on the CPU; every
    fused stage's kernel and every planned K3 run equals its plain version
    on its main-path input. Returns (per-stage timing cases, each with the
    number of its launches in the counted run, and the worst
    |kernel - plain| per kernel)."""
    import numpy as np
    import torch
    from repro_torch.deploy import (FusedConvThresholdStage,
                                    FusedThresholdStage, compile_graph)

    cases, worst = [], dict.fromkeys(REPLACES, 0)
    for n, g, s, x in models:
        cm, logits, pred = results[(n, "staged")]
        auto, a_logits, a_pred = results[(n, "auto")]
        cpu = compile_graph(g, in_scale=s, device="cpu",
                            conv_lowering="direct")
        want = cpu.stage_outputs(x)
        got = cm.stage_outputs(torch.as_tensor(x).cuda())
        for i, (a, b) in enumerate(zip(got, want)):
            a = a.cpu()
            if b.dtype.is_floating_point:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            else:
                check(torch.equal(a, b), f"{n} stage {i}: CUDA != CPU")
        for mode, lg, pr in (("staged", logits, pred),
                             ("auto", a_logits, a_pred)):
            torch.testing.assert_close(lg.cpu(), want[-1], rtol=1e-5,
                                       atol=1e-5)
            check(torch.equal(pr.cpu(), torch.argmax(want[-1], dim=-1)),
                  f"{n}[{mode}]: predict on CUDA != argmax on CPU")
        codes = [o for o in want[:-1] if not o.dtype.is_floating_point]
        nz = np.mean([float((c > 0).float().mean()) for c in codes])
        log(f"main-path {n}: {len(got)} stages equal the CPU port "
            f"(ints exact, logits within 1e-5 in both modes; mean nonzero "
            f"code share {nz:.3f}); predict == CPU argmax")
        plans = _plans(auto)
        for p in plans:
            run = auto.schedule.stages[p.start:p.stop]
            xi = (torch.as_tensor(x) if p.start == 0 else want[p.start - 1])
            xi = xi.to(torch.int32).contiguous().cuda()
            cases.append(mega_case(n, f"{run[0].name}..{run[-1].name}", xi,
                                   [st.stage.w_int for st in run],
                                   [st.stage.thresholds for st in run]))
            cases[-1]["launches"] = 1
            k_out, p_out = cases[-1]["run"](), cases[-1]["plain"]()
            err = int((k_out - p_out).abs().max())
            worst["mlp_megakernel"] = max(worst["mlp_megakernel"], err)
            check(err == 0 and torch.equal(k_out.cpu(), want[p.stop - 1]),
                  f"{n} {cases[-1]['stage']}: megakernel != plain / CPU "
                  f"(max err {err})")
            log(f"kernel-check mlp_megakernel {n}/{cases[-1]['stage']} "
                f"{cases[-1]['shape']}: exact, equals the CPU stages")
        h = torch.as_tensor(x).cuda()
        for i, (st, out) in enumerate(zip(cm.schedule.stages, got)):
            if isinstance(st, FusedThresholdStage):
                xi = h.to(torch.int32).contiguous()
                cases.append(tmm_case(n, st.name, xi, st.stage.w_int,
                                      st.stage.thresholds))
            elif isinstance(st, FusedConvThresholdStage):
                gm = st.geom
                xi = h.reshape(-1, gm.in_h, gm.in_w, gm.in_ch).to(
                    torch.int32).contiguous()
                kw = dict(kernel=gm.kernel, stride=gm.stride,
                          padding=gm.padding, out_h=gm.out_h, out_w=gm.out_w)
                cases.append(conv_case(n, st.name, xi, st.stage.w_int,
                                       st.stage.thresholds, kw))
            else:
                h = out
                continue
            # once in the staged run; once more in the auto run unless a
            # planned megakernel covers the stage there
            cases[-1]["launches"] = 1 + all(not p.start <= i < p.stop
                                            for p in plans)
            k_out, p_out = cases[-1]["run"](), cases[-1]["plain"]()
            err = int((k_out - p_out).abs().max())
            kname = cases[-1]["kernel"]
            worst[kname] = max(worst[kname], err)
            check(err == 0 and torch.equal(k_out.reshape(out.shape), out),
                  f"{n} {st.name}: kernel != plain (max err {err})")
            log(f"kernel-check {cases[-1]['kernel']} {n}/{st.name} "
                f"{cases[-1]['shape']}: exact")
            h = out
    return cases, worst


def _mm_library(x, w):
    """One fp32 ``torch.matmul`` of the accumulator alone (no threshold
    count): a partial yardstick, since no single library call computes the
    fused stage."""
    import torch

    xf, wf = x.to(torch.float32), w.to(torch.float32)
    return lambda: torch.matmul(xf, wf)


def _conv_library(x, w, *, kernel, stride, padding, out_h, out_w):
    """One fp32 cuDNN convolution of the accumulator alone (no threshold
    count, TF32 off, input pre-padded): a partial yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv_threshold import pad_input

    xf = pad_input(x.to(torch.float32), kernel=kernel, stride=stride,
                   padding=padding, out_h=out_h, out_w=out_w)
    xf = xf.permute(0, 3, 1, 2).contiguous()
    wf = w.to(torch.float32).reshape(kernel, kernel, x.shape[3],
                                     w.shape[1]).permute(3, 2, 0, 1)
    wf = wf.contiguous()
    torch.backends.cudnn.allow_tf32 = False
    return lambda: F.conv2d(xf, wf, stride=stride)


def phase_goldens():
    import numpy as np
    import torch
    from repro_torch.core.qir import Graph
    from repro_torch.deploy import compile_graph

    for name in ("kws", "ad", "ic", "cnv"):
        g = Graph.load(os.path.join(GOLDEN, f"{name}.qir.json"))
        data = np.load(os.path.join(GOLDEN, f"{name}.golden.npz"))
        want = [data[k] for k in sorted(data.files) if k.startswith("stage_")]
        for lowering in ("direct", "im2col"):
            cm = compile_graph(g, in_scale=g.meta["in_scale"], device="cuda",
                               conv_lowering=lowering)
            outs = cm.stage_outputs(data["x"])
            check(len(outs) == len(want), f"golden {name}: stage count")
            for i, (a, b) in enumerate(zip(outs, want)):
                a = a.cpu().numpy()
                if np.issubdtype(b.dtype, np.integer):
                    check(np.array_equal(a, b),
                          f"golden {name}[{lowering}] stage {i} differs")
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            log(f"golden {name}[{lowering}]: {len(outs)} stages equal "
                f"the .golden.npz")


def phase_streaming(models, results):
    """``streaming_host``, ``streaming_compiled`` and a partly filled
    ``submit_wave`` of every model in both modes on the card, against
    ``offline`` of the same model: the logits within 1e-5, and — through
    the same schedule without its float head — the integer codes bit for
    bit. Returns {"name/mode": whether the logits were bit for bit too}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.deploy import CompiledTinyModel
    from repro_torch.kernels import ops

    valid = np.arange(11) % 3 != 1           # 11 rows of a 16-row wave
    out = {}
    for n, _, _, x in models:
        xc = torch.as_tensor(x).cuda()
        for mode, mk in MODES:
            cm = results[(n, mode)][0]
            headless = CompiledTinyModel(
                dataclasses.replace(cm.schedule,
                                    stages=cm.schedule.stages[:-1]),
                device="cuda", megakernel=mk)
            flags = {}
            for model, kind in ((cm, "logits"), (headless, "codes")):
                y_off = model.offline(xc)
                y_host, _ = model.streaming_host(xc)
                ops.reset_launches()
                y_cmp, st = model.streaming_compiled(xc)
                torch.cuda.synchronize()
                k3 = ops.launches["mlp_megakernel"]
                want_k3 = int(mode == "auto" and n != "ic")
                check(k3 == want_k3, f"{n}[{mode}] streaming_compiled "
                                     f"({kind}) launched mlp_megakernel {k3} "
                                     f"times, expected {want_k3}")
                y_w, mask = model.submit_wave(x[:11], valid=valid)
                y_w = y_w[torch.as_tensor(mask).cuda()]
                y_v = y_off[:11][torch.as_tensor(valid).cuda()]
                for label, got, want in (("streaming_host", y_host, y_off),
                                         ("streaming_compiled", y_cmp, y_off),
                                         ("submit_wave", y_w, y_v)):
                    check(got.shape == want.shape, f"{n}[{mode}] {label} "
                          f"({kind}): shape {tuple(got.shape)}")
                    same = bool(torch.equal(got, want))
                    if kind == "codes":
                        check(same, f"{n}[{mode}] {label}: codes differ "
                                    f"from offline")
                    else:
                        torch.testing.assert_close(got, want, rtol=1e-5,
                                                   atol=1e-5)
                        flags[label] = same
            out[f"{n}/{mode}"] = flags
            log(f"streaming {n}[{mode}]: {st.n_micro} micro-batches of "
                f"{st.micro_batch}, megakernel runs {st.megakernel}; "
                f"host/compiled/wave codes equal offline bit for bit, logits "
                f"within 1e-5 (bit for bit: {flags})")
    return out


def time_case(c, reps=7, inner=20):
    """Kernel, plain-version and library times of one case, with its bound;
    the plain version gets 3 x 3 calls."""
    row = {k: c[k] for k in ("kernel", "model", "stage", "shape", "bytes",
                             "ops")}
    row["launches"] = c.get("launches", 0)
    row["ms"] = time_ms(c["run"], reps=reps, inner=inner)
    row["plain_ms"] = time_ms(c["plain"], reps=3, inner=3)
    row["library_ms"] = time_ms(c["library"], reps=reps, inner=inner)
    peak = PEAK_OPS_PER_S[c["kernel"]]
    row["bound_ms"] = bound_ms(c["bytes"], c["ops"], peak)
    row["bound_by"] = bound_by(c["bytes"], c["ops"], peak)
    staged = ""
    if "staged" in c:
        row["staged_k1_ms"] = time_ms(c["staged"], reps=reps, inner=inner)
        staged = f", staged K1 {row['staged_k1_ms']:.6f} ms"
    log(f"time {row['kernel']} {row['model']}/{row['stage']} "
        f"{row['shape']}: kernel {row['ms']:.6f} ms, plain "
        f"{row['plain_ms']:.6f} ms, {c.get('library_is', 'library (partial)')} "
        f"{row['library_ms']:.6f} ms{staged}, bound {row['bound_ms']:.6f} "
        f"ms ({row['bound_by']})")
    return row


def phase_times(cases, results, models):
    import torch
    from repro_torch.obs import timer

    rows = [time_case(c) for c in cases]
    e2e = {}
    for n, _, _, x in models:
        xc = torch.as_tensor(x).cuda()
        for mode, _ in MODES:
            cm = results[(n, mode)][0]
            cm.offline(xc)
            torch.cuda.synchronize()
            samples = []
            for _ in range(21):
                t0 = timer.now()
                cm.offline(xc)
                torch.cuda.synchronize()
                samples.append((timer.now() - t0) * 1e3)
            e2e[f"{n}/{mode}"] = statistics.median(samples)
            log(f"e2e offline {n}[{mode}]: {e2e[f'{n}/{mode}']:.6f} ms per "
                f"{x.shape[0]}-row batch (host clock, median of 21, "
                f"synchronised)")
    return rows, e2e


# The conv stages of the paper's IC (hls4ml v0.7: 32x32x3 input, SAME,
# 8-bit, S = 255) and CNV-W1A1 (32x32x3 input, 3x3 VALID, 64..256 channels,
# binary, S = 1; 2x2 pools after conv1 and conv3) and CNV's two 512-wide
# binary FC stages, from ``repro.models.tiny.ICModel`` / ``CNVModel``
# defaults: (model, stage, H, W, C, F, kernel, stride, padding, S).
FULL_WIDTH_CONVS = [
    ("ic", "conv0", 32, 32, 3, 32, 1, 1, "SAME", 255),
    ("ic", "conv1", 32, 32, 32, 4, 4, 1, "SAME", 255),
    ("ic", "conv2", 32, 32, 4, 32, 4, 1, "SAME", 255),
    ("ic", "conv3", 32, 32, 32, 32, 4, 4, "SAME", 255),
    ("ic", "conv4", 8, 8, 32, 4, 4, 1, "SAME", 255),
    ("cnv", "conv0", 32, 32, 3, 64, 3, 1, "VALID", 1),
    ("cnv", "conv1", 30, 30, 64, 64, 3, 1, "VALID", 1),
    ("cnv", "conv2", 14, 14, 64, 128, 3, 1, "VALID", 1),
    ("cnv", "conv3", 12, 12, 128, 128, 3, 1, "VALID", 1),
    ("cnv", "conv4", 5, 5, 128, 256, 3, 1, "VALID", 1),
    ("cnv", "conv5", 3, 3, 256, 256, 3, 1, "VALID", 1),
]
FULL_WIDTH_DENSE = [("cnv", "fc0", 256, 512, 1), ("cnv", "fc1", 512, 512, 1)]


def _banks(acc, n_ch, s, g):
    """(n_ch, s) sorted banks drawn from the accumulator's own values, so
    the counts spread over [0, s]."""
    import torch

    flat = acc.reshape(-1)
    idx = torch.randint(0, flat.numel(), (n_ch * s,), generator=g)
    return torch.sort(flat[idx.to(flat.device)].reshape(n_ch, s),
                      dim=1).values


def phase_full_width():
    """The kernels at the paper's full IC / CNV widths on a 1024-sample
    batch of seeded codes (the port cannot export these models yet, so no
    graph drives them): each held exactly against its plain version, then
    timed. Returns (rows, worst |kernel - plain| per kernel)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.conv_threshold import direct_conv_acc, pad_input

    g = torch.Generator().manual_seed(SEED + 3)
    cases, worst = [], dict.fromkeys(REPLACES, 0)
    for model, stage, h, wd, c, f, k, st, pad, s in FULL_WIDTH_CONVS:
        first = stage == "conv0"
        lo, hi = ((-127, 128) if model == "ic" else (0, 256)) if first \
            else ((0, 256) if model == "ic" else (0, 2))
        wlo, whi = (-127, 128) if model == "ic" or first else (-2, 3)
        x = torch.randint(lo, hi, (BATCH, h, wd, c), generator=g,
                          dtype=torch.int32).cuda()
        w = torch.randint(wlo, whi, (k * k * c, f), generator=g,
                          dtype=torch.int8).cuda()
        oh = -(-h // st) if pad == "SAME" else (h - k) // st + 1
        ow = -(-wd // st) if pad == "SAME" else (wd - k) // st + 1
        kw = dict(kernel=k, stride=st, padding=pad, out_h=oh, out_w=ow)
        acc = direct_conv_acc(pad_input(x, **kw), w, kernel=k, stride=st,
                              out_h=oh, out_w=ow)
        t = _banks(acc, f, s, g)
        del acc
        cases.append(conv_case(model, stage, x, w, t, kw))
    for model, stage, k, n, s in FULL_WIDTH_DENSE:
        x = torch.randint(0, 2, (BATCH, k), generator=g,
                          dtype=torch.int32).cuda()
        w = torch.randint(-2, 3, (k, n), generator=g, dtype=torch.int8).cuda()
        t = _banks(ref.int_matmul(x, w), n, s, g)
        cases.append(tmm_case(model, stage, x, w, t))
    x, ws, bs = _random_chain(g, BATCH, [256, 512, 512], [1, 1], 0, 2)
    cases.append(mega_case("cnv", "fc0..fc1", x.cuda(),
                           [w.cuda() for w in ws], [b.cuda() for b in bs]))
    rows = []
    for c in cases:
        err = int((c["run"]() - c["plain"]()).abs().max())
        worst[c["kernel"]] = max(worst[c["kernel"]], err)
        check(err == 0, f"full-width {c['kernel']} {c['model']}/"
                        f"{c['stage']}: kernel != plain (max err {err})")
        log(f"kernel-check full-width {c['kernel']} {c['model']}/"
            f"{c['stage']} {c['shape']}: exact")
        rows.append(time_case(c, reps=5, inner=5))
        torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------------------
# the LM path: K6 and the llama3-8b inference entry points
# ---------------------------------------------------------------------------

# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset, kv_len): GQA 32/8 and 4/2,
# head dims 16 (reduced configs), 80 (h2o-danube) and 128 (llama3); causal,
# not causal, window 32, a decode chunk (q_offset > 0, Sq < Sk), ragged
# Sq/Sk, kv_len below Sk, and the main path's shape
FLASH_CASES = [
    (1, 32, 8, 4096, 4096, 128, True, 0, 0, None),
    (2, 32, 8, 300, 300, 128, True, 0, 0, None),
    (2, 4, 2, 130, 130, 16, False, 0, 0, None),
    (1, 4, 2, 257, 257, 80, True, 32, 0, None),
    (3, 4, 2, 100, 100, 16, True, 32, 0, None),
    (2, 4, 2, 17, 95, 128, True, 0, 78, None),
    (1, 32, 8, 1, 513, 128, True, 0, 512, None),
    (1, 32, 8, 70, 133, 80, False, 0, 0, 101),
    (2, 4, 2, 65, 200, 16, True, 32, 120, 150),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def flash_live_pairs(sq, sk, causal, window, q_offset, kv_len):
    """Unmasked (query, key) pairs of one head: what K6 must compute."""
    import numpy as np

    kv_len = sk if kv_len is None else kv_len
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, kv_len) if causal else np.full(sq, kv_len)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_case(label, q, k, v, kw):
    """A timing case for ``flash_attention`` on (q, k, v), (B, H, S, D)
    views; the yardstick is one ``scaled_dot_product_attention`` call on
    the same tensors (GQA through ``enable_gqa``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = flash_live_pairs(sq, sk, kw["causal"], kw["window"],
                             kw["q_offset"], kw.get("kv_len"))
    esize = q.element_size()
    sdpa_causal = kw["causal"] and kw["window"] == 0 and sq == sk
    check(sdpa_causal and kw.get("kv_len") in (None, sk),
          "the SDPA yardstick takes the main path's plain causal mask only")
    return {"kernel": "flash_attention", "model": LM_CONFIG, "stage": label,
            "shape": f"B={b} H={h} Hkv={k.shape[1]} Sq={sq} Sk={sk} D={d} "
                     f"{str(q.dtype).replace('torch.', '')} causal",
            "run": lambda: ops.flash_attention(q, k, v, **kw),
            "plain": lambda: ref.flash_attention_ref(q, k, v, **kw),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            "library_is": "library (SDPA)",
            "bytes": (q.numel() * 2 + k.numel() + v.numel()) * esize,
            "ops": 4 * b * h * d * pairs}


def phase_flash_synthetic():
    """K6 against its plain version at ``FLASH_CASES`` in both dtypes, on
    strided (B, S, H, D) views as the model passes them and on contiguous
    (B, H, S, D) tensors. Returns the worst |kernel - plain| per dtype."""
    import torch
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = dict.fromkeys(FLASH_TOL, 0.0)
    for b, h, hkv, sq, sk, d, causal, window, q_off, kv_len in FLASH_CASES:
        kw = dict(causal=causal, window=window, q_offset=q_off,
                  kv_len=kv_len)
        for dtype, tol in FLASH_TOL.items():
            dt = getattr(torch, dtype)
            q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dt)
            k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
            v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
            views = [t.transpose(1, 2) for t in (q, k, v)]
            want = ref.flash_attention_ref(*views, **kw).float()
            for layout, args in (("strided", views),
                                 ("contiguous",
                                  [t.contiguous() for t in views])):
                got = ops.flash_attention(*args, **kw)
                torch.cuda.synchronize()
                check(got.dtype == dt and got.shape == want.shape,
                      f"flash_attention {dtype} {layout}: {got.dtype} "
                      f"{tuple(got.shape)}")
                err = float((got.float() - want).abs().max())
                worst[dtype] = max(worst[dtype], err)
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=tol)
            log(f"kernel-check flash_attention B={b} H={h}/{hkv} Sq={sq} "
                f"Sk={sk} D={d} causal={causal} window={window} "
                f"q_offset={q_off} kv_len={kv_len} {dtype}: max err "
                f"{err:.3g} (strided and contiguous, tol {tol})")
            del q, k, v, views, want, got
    torch.cuda.empty_cache()
    return worst


def _device_breakdown(fn):
    """Device time of one call of ``fn`` by kernel family, from a
    ``torch.profiler`` trace: K6, matmuls (cuBLAS), everything else; the
    busy time is the union of the kernels' intervals and the idle share is
    the rest of the span from the first kernel's start to the last one's
    end; the 8 costliest kernels and host ops (self CPU time). None when
    the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    top = {}
    for e in kern:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    host = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.name] = (host.get(e.name, 0.0)
                            + e.self_cpu_time_total / 1e3)
    by = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    for e in kern:
        name = e.name.lower()
        fam = ("flash_attention" if "flash_attention_kernel" in name else
               "matmul" if any(t in name for t in ("gemm", "nvjet", "xmma",
                                                   "cutlass", "sm90_"))
               else "other")
        by[fam] += e.time_range.elapsed_us() / 1e3
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    return {"kernels": len(kern), "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
            "ms_by_family": by,
            "top_kernels_ms": dict(sorted(top.items(),
                                          key=lambda kv: -kv[1])[:8]),
            "top_host_ops_self_ms": dict(sorted(host.items(),
                                                key=lambda kv: -kv[1])[:8])}


def _host_ms(fn, n):
    """Median host-clock ms of ``n`` synchronised calls, after one."""
    import torch
    from repro_torch.obs import timer

    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(n):
        t0 = timer.now()
        fn()
        torch.cuda.synchronize()
        vals.append((timer.now() - t0) * 1e3)
    return statistics.median(vals)


def phase_lm_prefill():
    """Full-width llama3-8b in bf16: counters to 0, one ``prefill`` of
    1 x LM_SEQ seeded tokens, counters read; each K6 launch's inputs
    caught (the model's own q/k/v), the first and last layers' held
    against the plain version. Then prefill and decode times. Returns (launches, worst |kernel - plain|, K6's
    timing case on layer 0's inputs, details); the weights are freed on
    return."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    from repro_torch.obs import timer

    cfg = get_config(LM_CONFIG)
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    t0 = timer.now()
    params = model.init(g, device="cuda")
    torch.cuda.synchronize()
    init_s = timer.now() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"lm init {LM_CONFIG}: {n_params} parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16) in {init_s:.3f} s")
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=g,
                           device="cuda")
    batch = {"tokens": tokens}

    real = ops.flash_attention
    caught = []

    def catch(q, k, v, **kw):
        out = real(q, k, v, **kw)
        caught.append((q, k, v, kw, out))
        return out

    ops.flash_attention = catch
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
    finally:
        ops.flash_attention = real
    log(f"lm main-path launches (one prefill, B=1 S={LM_SEQ}): "
        f"{json.dumps(launches)}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"prefill launched flash_attention {launches['flash_attention']} "
          f"times, expected {cfg.n_layers}")
    for name in TINY_KERNELS:
        check(launches[name] == 0, f"prefill launched {name}")
    check(logits.shape == (1, LM_SEQ, cfg.vocab)
          and logits.dtype == torch.float32, f"logits {logits.dtype} "
          f"{tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")

    worst = 0.0
    for i in (0, len(caught) - 1):
        q, k, v, kw, out = caught[i]
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = float((out.float() - want.float()).abs().max())
        worst = max(worst, err)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        log(f"kernel-check flash_attention layer {i} on its prefill inputs "
            f"{tuple(q.shape)} {q.dtype} (strides {q.stride()}): max err "
            f"{err:.3g} (tol 2e-2)")
        del want
    q0, k0, v0, kw0, _ = caught[0]
    case = flash_case("prefill layer 0", q0, k0, v0, kw0)
    case["launches"] = launches["flash_attention"]
    del caught, logits
    torch.cuda.empty_cache()

    prefill_ms = _host_ms(lambda: model.prefill(params, batch), 3)
    log(f"lm prefill {LM_CONFIG} bf16 B=1 S={LM_SEQ}: {prefill_ms:.3f} ms "
        f"(host clock, median of 3, synchronised)")
    decode = _decode_call(model, params, g)
    decode_ms = _host_ms(decode, 10)
    log(f"lm decode {LM_CONFIG} bf16 batch 4, cache 256: {decode_ms:.3f} ms "
        f"per step (host clock, median of 10, synchronised)")
    details = {"init_s": init_s, "n_params": n_params,
               "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
               "main_path_launches": launches}
    return launches, worst, case, details


def _decode_call(model, params, g):
    """One bf16 decode step of 4 slots at positions 17..200 of a 256-long
    cache, as a closure (the cache is updated in place each call)."""
    import torch

    cache = model.cache_init(4, 256, device="cuda")
    tok = torch.randint(0, model.cfg.vocab, (4, 1), generator=g,
                        device="cuda")
    cur = torch.tensor([17, 64, 100, 200], dtype=torch.int32, device="cuda")
    return lambda: model.decode_step(params, cache, tok, cur)


def phase_lm_profile():
    """Last, because the profiler's tracing slows every later launch: the
    full-width bf16 model again (same seed), one prefill and one decode
    step under ``torch.profiler``, then decode timed once more to show the
    tracing's after-effect. Returns the breakdowns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    model = Model(get_config(LM_CONFIG))
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params = model.init(g, device="cuda")
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (1, LM_SEQ),
                                     generator=g, device="cuda")}
    decode = _decode_call(model, params, g)
    model.prefill(params, batch)
    decode()
    out = {"prefill": _device_breakdown(lambda: model.prefill(params, batch)),
           "decode": _device_breakdown(decode)}
    out["decode_ms_after_profiling"] = _host_ms(decode, 10)
    for k in ("prefill", "decode"):
        log(f"lm profile {LM_CONFIG} bf16 {k}: {json.dumps(out[k])}")
    log(f"lm decode after profiling: {out['decode_ms_after_profiling']:.3f} "
        f"ms per step (host clock, median of 10, synchronised)")
    del params
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_lm_depth_cut():
    """llama3-8b at full width cut to 2 layers, float32, S 512, "chunked"
    (K6 per layer), TF32 off: logits on the card against the port on the
    CPU with the same weights, within 1e-4. Returns the max |diff|."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import map_tree

    cfg = dataclasses.replace(get_config(LM_CONFIG), n_layers=2,
                              attn_impl="chunked", dtype="float32")
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    params = model.init(g, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (1, 512), generator=g,
                           device="cuda")
    with full_fp32():
        before = ops.launches["flash_attention"]
        got = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        n_k6 = ops.launches["flash_attention"] - before
    check(n_k6 == cfg.n_layers, f"depth-cut prefill launched K6 {n_k6} "
                                f"times, expected {cfg.n_layers}")
    cpu_params = map_tree(lambda t: t.cpu(), params)
    del params
    want = model.prefill(cpu_params, {"tokens": tokens.cpu()})
    err = float((got.cpu() - want).abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    log(f"lm depth cut {LM_CONFIG} 2 layers float32 S=512 chunked: card "
        f"equals the CPU port within 1e-4 (max |diff| {err:.3g}, K6 "
        f"launched {n_k6} times)")
    del cpu_params, got, want
    torch.cuda.empty_cache()
    return err


def _greedy(model, params, prompt, n_new, max_len):
    """Sequential single-request greedy decode (the engine's ground truth,
    as ``tests/test_serving.py`` has it)."""
    import torch

    cache = model.cache_init(1, max_len, device="cuda")
    toks, out = list(prompt), []
    for t in range(len(prompt) + n_new - 1):
        tok = torch.tensor([[toks[t]]], dtype=torch.int32, device="cuda")
        logits, cache = model.decode_step(params, cache, tok, t)
        nxt = int(torch.argmax(logits[0, 0]))
        if t >= len(prompt) - 1:
            out.append(nxt)
            if len(out) >= n_new:
                break
            toks.append(nxt)
    return out


def phase_lm_serving():
    """``ServeEngine`` on full-width llama3-8b in float32 (TF32 off: cuBLAS
    reduces differently by batch rows, which in bf16 can flip an argmax
    between the batched and the sequential run): 4 slots, max_len 256, 8
    seeded requests of 8-32 prompt tokens and 8 new tokens. Every request
    finishes, with its own sequential greedy decode's tokens. Returns the
    engine's stats."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model
    from repro_torch.obs import timer
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(LM_CONFIG), dtype="float32")
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    params = model.init(g, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in rng.integers(8, 33, 8)]
    with full_fp32():
        eng = ServeEngine(model, params, n_slots=4, max_len=256,
                          device="cuda")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        t0 = timer.now()
        for r in reqs:
            eng.submit(r)
        steps = eng.run_until_drained()
        torch.cuda.synchronize()
        engine_s = timer.now() - t0
        stats = eng.stats()
        check(len(eng.finished) == len(reqs), f"{len(eng.finished)} of "
                                              f"{len(reqs)} requests finished")
        for r in reqs:
            want = _greedy(model, params, r.prompt, 8, 256)
            check(r.output == want, f"request {r.uid}: engine {r.output} != "
                                    f"sequential {want}")
    stats.update(steps=steps, engine_s=engine_s,
                 prompt_tokens=int(sum(len(p) for p in prompts)),
                 new_tokens=int(sum(len(r.output) for r in reqs)))
    log(f"lm serving {LM_CONFIG} float32, 4 slots: {len(reqs)} requests, "
        f"{stats['prompt_tokens']} prompt and {stats['new_tokens']} new "
        f"tokens in {steps} engine steps, {engine_s:.3f} s; "
        f"{stats['throughput_tok_s']:.3f} tokens/s (new tokens over the "
        f"span, host clock); every request equals its sequential greedy "
        f"decode")
    del eng, params
    torch.cuda.empty_cache()
    return stats



def kernels_line(rows, launches, worst):
    """One entry per kernel. ``launches`` is the counted main-path run of
    the kernel's path: one offline call of each of the four models in each
    of the two modes (K1-K3), one full-width llama3-8b prefill (K6); the
    times and the bound are summed over the same launches (each main-path
    case weighted by its launches in that run, which must add up to the
    count); ``max_abs_err`` is the kernel's own worst |kernel - plain|
    over every check."""
    out = []
    for name, (source, replaces) in REPLACES.items():
        mine = [r for r in rows if r["kernel"] == name]
        check(sum(r["launches"] for r in mine) == launches[name],
              f"{name}: timed cases cover {sum(r['launches'] for r in mine)}"
              f" launches of the {launches[name]} counted")
        total = lambda k: sum(r[k] * r["launches"] for r in mine)  # noqa
        nbytes, nops = total("bytes"), total("ops")
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": bound_by(nbytes, nops, PEAK_OPS_PER_S[name]),
            "library_ms": total("library_ms"),
        })
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.obs import timer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    try:
        t0 = timer.now()
        libs = _build.build_all()
        log(f"build: {len(libs)} kernels in {timer.now() - t0:.3f} s: "
            f"{[os.path.basename(str(p)) for p in libs]}")
        worst_syn = phase_kernels_synthetic()
        models = load_models()
        results, launches, per_run = phase_main_path(models)
        cases, worst_main = phase_main_path_checks(models, results)
        phase_goldens()
        bitwise = phase_streaming(models, results)
        rows, e2e = phase_times(cases, results, models)
        wide, worst_wide = phase_full_width()
        worst_flash = phase_flash_synthetic()
        lm_launches, worst_lm, k6_case, lm = phase_lm_prefill()
        k6_rows = [time_case(k6_case, reps=5, inner=10)]
        del k6_case
        lm["depth_cut_max_diff"] = phase_lm_depth_cut()
        lm["serving"] = phase_lm_serving()
        lm["profile"] = phase_lm_profile()
        log(f"lm summary ({smi}): prefill {lm['prefill_ms']:.3f} ms "
            f"(B=1, S={LM_SEQ}, bf16), decode {lm['decode_ms_per_step']:.3f}"
            f" ms per step (batch 4, bf16), engine "
            f"{lm['serving']['throughput_tok_s']:.3f} tokens/s (float32, "
            f"4 slots)")
        worst = {k: max(worst_syn[k], worst_main[k], worst_wide[k])
                 for k in TINY_KERNELS}
        worst["flash_attention"] = max(worst_lm, *worst_flash.values())
        launches = {**{k: launches[k] for k in TINY_KERNELS},
                    **{k: lm_launches[k] for k in LM_KERNELS}}
        line = kernels_line(rows + k6_rows, launches, worst)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError,
            TypeError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "chip_smoke_details.json"), "w") as f:
        json.dump({"card": smi, "per_shape": rows, "full_width": wide,
                   "e2e_offline_ms": e2e,
                   "launches_per_offline": per_run,
                   "main_path_launches": launches,
                   "streaming_logits_bit_for_bit": bitwise,
                   "flash_attention": {"max_err_by_dtype": worst_flash,
                                       "main_path_shape": k6_rows},
                   "lm": lm, "kernels": line},
                  f, indent=1)
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

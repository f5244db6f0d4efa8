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
               256-512-512 FC chain).

The last lines are the kernels JSON line, the card's name and power limit
(``nvidia-smi``), and ``{"ok": true, "device": {...}}``. Per-shape details
go to ``chiprun_out/chip_smoke_details.json``.
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
REPLACES = {
    "threshold_matmul": ("src/repro_torch/kernels/csrc/threshold_matmul.cu",
                         "src/repro/kernels/multi_threshold.py:163"),
    "conv_threshold": ("src/repro_torch/kernels/csrc/conv_threshold.cu",
                       "src/repro/kernels/conv_threshold.py:127"),
    "mlp_megakernel": ("src/repro_torch/kernels/csrc/mlp_megakernel.cu",
                       "src/repro/kernels/megakernel.py:81"),
}
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


def bound_ms(n_bytes, n_ops):
    """Least time for the work: bytes over HBM rate or int8 operations over
    the int8 peak, whichever is larger (published H100 SXM peaks)."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S) * 1e3


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
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the main path")
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
    row["bound_ms"] = bound_ms(c["bytes"], c["ops"])
    row["bound_by"] = ("bytes" if c["bytes"] / HBM_BYTES_PER_S
                       >= c["ops"] / INT8_OPS_PER_S else "operations")
    staged = ""
    if "staged" in c:
        row["staged_k1_ms"] = time_ms(c["staged"], reps=reps, inner=inner)
        staged = f", staged K1 {row['staged_k1_ms']:.6f} ms"
    log(f"time {row['kernel']} {row['model']}/{row['stage']} "
        f"{row['shape']}: kernel {row['ms']:.6f} ms, plain "
        f"{row['plain_ms']:.6f} ms, library (partial) "
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


def kernels_line(rows, launches, worst):
    """One entry per kernel. ``launches`` is the counted main-path run, one
    offline call of each of the four models in each of the two modes; the
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
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= nops / INT8_OPS_PER_S else "operations"),
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
        worst = {k: max(worst_syn[k], worst_main[k], worst_wide[k])
                 for k in REPLACES}
        line = kernels_line(rows, launches, worst)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError,
            TypeError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    with open(os.path.join(ROOT, "chiprun_out",
                           "chip_smoke_details.json"), "w") as f:
        json.dump({"card": smi, "per_shape": rows, "full_width": wide,
                   "e2e_offline_ms": e2e,
                   "launches_per_offline": per_run,
                   "main_path_launches": launches,
                   "streaming_logits_bit_for_bit": bitwise,
                   "kernels": line},
                  f, indent=1)
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

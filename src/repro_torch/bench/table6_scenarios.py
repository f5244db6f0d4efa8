"""Beyond-paper Table 6: the MLPerf Tiny LoadGen scenarios over the compiled
deployments, on the card.

    python -m repro_torch.bench.table6_scenarios [--device cuda]

The port of ``benchmarks/table6_scenarios.py``, whose sections, rows and
asserted equalities it keeps. MLPerf Tiny scores a submission under
LoadGen scenarios; this runs the sweep for the four Table-1 models at the
paper's full width (``bench.models``: numpy-seeded weights, since JAX's
PRNG cannot be reproduced), every one on the compiler path:

  * KWS and AD: ``export_qmlp`` graphs, all-dense fused threshold stages
    (K1, or one K3 launch a run where the planner admits it);
  * IC and CNV: ``export_qcnn`` graphs, direct conv threshold stages (K2;
    IC's scales calibrated on seeded codes, CNV's bipolar sign banks) and
    integer max-pool / flatten stages.

Per model:

  * **SingleStream and Offline**, energy from ``core.bops.schedule_cost``;
  * the unfused per-node interpreter (``cm.reference``, the "no compiler"
    baseline) beside the compiled Offline, with argmax parity on the same
    pool (8 rows for the conv models);
  * for IC and CNV, **direct against im2col** on the same Offline pool: the
    im2col lowering runs every conv stage on ``threshold_matmul`` (K1) over
    the patch matrix; both give the same tensor (``torch.equal``), and the
    two schedules' traffic bytes stand beside their throughputs;
  * **streaming**: the autotuned micro-batch, ``streaming_compiled``
    against the host queue loop ``streaming_host``, offline == host ==
    compiled bit for bit, both timed by ``deploy.autotune.probe_streaming``;
  * **ServerStreaming**: Poisson traffic through the router at 0.7 of the
    measured wave capacity, ``bit_exact_vs_offline`` asserted;
  * last, the multi-tenant ``TinyModelServer`` over all four models.

Everything lands in ``BENCH_torch_scenarios.json`` (``REPRO_BENCH_DIR``).
``REPRO_FAST=1`` cuts the query counts only; the widths stay the paper's.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench.common import (banner, emit_json, print_rows, require,
                                      row)
from repro_torch.bench.models import (AD_BITS, AD_DIMS, KWS_BITS, KWS_DIMS,
                                      cnv_graph, ic_graph, mlp_graph)
from repro_torch.core.bops import schedule_cost
from repro_torch.deploy import compile_graph
from repro_torch.deploy.autotune import (autotune_model, default_sample,
                                         probe_streaming)
from repro_torch.deploy.scenarios import offline, server_streaming, \
    single_stream
from repro_torch.obs import timer as obs_timer
from repro_torch.serve import measure_wave_service_s
from repro_torch.serving.engine import TinyModelServer

IN_SCALE = 1.0 / 127.0
FAST = os.environ.get("REPRO_FAST", "0") not in ("0", "")

#: The four models: name -> (graph builder of a seed, activation bits,
#: weight seed). The MLPs' graphs take ``IN_SCALE``; IC's and CNV's carry
#: their own ``meta["in_scale"]``.
MODELS = {
    "KWS-FINN": (lambda s: mlp_graph(KWS_DIMS, KWS_BITS, s, name="KWS-FINN"),
                 KWS_BITS, 1),
    "AD-hls4ml": (lambda s: mlp_graph(AD_DIMS, AD_BITS, s, name="AD-hls4ml"),
                  AD_BITS, 2),
    "IC-hls4ml": (ic_graph, 8, 3),
    "IC-FINN-CNV": (cnv_graph, 1, 4),
}
MLP_MODELS = ("KWS-FINN", "AD-hls4ml")

Entry = Tuple[object, Callable[[int], np.ndarray], int]


def _compile_mlp(name: str, seed: Optional[int] = None, device=None):
    """A full-width MLP (``MLP_MODELS``) compiled on ``device`` (None: the
    card)."""
    build, _, default_seed = MODELS[name]
    graph = build(default_seed if seed is None else seed)
    return compile_graph(graph, in_scale=IN_SCALE, device=device)


def _compile_conv(name: str, seed: Optional[int] = None, device=None,
                  conv_lowering: Optional[str] = None):
    """A full-width conv model (IC or CNV) compiled on ``device``
    under ``conv_lowering`` (None: the direct kernel)."""
    build, _, default_seed = MODELS[name]
    graph = build(default_seed if seed is None else seed)
    return compile_graph(graph, in_scale=graph.meta["in_scale"],
                         device=device, conv_lowering=conv_lowering)


def query_maker(cm, rng: np.random.Generator) -> Callable[[int], np.ndarray]:
    """Seeded input codes in [-127, 127] of one unbatched sample of ``cm``'s
    input shape, a fresh draw each call (the reference's ``mk``)."""
    shape = tuple(default_sample(cm, 1).shape[1:])
    return lambda i: rng.integers(-127, 128, shape).astype(np.int32)


def build_entries(names=tuple(MODELS), device=None, seed: int = 0
                  ) -> Dict[str, Entry]:
    """name -> (compiled model, query maker, bits) for ``names`` at full
    width on ``device``; one numpy generator of ``seed`` draws every
    query."""
    rng = np.random.default_rng(seed)
    entries = {}
    for name in names:
        cm = (_compile_mlp(name, device=device) if name in MLP_MODELS
              else _compile_conv(name, device=device))
        entries[name] = (cm, query_maker(cm, rng), MODELS[name][1])
    return entries


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_offline(fn, xb: torch.Tensor, iters: int = 5) -> float:
    """Median queries per second of ``fn`` over the batch ``xb``: one warm
    call, then ``iters`` calls, each between two device synchronises."""
    fn(xb)
    times = []
    for _ in range(max(iters, 1)):
        _sync(xb.device)
        t0 = obs_timer.now()
        fn(xb)
        _sync(xb.device)
        times.append(obs_timer.now() - t0)
    times.sort()
    return xb.shape[0] / times[len(times) // 2]


def _batch(cm, mk, n: int) -> torch.Tensor:
    return torch.as_tensor(np.stack([mk(i) for i in range(n)]),
                           device=cm.device)


def run_entries(entries: Dict[str, Entry], fast: bool = FAST,
                tune_dir: Optional[str] = None) -> Tuple[list, dict]:
    """Every section of the table over ``entries``; returns the printable
    rows and the artifact's payload. The autotuner caches its configs in
    ``tune_dir`` (None: ``REPRO_AUTOTUNE_CACHE``)."""
    rows = []
    doc = {"rows": [], "streaming": [], "tuned": {}, "fast": fast}
    for name, (cm, mk, bits) in entries.items():
        conv = cm.schedule.n_fused_conv > 0
        cost = schedule_cost(cm.schedule.stages)
        n_off = (16 if conv else 64) if fast else (48 if conv else 256)
        n_ss = (8 if conv else 16) if fast else (16 if conv else 48)

        ss = single_stream(cm.offline, mk, n_queries=n_ss,
                           model_cost=cost, bits=bits)
        off = offline(cm.offline, mk, n_samples=n_off,
                      model_cost=cost, bits=bits, compiled=cm)

        # the unfused per-node baseline and parity on the same pool
        n_ref = min(n_off, 8 if conv else n_off)   # the interpreter is slow
        xb = _batch(cm, mk, n_ref)
        ref_qps = _time_offline(cm.reference, xb, iters=1)
        y_c = cm.offline(xb).cpu().numpy()
        y_r = cm.reference(xb).cpu().numpy()
        parity = float((np.argmax(y_c, -1) == np.argmax(y_r, -1)).mean())
        speedup = off.throughput_qps / max(ref_qps, 1e-9)

        rows.append(row(
            f"table6/{name}/SingleStream", ss.p50_ms * 1e3,
            p50_ms=f"{ss.p50_ms:.3f}", p99_ms=f"{ss.p99_ms:.3f}",
            roofline_uJ=f"{ss.energy_proxy_uJ:.2f}"))
        rows.append(row(
            f"table6/{name}/Offline", 0.0,
            compiled_qps=f"{off.throughput_qps:.0f}",
            unfused_ref_qps=f"{ref_qps:.0f}",
            compiled_speedup=f"{speedup:.1f}x",
            fused_stages=cm.schedule.n_fused,
            fused_conv=cm.schedule.n_fused_conv,
            argmax_parity=parity,
            beats_reference=speedup > 1.0))
        doc["rows"].append(
            {"model": name, "single_stream": ss.row(), "offline": off.row(),
             "unfused_ref_qps": ref_qps, "compiled_speedup": speedup,
             "argmax_parity": parity, "fused_stages": cm.schedule.n_fused,
             "fused_conv": cm.schedule.n_fused_conv})
        if off.stage_ms:
            top = sorted(off.stage_ms, key=lambda s: -s["ms"])[:3]
            print(f"stage_ms[{name}]: " + " ".join(
                f"{s['stage']}={s['ms']:.3f}ms" for s in top), flush=True)

        # direct conv against the im2col lowering: same graph, same pool
        if conv:
            cm_i2c = compile_graph(cm.graph,
                                   in_scale=cm.graph.meta["in_scale"],
                                   device=cm.device, conv_lowering="im2col")
            xb_cmp = _batch(cm, mk, n_off)
            # one pass each: the equality doubles as the warm-up
            require(torch.equal(cm.offline(xb_cmp), cm_i2c.offline(xb_cmp)),
                    f"{name}: direct and im2col lowerings differ")
            qps_direct = _time_offline(cm.offline, xb_cmp)
            qps_i2c = _time_offline(cm_i2c.offline, xb_cmp)
            t_direct = cost.traffic_bytes
            t_i2c = schedule_cost(cm_i2c.schedule.stages).traffic_bytes
            rows.append(row(
                f"table6/{name}/Offline/conv_lowering", 0.0,
                fused_qps=f"{qps_direct:.0f}",
                im2col_qps=f"{qps_i2c:.0f}",
                fused_speedup=f"{qps_direct / max(qps_i2c, 1e-9):.2f}x",
                fused_traffic_B=f"{t_direct:.0f}",
                im2col_traffic_B=f"{t_i2c:.0f}",
                im2col_bytes_saved=f"{1 - t_direct / t_i2c:.0%}",
                beats_im2col=qps_direct > qps_i2c))
            doc["rows"][-1]["conv_lowering"] = {
                "fused_qps": qps_direct, "im2col_qps": qps_i2c,
                "fused_traffic_bytes": t_direct,
                "im2col_traffic_bytes": t_i2c,
                "beats_im2col": bool(qps_direct > qps_i2c),
                "bit_exact": True}

    # -- streaming: the tuned micro-batch, segment waves against the host
    #    queue loop, offline == host == compiled asserted ----------------
    stream_rows = []
    for name, (cm, mk, _) in entries.items():
        conv = cm.schedule.n_fused_conv > 0
        n = (8 if conv else 16) if fast else (16 if conv else 32)
        cfg = autotune_model(cm, batch=n, directory=tune_dir)
        cm.apply_tuned(cfg)
        doc["tuned"][name] = cfg.to_dict()
        xb = _batch(cm, mk, n)
        y_off = cm.offline(xb)
        y_cmp, st_c = cm.streaming_compiled(xb)          # tuned micro-batch
        y_host, st_h = cm.streaming_host(xb, micro_batch=st_c.micro_batch)
        require(torch.equal(y_cmp, y_off),
                f"{name}: streaming_compiled differs from offline")
        require(torch.equal(y_host, y_off),
                f"{name}: streaming_host differs from offline")
        t_cmp = probe_streaming(cm, xb, st_c.micro_batch, iters=5)
        t_host = probe_streaming(cm, xb, st_c.micro_batch, iters=5,
                                 runner=cm.streaming_host)
        speed = t_host / max(t_cmp, 1e-9)
        stream_rows.append(row(
            f"table6/{name}/Streaming", t_cmp * 1e6 / n,
            compiled_ms=f"{t_cmp * 1e3:.2f}",
            host_ms=f"{t_host * 1e3:.2f}",
            compiled_vs_host=f"{speed:.2f}x",
            tuned_micro_batch=st_c.micro_batch,
            tuned_block_h=cfg.block_h or "-",
            modeled_cycles=cfg.modeled_cycles,
            modeled_traffic_B=f"{cfg.modeled_traffic_bytes:.0f}",
            fifo_depths=str(st_h.fifo_depths),
            segments=str(st_c.segments),
            bit_exact=True))
        print(f"streaming[{name}]: mb={st_c.micro_batch} "
              f"block_h={cfg.block_h} fifo_depths={st_h.fifo_depths} "
              f"max_occupancy={st_h.max_occupancy} "
              f"sim_cycles={st_h.sim_cycles} "
              f"compiled_vs_host={speed:.2f}x matches_offline=True",
              flush=True)
        doc["streaming"].append({
            "model": name, "micro_batch": st_c.micro_batch,
            "block_h": cfg.block_h,
            "block_mn": cfg.block_mn,
            "compiled_ms": t_cmp * 1e3, "host_ms": t_host * 1e3,
            "compiled_vs_host_speedup": speed,
            "modeled_cycles": cfg.modeled_cycles,
            "modeled_traffic_bytes": cfg.modeled_traffic_bytes,
            "fifo_depths": st_h.fifo_depths,
            "max_occupancy": st_h.max_occupancy,
            "segments": st_c.segments,
            "megakernel": st_c.megakernel,
            "bit_exact_vs_offline": True})

        # ServerStreaming: Poisson traffic through the dynamic batcher at
        # 0.7 of the measured wave capacity, served by the same segment
        # programs, bit-exactness asserted padding included
        svc_s = measure_wave_service_s(cm, st_c.micro_batch, iters=3)
        sr = server_streaming(
            cm, mk, qps=0.7 * st_c.micro_batch / svc_s,
            n_queries=16 if fast else 48,
            max_wait_ms=max(2.0, 1.5 * svc_s * 1e3))
        require(sr.extras["bit_exact_vs_offline"],
                f"{name}: ServerStreaming results differ from offline")
        stream_rows.append(row(
            f"table6/{name}/ServerStreaming", sr.p99_ms * 1e3,
            p50_ms=f"{sr.p50_ms:.3f}", p99_ms=f"{sr.p99_ms:.3f}",
            qps=f"{sr.throughput_qps:.0f}",
            offered_qps=f"{sr.extras['offered_qps']:.0f}",
            micro_batch=sr.extras["micro_batch"],
            wave_occupancy=f"{sr.extras['wave_occupancy']:.2f}",
            bit_exact=sr.extras["bit_exact_vs_offline"]))
        doc["streaming"][-1]["server_streaming"] = sr.row()
        doc["streaming"][-1]["wave_service_ms"] = svc_s * 1e3
    rows += stream_rows
    print_rows(rows)

    # -- multi-tenant: every model behind one queue ------------------------
    server = TinyModelServer({n: e[0] for n, e in entries.items()},
                             max_batch=16)
    for i in range(32 if fast else 96):
        name = list(entries)[i % len(entries)]
        server.submit(name, entries[name][1](i))
    server.run_until_drained()
    st = server.stats()
    agg = st.pop("_aggregate")
    tenants = " ".join(
        f"{n}:p99={v['p99_ms']:.1f}ms occ={v['wave_occupancy']:.2f}"
        for n, v in st.items())
    print(f"multitenant: {agg['n']} reqs {agg['throughput_qps']:.0f} qps "
          f"(compiled wave path)  {tenants}", flush=True)
    doc["multitenant"] = {"n": agg["n"],
                          "throughput_qps": agg["throughput_qps"],
                          "tenants": st}
    return rows, doc


def run(device=None):
    banner("Table 6: MLPerf-Tiny scenarios over compiled deployments")
    rows, doc = run_entries(build_entries(device=device))
    emit_json("BENCH_torch_scenarios.json", doc)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()

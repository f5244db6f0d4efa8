"""Serving launcher: the continuous-batching LM engine, and the tiny-model
stack behind ``--stack tiny`` — a Table-1 model at full width served
through the ``repro_torch.serve`` router with a replica pool and a
selectable dispatch engine. The port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --stack tiny --tiny-model kws \
        --replicas 2 --engine async --requests 256

    python -m repro_torch.launch.serve --arch internlm2-1.8b --reduced \
        --requests 16

Everything runs on the card unless ``--device cpu`` is given; asking for
the card without one raises. The tiny models' weights come from
``numpy.random.default_rng(--seed)`` (``repro_torch.bench.models``), the
LM's from a seeded ``torch.Generator``: JAX's PRNG is not reproduced.
``--arch`` takes every configuration; the engine feeds token ids, so the
backbones that take embeddings (qwen2-vl, hubert) are refused, hubert as
encoder-only. ``--quant-bits`` below 16 serves the int8 path
(``Model.quantize_params``: ``bits``-bit weight codes held in int8,
int8 activations, every linear on K5), as the reference does.

    python -m repro_torch.launch.serve --quant-bits 8 --device cpu
"""

import argparse
import logging

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.qir import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import timer as obs_timer
from repro_torch.serving.engine import Request, ServeEngine

logging.basicConfig(level=logging.INFO, format="%(message)s")
log = logging.getLogger("repro_torch.launch.serve")


def _run_tiny(args):
    """Compile one full-width tiny model on ``--device``, spread it over
    ``--replicas`` pool slots sharing the one executor (on the card, one
    CUDA stream per slot), and drive a Poisson trace through the router
    under the chosen engine."""
    from repro_torch.bench.models import (AD_BITS, AD_DIMS, KWS_BITS,
                                          KWS_DIMS, mlp_graph)
    from repro_torch.deploy import compile_graph
    from repro_torch.deploy.autotune import autotune_model
    from repro_torch.serve import (
        AsyncEngine,
        ReplicaPool,
        Router,
        RouterConfig,
        ServiceModel,
        SyncEngine,
        measure_wave_service_s,
        poisson_trace,
    )

    dims, bits = ((KWS_DIMS, KWS_BITS) if args.tiny_model == "kws"
                  else (AD_DIMS, AD_BITS))
    dim = dims[0]
    graph = mlp_graph(dims, bits, args.seed, name=args.tiny_model)
    cm = compile_graph(graph, in_scale=1.0 / 127.0, device=args.device)
    if args.autotune != "off":
        cm.apply_tuned(autotune_model(cm, batch=32, mode=args.autotune))
    mb = cm.default_micro_batch
    if args.autotune == "model":
        # cold-start path: no wall-clock reads before the first request —
        # the learned predictor prices admission from wave 0 and the
        # router's EWMA corrects it online
        from repro_torch.costmodel import load_default
        from repro_torch.serve import PredictedServiceModel

        service = PredictedServiceModel.from_predictor(load_default(), cm)
    else:
        service = ServiceModel.from_compiled(
            cm, probe_batch=mb).recalibrated(
                measure_wave_service_s(cm, mb), mb)
    engine = AsyncEngine() if args.engine == "async" else SyncEngine()

    # every replica slot shares the one compiled executor: submit_wave is
    # stateless, so N slots are N streams of the one card (N logical
    # replicas on the CPU)
    pool = ReplicaPool(factory=lambda: cm, devices=[cm.device] * args.replicas)
    pool.warm(np.zeros((1, dim), np.int32), micro_batch=mb)
    router = Router({args.tiny_model: pool},
                    RouterConfig(micro_batch=mb),
                    service_models={args.tiny_model: service},
                    engine=engine)
    rng = np.random.default_rng(args.seed)
    qps = args.qps or 0.5 * args.replicas * service.saturation_qps(mb)
    trace = poisson_trace(qps=qps, n=args.requests, seed=args.seed)
    t0 = obs_timer.now()
    reqs = router.run_trace(
        args.tiny_model, trace,
        lambda i: rng.integers(-127, 128, (dim,)).astype(np.int32))
    dt = obs_timer.now() - t0
    served = [r for r in reqs if not r.shed]
    lats_ms = np.asarray([r.latency_s for r in served]) * 1e3
    snap = router.stats()[args.tiny_model]["metrics"]
    log.info("tiny stack: %s x%d replicas on %s, %s engine, wave=%d",
             args.tiny_model, args.replicas, cm.device, args.engine, mb)
    log.info("offered %.0f qps | served %d/%d in %.2fs (%.0f qps)",
             qps, len(served), len(reqs), dt, len(served) / max(dt, 1e-9))
    log.info("p50 %.2f ms | p99 %.2f ms | wave p50 %.2f ms | occupancy %.2f",
             float(np.percentile(lats_ms, 50)),
             float(np.percentile(lats_ms, 99)),
             snap.wave_service_p50_ms, snap.mean_occupancy)
    return {"served": len(served), "n": len(reqs),
            "p99_ms": float(np.percentile(lats_ms, 99)),
            "throughput_qps": len(served) / max(dt, 1e-9),
            "micro_batch": mb, "replicas": args.replicas,
            "device": str(cm.device), "requests": reqs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stack", choices=("lm", "tiny"), default="lm",
                    help="lm: continuous-batching ServeEngine; tiny: "
                         "compiled Table-1 model through the serve router")
    ap.add_argument("--tiny-model", choices=("kws", "ad"), default="kws")
    ap.add_argument("--autotune", choices=("off", "probe", "model"),
                    default="probe",
                    help="tiny stack tuning: probe = measured search, "
                         "model = probe-free learned cost model (cold-"
                         "start admission priced by the predictor), "
                         "off = compiled defaults")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--engine", choices=("sync", "async"), default="sync")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="offered load; 0 = half the pool's saturation")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--quant-bits", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.stack == "tiny":
        return _run_tiny(args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")

    device = resolve_device(args.device)
    model = Model(cfg)
    with torch.inference_mode():
        params = model.init(
            torch.Generator(device=device).manual_seed(args.seed),
            device=device)
        if args.quant_bits < 16:
            params = model.quantize_params(params, bits=args.quant_bits)
            log.info("deployment quantization: int%d weights",
                     args.quant_bits)
    eng = ServeEngine(model, params, n_slots=args.slots, max_len=args.max_len,
                      device=device)
    rng = np.random.default_rng(args.seed)
    t0 = obs_timer.now()
    for i in range(args.requests):
        plen = int(rng.integers(3, 12))
        eng.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=args.max_new))
    steps = eng.run_until_drained()
    dt = obs_timer.now() - t0

    s = eng.stats()
    log.info("drained %d requests in %d steps / %.2fs", s["n_requests"],
             steps, dt)
    log.info("TTFT %.1f ms | latency %.1f ms | %.1f tok/s",
             s["mean_ttft_s"] * 1e3, s["mean_latency_s"] * 1e3,
             s["throughput_tok_s"])
    return s


if __name__ == "__main__":
    main()

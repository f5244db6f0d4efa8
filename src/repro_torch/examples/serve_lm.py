"""Batched serving example: the continuous-batching engine over a reduced
LM, with the paper's deployment quantization (int8 weights) switchable.

The port of ``examples/serve_lm.py``: the same flags and printout, plus
``--device`` (the card unless ``cpu`` is given). With ``--quant`` every
linear runs on K5 (``kernels.ops.qmatmul``). Weights come from a
``torch.Generator`` seeded with 0 (JAX's PRNG is not reproduced).

Run: PYTHONPATH=src python -m repro_torch.examples.serve_lm [--quant]
     [--requests 8] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.qir import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import timer as obs_timer
from repro_torch.serving.engine import Request, ServeEngine


def serve(model, params, *, requests=8, slots=4, max_new=12, max_len=64,
          device=None):
    """The example's loop: ``requests`` seeded prompts of 3-9 tokens
    through a ``slots``-slot engine until it drains. Returns (engine,
    engine steps, wall seconds)."""
    eng = ServeEngine(model, params, n_slots=slots, max_len=max_len,
                      device=device)
    rng = np.random.default_rng(0)
    t0 = obs_timer.now()
    for i in range(requests):
        plen = int(rng.integers(3, 10))
        eng.submit(Request(
            uid=i, prompt=rng.integers(0, model.cfg.vocab, plen).astype(
                np.int32),
            max_new_tokens=max_new))
    steps = eng.run_until_drained()
    return eng, steps, obs_timer.now() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--quant", action="store_true",
                    help="serve int8-quantized weights (paper C1 deployment)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Model(cfg)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device=device)
        if args.quant:
            params = model.quantize_params(params, bits=8)
            print("serving int8-quantized weights")

    eng, steps, dt = serve(model, params, requests=args.requests,
                           slots=args.slots, max_new=args.max_new,
                           device=device)
    s = eng.stats()
    print(f"drained {s['n_requests']} requests in {steps} engine steps, "
          f"{dt:.2f}s wall")
    print(f"mean TTFT {s['mean_ttft_s']*1e3:.1f} ms | mean latency "
          f"{s['mean_latency_s']*1e3:.1f} ms | throughput "
          f"{s['throughput_tok_s']:.1f} tok/s")
    for r in eng.finished[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.output}")
    return s


if __name__ == "__main__":
    main()

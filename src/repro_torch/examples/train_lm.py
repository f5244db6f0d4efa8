"""End-to-end LM training example: a llama3-family model trained for a few
hundred steps on the synthetic token stream, with the full stack — the
prefetching data pipeline, the fault-tolerant loop, atomic checkpoints,
QAT weight fake-quant optional.

The port of ``examples/train_lm.py``. ``--preset cpu`` (the default) is
small enough to run 200 steps in minutes (8-bit QAT on); ``--preset 100m``
builds the ~100M-parameter config. Runs on the card unless ``--device
cpu`` is given.

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
     [--preset cpu] [--device cpu]
     # kill it mid-run and re-run: it resumes from the last checkpoint.
"""

import argparse
import dataclasses
import logging
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.qir import resolve_device
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.obs import timer as obs_timer
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.steps import TrainState, make_train_step

logging.basicConfig(level=logging.INFO, format="%(message)s")


def build_cfg(preset: str):
    base = get_config("llama3-8b")
    if preset == "100m":
        # ~100M params: 12L x 512d x 8H, 16k vocab
        return dataclasses.replace(
            base, name="llama3-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=4, d_ff=1792, vocab=16384, head_dim=64,
            dtype="float32", remat="none")
    # cpu preset: small enough to run 200 steps in minutes
    return dataclasses.replace(
        base, name="llama3-cpu", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=2048, head_dim=32,
        dtype="float32", remat="none", weight_bits=8)   # QAT on


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--preset", choices=["cpu", "100m"], default="cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = build_cfg(args.preset)
    model = Model(cfg)
    print(f"arch={cfg.name}  params={cfg.n_params()/1e6:.1f}M  "
          f"weight_bits={cfg.weight_bits} "
          f"(QAT {'on' if cfg.weight_bits < 16 else 'off'})  device={device}")

    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    opt = make_optimizer(base_lr=3e-4, warmup=20, total=args.steps)
    state = TrainState(params=params, opt=opt.init(params))
    train_step = make_train_step(model, opt, microbatches=args.microbatches)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq)

    with DataPipeline(lambda s: data.batch(s, args.batch)) as pipe:
        it = iter(pipe)

        def batch_fn(step):
            # the pipeline is keyed by step; keep it aligned on resume
            while True:
                s, b = next(it)
                if s >= step:
                    return b

        lcfg = LoopConfig(total_steps=args.steps, ckpt_every=50,
                          ckpt_dir=args.ckpt_dir, log_every=10)
        t0 = obs_timer.now()
        res = run_training(train_step, state, batch_fn, lcfg)
        dt = obs_timer.now() - t0

    first = (res.metrics_history[0]["loss"] if res.metrics_history
             else float("nan"))
    last = (res.metrics_history[-1]["loss"] if res.metrics_history
            else float("nan"))
    toks = args.batch * args.seq * (res.final_step - (res.resumed_from or 0))
    print(f"\ndone: steps={res.final_step} resumed_from={res.resumed_from} "
          f"loss {first:.3f} -> {last:.3f}")
    print(f"throughput: {toks/dt:.0f} tok/s on {device}")
    if not last < first:
        raise RuntimeError(f"loss did not decrease: {first} -> {last}")
    return res


if __name__ == "__main__":
    main()

"""Fault-tolerance demo: a training run whose device turns slow mid-flight.

The port of ``examples/elastic_restart.py``, on one device:
  1. train, checkpointing every N steps,
  2. a persistent straggler trips the watchdog -> ElasticRestart (the loop
     checkpoints first),
  3. the launcher builds the state again, restores the checkpoint and
     resumes to completion — with the loss curve continuing where it left
     off. (With one card the restart lands on the same device; the
     reference rebuilds a smaller mesh from the surviving devices.)

The slow device is simulated by a fake clock (``time_fn``).

Run: PYTHONPATH=src python -m repro_torch.examples.elastic_restart
     [--device cpu]
"""

import argparse
import logging
import os
import shutil
import tempfile

import torch

from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.core.qir import resolve_device
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.obs import timer as obs_timer
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train.loop import ElasticRestart, LoopConfig, run_training
from repro_torch.train.steps import TrainState, make_train_step

logging.basicConfig(level=logging.WARNING)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_elastic_demo"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = get_config("internlm2-1.8b").reduced()
    model = Model(cfg)
    opt = make_optimizer(base_lr=1e-3, warmup=5, total=60)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=32)

    def batch_fn(step):
        return data.batch(step, 4)

    def fresh_state():
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device=device)
        return TrainState(params=params, opt=opt.init(params))

    step_fn = make_train_step(model, opt)

    # --- phase 1: healthy training until a straggler develops ----------
    clock = {"t": 0.0}

    def time_fn():
        return clock["t"]

    def degrade(step):                      # device goes slow at step 25
        clock["t"] += 10.0 if step >= 25 else 1.0

    lcfg = LoopConfig(total_steps=60, ckpt_every=10, ckpt_dir=args.ckpt_dir,
                      log_every=20, slow_factor=3.0, max_consecutive_slow=4,
                      watchdog_warmup=10)
    print(f"[1] training on {device} ...")
    try:
        run_training(step_fn, fresh_state(), batch_fn, lcfg,
                     step_hook=degrade, time_fn=time_fn)
        raise SystemExit("expected an ElasticRestart")
    except ElasticRestart as e:
        ckpt_at = latest_step(args.ckpt_dir)
        print(f"[2] watchdog fired: {e}")
        print(f"    emergency checkpoint at step {ckpt_at}")

    # --- phase 2: build the state again and resume ---------------------
    print("[3] restarting and resuming from the checkpoint ...")
    t0 = obs_timer.now()
    res = run_training(step_fn, fresh_state(), batch_fn, lcfg)
    print(f"[4] resumed from step {res.resumed_from}, finished at "
          f"{res.final_step} in {obs_timer.now() - t0:.1f}s wall")
    hist = res.metrics_history
    print(f"    loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"(continuing the pre-failure curve)")
    if res.resumed_from is None or res.final_step != 60:
        raise RuntimeError(f"resume failed: {res}")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    return res


if __name__ == "__main__":
    main()

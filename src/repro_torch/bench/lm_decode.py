"""Host time of one LM decode step, by the kind of tensor the parameters
are: ordinary tensors (what ``Model.init`` returns and training needs)
against inference tensors (``Model.init`` called under
``torch.inference_mode()``, as the serving callers do).

    python -m repro_torch.bench.lm_decode                # llama3-8b, bf16, the card
    python -m repro_torch.bench.lm_decode --reduced --device cpu --rounds 1

The decode case is ``chip_smoke.py``'s: the full-width model in its own
dtype from a seed, 4 slots of a 256-long cache at positions 17, 64, 100
and 200. Both kinds are copies of one init and are held at once. Each
round times ``--steps`` synchronised steps of each kind on the host clock
after ``WARM`` untimed ones; the order of the two kinds alternates from
round to round. The script prints each round's medians, then one JSON
line with the card's name and power limit, every round's median and the
median of them for each kind.

Decode is host-bound on the card (most of a step is Python and launch
overhead), so a per-op host cost shows in the step time: a view of an
ordinary tensor carries view metadata that a view of an inference tensor
does not. The script reads only what the port's decode path has had from
its start, so it also runs against an older checkout's package
(``PYTHONPATH=<checkout>/src python src/repro_torch/bench/lm_decode.py``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Dict, List

import torch

from repro_torch.configs import get_config
from repro_torch.core.qir import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import timer

SEED = 5
WARM = 5
CACHE_LEN = 256
POSITIONS = (17, 64, 100, 200)


def copy_params(tree, inference: bool):
    """A copy of a dict tree of tensors: inference tensors if
    ``inference``, else ordinary ones, whatever the source's kind."""
    if isinstance(tree, dict):
        return {k: copy_params(v, inference) for k, v in tree.items()}
    with torch.no_grad(), torch.inference_mode(inference):
        return tree.clone()


def _kinds(tree) -> set:
    """``is_inference()`` of every leaf, as a set."""
    if isinstance(tree, dict):
        return set().union(*(_kinds(v) for v in tree.values()))
    return {tree.is_inference()}


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_ms(fn, steps: int, device: torch.device) -> float:
    """Median host milliseconds of ``steps`` synchronised calls of ``fn``
    after ``WARM`` untimed ones."""
    for _ in range(WARM):
        fn()
    _sync(device)
    vals: List[float] = []
    for _ in range(steps):
        t0 = timer.now()
        fn()
        _sync(device)
        vals.append((timer.now() - t0) * 1e3)
    return statistics.median(vals)


def run(arch: str, reduced: bool, device: str, rounds: int,
        steps: int) -> Dict[str, object]:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    dev = resolve_device(device)
    model = Model(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED)
    base = model.init(g, device=dev)
    params = {"ordinary": copy_params(base, False),
              "inference": copy_params(base, True)}
    del base
    for kind, tree in params.items():
        if _kinds(tree) != {kind == "inference"}:
            raise RuntimeError(f"the {kind} copy holds the wrong kind")
    cache = model.cache_init(len(POSITIONS), CACHE_LEN, device=dev)
    tok = torch.randint(0, cfg.vocab, (len(POSITIONS), 1), generator=g,
                        device=dev)
    cur = torch.tensor(POSITIONS, dtype=torch.int32, device=dev)
    out: Dict[str, List[float]] = {"ordinary": [], "inference": []}
    for r in range(rounds):
        order = ("ordinary", "inference") if r % 2 == 0 else (
            "inference", "ordinary")
        for kind in order:
            p = params[kind]
            ms = step_ms(lambda: model.decode_step(p, cache, tok, cur),
                         steps, dev)
            out[kind].append(ms)
            print(f"round {r} {kind}: {ms:.6f} ms per decode step "
                  f"(median of {steps})", flush=True)
    return {"arch": arch, "reduced": reduced, "dtype": cfg.dtype,
            "batch": len(POSITIONS), "cache_len": CACHE_LEN,
            "steps_per_round": steps, "card": card(),
            "ordinary_ms": out["ordinary"],
            "inference_ms": out["inference"],
            "ordinary_median_ms": statistics.median(out["ordinary"]),
            "inference_median_ms": statistics.median(out["inference"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    res = run(args.arch, args.reduced, args.device, args.rounds, args.steps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

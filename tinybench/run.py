"""The benchmark's command: one run of one cell on this machine's card.

    python3 tinybench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It measures the PyTorch and CUDA port
(``src/repro_torch``) and nothing else: it exits with an error, and prints
no result, when there is no CUDA device, when the checkout has no port,
or when JAX or the JAX package is loaded once the window has closed. The
last line of standard output is the result (one JSON object); the
numbers the check compared, each beside its limit, are the last lines of
standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)

#: Top-level module names the run may not hold, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = os.path.join(CHECKOUT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"no port under {src}: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    # the benchmark's modules are imported as ``tinybench.*``: the script's
    # own folder leaves the path, so that none of them shadows a library's
    sys.path[:] = [CHECKOUT, src] + [p for p in sys.path if p and
                                     os.path.abspath(p) != HERE]
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from tinybench import harness, layout

    chips = int(layout.cell(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

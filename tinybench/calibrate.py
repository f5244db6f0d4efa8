"""Readings that the limits of the check are set from, on the card.

    python3 tinybench/calibrate.py --workload <cell> --seconds 2 \\
        --seeds 11,12,... --control-seeds 21,22,23 [--out FILE]

In one process: for each seed of ``--seeds`` a run of the cell at its own
size and load (``harness.run_cell``, a short window) and its compared
numbers (the lower readings); for each seed of ``--control-seeds`` the
same run with the plain reference in ``int4`` (and, where the
configuration states a float32 head, ``bf16_head``) in the program's place
(the upper readings). Writes one JSON object of readings to ``--out``.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--controls", default="int4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:] = [CHECKOUT, os.path.join(CHECKOUT, "src")] + [
        p for p in sys.path if p and os.path.abspath(p) != HERE]
    import torch

    from tinybench import harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    out = {"workload": args.workload, "kind": torch.cuda.get_device_name(0),
           "program": {}, "control": {}}
    for s in [int(v) for v in args.seeds.split(",")]:
        r = harness.run_cell(args.workload, s, args.seconds, False)
        out["program"][s] = {k: c["value"] for k, c in r["checks"].items()}
        print(f"program seed {s}: {out['program'][s]} correct "
              f"{r['correct']}", file=sys.stderr, flush=True)
    for prec in args.controls.split(","):
        out["control"][prec] = {}
        for s in [int(v) for v in args.control_seeds.split(",")]:
            r = harness.run_cell(args.workload, s, args.seconds, False,
                                 control=prec)
            out["control"][prec][s] = {k: c["value"]
                                       for k, c in r["checks"].items()}
            print(f"control {prec} seed {s}: {out['control'][prec][s]} "
                  f"correct {r['correct']}", file=sys.stderr, flush=True)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

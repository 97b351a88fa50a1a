"""Read the control, or the float64 witness, of a cell on this machine's
card.

    python3 benchmark/control.py --workload crowd-instances-orbit \
        --seeds 11 12 13 [--witness]

Prints one JSON line per seed: the TF32 (with ``--witness`` the float64)
reference's readings against the float32 reference (rbench/control.py),
the largest of each number and whether a run would come out correct (the
control must not).
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--witness", action="store_true")
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from rbench import check
    from rbench.control import readings

    if not torch.cuda.is_available():
        print("no card: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(args.workload, seed, "cuda", root=ROOT,
                     witness=args.witness)
        correct, checks = check.judge(r)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "witness": args.witness,
                          "correct": correct, "readings": r,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

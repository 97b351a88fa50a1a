"""Time chosen kernel cases of chip_smoke.py's phase 3 on one CUDA card, at
the flagship frame's shapes: each case's wrapper (CUDA events, median of 5
after a warm-up) and its kernels alone (a profile), in ``--rounds`` rounds.

    python3 kernel_times.py lines tidpass [--root DIR] [--rounds 3]

Cases are the keys of ``chip_smoke.kernel_inputs`` (``visibility``,
``lines``, ``tidpass``, ...). ``--root`` imports chip_smoke.py and
tpu_renderer_torch from another checkout, e.g. a parent commit unpacked
with ``git archive``, so that two trees are compared inside one run on
the same card: run parent, change, change, parent. Prints the card's
``name, power.limit``, then one JSON line per case and round.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="+")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--rounds", type=int, default=3)
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    import chip_smoke as cs
    import tpu_renderer_torch as tr
    from tpu_renderer_torch.ops import raster_cuda as rc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    inputs, _ = cs.kernel_inputs(cs.build_flagship("cuda"))
    for rnd in range(opts.rounds):
        for case in opts.cases:
            args, kw = inputs[case]
            wrapper = cs.wrapper_of(case)
            call = lambda: getattr(rc, wrapper)(*args, **kw)
            print(json.dumps({"root": root, "case": case, "round": rnd,
                              "ms": cs._time_ms(call),
                              "alone_ms": cs._alone_ms(call, wrapper)}),
                  flush=True)


if __name__ == "__main__":
    main()

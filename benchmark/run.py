"""Run one cell of the tpu_renderer_torch benchmark on this machine.

    python3 benchmark/run.py --workload flagship-orbit --seed 7 \
        --seconds 10 --trace 0

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared beside its
limit, also the last lines of standard error). Exits non-zero, printing no
result, without a CUDA card, when a module of JAX or of the JAX package is
loaded, or without the system under test beside the benchmark.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Kernel caches stay in the checkout, at fixed paths.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))
    sys.path[:0] = [HERE, ROOT]
    from rbench import runner

    result, lines = runner.run(args.workload, args.seed, args.seconds,
                               bool(args.trace), root=ROOT, t0=T0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"no result: the run loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

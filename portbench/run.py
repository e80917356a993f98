"""Run one cell of the benchmark once, on the CUDA cards of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Prints the numbers compared beside their
limits as the last lines of standard error, and one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``.  Exits 3 without a result where CUDA has fewer cards than the
cell asks for, and 4 where the process has loaded ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro``.  Kernel libraries and the CUDA
driver's compile cache go under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()     # set-up is timed from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every compile cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def _finite(x):
    """Numbers as JSON has them: a reading that is not finite as text."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    _caches()
    from portbench import harness
    cell = harness.load_cell(args.workload)
    try:
        harness.require_cards(cell.chips)
    except harness.NoCard as exc:
        print(f"portbench: no result: {exc}", file=sys.stderr)
        return 3

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", t0=T0, log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: no result: this process loaded {bad}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

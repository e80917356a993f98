"""Host microseconds per intercepted call with no profiler running.

A 64 x 64 float64 ``torch.matmul`` under DFU on the CPU's simulated
tiers, both operands resident after the first call, timed in
``--rounds`` rounds of ``--calls`` calls.  Prints one JSON line: each
round's microseconds a call and their median, and, where the package
has ``repro_torch.core.spans``, the microseconds of one span boundary
with no profiler (a ``span()`` entered and left).  To compare two
checkouts, run it with each one's ``src`` in turn, from this checkout's
root::

    PYTHONPATH=<checkout>/src python3 portbench/call_cost.py
"""
import argparse
import json
import statistics
import time

import torch


def _rounds(body, rounds: int, calls: int) -> list:
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            body()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    import repro_torch
    from repro_torch.core import OffloadConfig, host_array
    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(0)
    a, b = (host_array(torch.randn(64, 64, dtype=torch.float64,
                                   generator=gen)) for _ in range(2))
    cfg = OffloadConfig(policy="dfu", threshold=1.0)
    with repro_torch.session(cfg, device="cpu") as s:
        call = _rounds(lambda: torch.matmul(a, b), args.rounds, args.calls)
        stats = s.stats.per_routine["dgemm"]
        assert stats.offloaded == stats.calls == args.rounds * args.calls
    out = {"package": repro_torch.__file__, "call_us": statistics.median(call),
           "rounds_us": call}
    try:
        from repro_torch.core import spans
    except ImportError:
        pass
    else:
        def boundary():
            with spans.span("scilib.decide"):
                pass
        out["span_us"] = statistics.median(
            _rounds(boundary, args.rounds, args.calls * 10))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

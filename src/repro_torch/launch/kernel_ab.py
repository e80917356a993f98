"""Compare this tree's kernels with another tree's on the card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_ab OTHER_ROOT

``OTHER_ROOT`` is the root of another checkout of the repo, for example
the parent commit unpacked by ``git archive`` into ``build/parent``.  Each
tree runs in a process of its own with its own ``src`` on the path, in
the order other, here, here, other, so that a drift of the card's clocks
shows.  Each process builds the tree's libraries with the tree's own
``compat.build_all`` (into ``build/ab-kernels`` of that tree, emptied at
the start, so the first process of each tree compiles every source), and:

- returns the ``ptxas -v`` log of each source it compiled.  Per source
  that both trees have, the script prints whether every variant's line
  (``compat.ptxas_variants``: registers, static shared memory, stack,
  spill stores) is the same, and the lines that differ: a moved helper
  must not change the code ptxas emits;
- times ``decode_attention`` at gemma2-9b's serve shape (bf16 q
  [2, 16, 1, 256], cache [2, 8, 4624, 256], kv_len 4609 by value,
  softcap 50) by two yardsticks: CUDA events around 50 back-to-back calls,
  which include the wrapper's host time, and ``torch.profiler``'s device
  time per call, summed over every device event of the call (kernels,
  memsets, copies), with the same sum per event name.  Beside them: the
  launches one call counts, and the per-row error against the tree's own
  plain version.

One JSON line per process, then a summary.  Exits 1 without a card or
when a build fails.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPS = 50
#: gemma2-9b's serve shape: b, hq, hkv, d, cache length, kv_len
SERVE = (2, 16, 8, 256, 4624, 4609)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call from CUDA events around ``reps`` back-to-back
    calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> tuple:
    """Device ms per call from torch.profiler over ``reps`` calls, summed
    over every device event, and the same per event name; raises when the
    profiler records no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / reps
    if not by_name:
        raise RuntimeError("the profiler recorded no device event")
    return sum(by_name.values()), by_name


def worker() -> dict:
    """One tree's build logs and decode times (run with the tree's src
    on the path)."""
    import torch
    from repro_torch.kernels import compat
    from repro_torch.kernels import decode_attention as da
    compat.BUILD_DIR = compat.BUILD_DIR.parent / "ab-kernels"
    compat.build_all()
    dev = torch.device("cuda:0")
    b, hq, hkv, d, s, n = SERVE
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    q, k, v = rnd(b, hq, 1, d) * 30.0, rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    k[:, :, n:] *= 4

    def call():
        return da.decode_attention(q, k, v, n, softcap=50.0)
    want = da.decode_attention_plain(q, k, v, n, softcap=50.0).float()
    da.reset_launches()
    got = call().float()
    launches = da.launches
    err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    events = time_ms(call, REPS)
    total, by_name = device_ms(call, REPS)
    return dict(build_log=dict(compat.BUILD_LOG), launches=launches,
                row_err=err, events_ms=events, device_ms=total,
                device_by_name=by_name)


def run_tree(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--worker"], env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{root}: worker exit {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def line(v: dict) -> str:
    return (f"{v['name']}: {v.get('regs')} registers, {v.get('smem')} B "
            f"smem, {v['stack']} B stack, {v['spill']} B spill stores")


def main(argv=None) -> int:
    import torch
    from repro_torch.kernels import compat
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = {"other": Path(args[0]).resolve(),
             "here": Path(__file__).resolve().parents[3]}
    for root in trees.values():
        shutil.rmtree(root / "build" / "ab-kernels", ignore_errors=True)
    runs = []
    try:
        for tag in ("other", "here", "here", "other"):
            r = run_tree(trees[tag])
            runs.append((tag, r))
            print(json.dumps(dict(tree=tag, **{key: val for key, val in
                                               r.items() if key !=
                                               "build_log"})), flush=True)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    logs = {tag: r["build_log"] for tag, r in reversed(runs)
            if r["build_log"]}
    for name in sorted(set(logs["here"]) & set(logs["other"])):
        mine = [line(v) for v in compat.ptxas_variants(logs["here"][name])]
        theirs = [line(v) for v in
                  compat.ptxas_variants(logs["other"][name])]
        same = sorted(mine) == sorted(theirs)
        print(f"ptxas {name}: {len(mine)} variants here, {len(theirs)} in "
              f"{args[0]}: {'identical' if same else 'DIFFERENT'}")
        for ln in sorted(set(mine) ^ set(theirs)):
            print(f"ptxas {name}:   {'here ' if ln in mine else 'other'} "
                  f"{ln}")
    for tag in trees:
        mine = [r for t, r in runs if t == tag]
        print(f"decode {tag}: CUDA events ms per call "
              f"{[round(r['events_ms'], 5) for r in mine]}, device ms per "
              f"call {[round(r['device_ms'], 5) for r in mine]}, launches "
              f"per call {mine[0]['launches']}, per-row error "
              f"{mine[0]['row_err']:.3e}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        print(json.dumps(worker()))
        sys.exit(0)
    sys.exit(main())

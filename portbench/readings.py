"""The readings that a cell's limits are set from, in one process.

    python3 portbench/readings.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9

For each seed of ``--seeds`` the program runs the cell's first steps
after its warm-up (as many as a run compares: the traffic's
``sample_steps``) and every one is compared with the plain reference:
the program's reading is the worst.  For each seed of
``--control-seeds`` the controls are read on the same steps:

* ``lower``: the reference itself, in the nearest type below the
  configuration's (complex64 for complex128, float32 for float64, TF32
  off), put in the program's place;
* each entry of the configuration's ``controls``: the program with those
  session settings (its own lower-precision path, such as
  ``precision="split3"``).

Prints one JSON line per reading.  The benchmark's runs do not run this;
its CPU test runs it at a small size.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program(cell, seed: int, device, session=None) -> dict:
    """The program's worst numbers over the first compared steps."""
    import torch

    from portbench import harness
    probe = harness.Probe(torch.device(device).type == "cuda")
    app = harness.app_module(cell.config).App(
        cell.config, cell.traffic, seed, device, probe,
        session or harness.session_settings(cell))
    app.setup()
    samples = []
    for _ in range(cell.traffic["sample_steps"]):
        index, _, outputs = app.step()
        samples.append((index, outputs))
    app.close()
    del app
    gc.collect()
    worst, _ = harness.check(cell, seed, device, samples)
    return worst


def lower(cell, seed: int, device) -> dict:
    """The reference in the type below, in the program's place, on the
    steps a run of the program compares first."""
    from portbench import harness
    ref = harness.ref_module(cell.config)
    low = ref.LOWER[ref.dtype_of(cell.config)]
    first = harness.app_module(cell.config).App(
        cell.config, cell.traffic, seed, device, None,
        harness.session_settings(cell)).warmup
    steps = range(first, first + cell.traffic["sample_steps"])
    inputs = ref.make_inputs(cell.config, cell.traffic, seed, device,
                             steps=steps)
    worst: dict = {}
    for index in steps:
        got = ref.reference(cell.config, cell.traffic, inputs, index, low)
        want = ref.reference(cell.config, cell.traffic, inputs, index)
        for name, value in ref.compare(got, want).items():
            worst[name] = max(worst.get(name, 0.0), value)
    return worst


def readings(cell, seeds, control_seeds, device, emit=print) -> list:
    """Every reading as a dict: side, seed, numbers."""
    from portbench import harness
    out = []

    def add(side, seed, numbers):
        row = {"workload": cell.name, "side": side, "seed": seed,
               "numbers": numbers}
        out.append(row)
        emit(json.dumps(row))
    for seed in seeds:
        add("program", seed, program(cell, seed, device))
    for seed in control_seeds:
        add("control:lower", seed, lower(cell, seed, device))
        for settings in cell.config.get("controls", []):
            session = {**harness.session_settings(cell), **settings}
            name = ",".join(f"{k}={v}" for k, v in settings.items())
            add(f"control:{name}", seed,
                program(cell, seed, device, session))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)

    def ints(text):
        return [int(x) for x in text.split(",") if x]
    readings(cell, ints(args.seeds), ints(args.control_seeds), "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())

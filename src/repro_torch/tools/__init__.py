"""Operator-facing tools built on the runtime's traces and simulator.

* :mod:`repro_torch.tools.autotune` — trace-replay autotuner: grid-search the
  ``SCILIB_*`` knobs against the memtier simulator and print recommended
  settings (``python -m repro_torch.tools.autotune trace.json``).
"""

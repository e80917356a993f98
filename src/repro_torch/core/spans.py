"""Profiler spans at the port's layer boundaries.

While ``torch.profiler`` records, each boundary below is a
``record_function`` range on the profiler's clock, beside the kernels
and copies it launches, so a trace can put device time, copy bytes and
idle gaps under the layer the host was in:

* ``scilib.call.<routine>``: one intercepted BLAS call, from its
  decision to its record (its call site is read just before);
* ``scilib.decide``: its dispatch stages, precision and venue;
* ``scilib.move.<reason>``: one placement move, the copy and any wait
  it makes the host do; ``<reason>`` is ``first`` (never placed),
  ``again`` (the key's copy dropped with its anchor, the memory
  unchanged), ``stale`` (its source written since), ``refetch`` (the cap
  evicted it), ``stream`` (an operand copied for one call) or ``out``
  (Mem-Copy's copy-back);
* ``scilib.compute``: the enqueue of the call's kernels;
* ``scilib.fence``: the call's event record or synchronize;
* ``scilib.solver.<name>``: one solver span (getrf, getrs, ...);
* ``scilib.panel``: one unblocked LU panel;
* ``scilib.swap``: one panel's row swaps of the other columns.

With no profiler running a span is one read of the profiler's flag and
a shared no-op context: nothing is allocated and no lock taken.  An
intercepted call reads the flag once (``CallContext.traced``) and enters
no context at all.  Inside a CUDA graph capture no span is recorded.
Spans change no output, decision or counter.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def enabled() -> bool:
    """Whether a span entered now is recorded: a profiler runs and this
    thread's stream captures no CUDA graph."""
    return _profiler._is_profiler_enabled and not _capturing()


def span(name: str, suffix: str = ""):
    """A context recording ``name + suffix`` while :func:`enabled`, else
    the shared no-op context (the suffix is joined only when recorded)."""
    if not _profiler._is_profiler_enabled or _capturing():
        return _OFF
    return torch.profiler.record_function(name + suffix)


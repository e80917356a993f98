"""Span-wrapped LAPACK drivers: each call is one solver *span*.

The port's counterpart of ``repro/solvers/drivers.py``.  A span is the
runtime's unit of solver work: ``solver_begin`` pins the factor buffer
on the device tier (every panel update re-reads it: the ~780x-reuse
pattern ``apps/lsms.py`` documents), stamps every inner BLAS call with
the span's ``solver_id``, and emits a ``solver_begin``/``solver_end``
event pair into the trace, so the memtier simulator replays per-solver
counters count for count.  The driver computes on the pinned device-tier
tensor the span returns, so a host factor crosses the link once per span.
Without an active runtime the drivers are plain
:mod:`repro_torch.core.lapack` / :mod:`repro_torch.solvers.eigen` calls.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

from repro_torch.core import lapack
from repro_torch.core import runtime as rtm
from repro_torch.core import spans
from repro_torch.solvers import eigen as _eigen


def _resolve_nb(nb: int) -> int:
    """Explicit ``nb`` wins; else the active session's ``lapack_nb``
    (``SCILIB_LAPACK_NB``); else the driver default, 128."""
    if nb:
        return nb
    rt = rtm.active()
    if rt is not None and rt.config.lapack_nb:
        return rt.config.lapack_nb
    return lapack.DEFAULT_NB


@contextlib.contextmanager
def _span(name: str, factor: torch.Tensor) -> Iterator[torch.Tensor]:
    """Run the body inside a solver span of the active runtime, if any,
    and a ``scilib.solver.<name>`` profiler span; yields the tensor to
    compute on (the factor's device-tier placement inside a span, the
    factor itself without a runtime)."""
    rt = rtm.active()
    if rt is None:
        yield factor
        return
    with spans.span("scilib.solver.", name):
        span = rt.solver_begin(name, factor)
        try:
            yield span.placed
        finally:
            rt.solver_end(span)


# --------------------------------------------------------------------- #
# LU tier                                                                #
# --------------------------------------------------------------------- #
def getrf(a: torch.Tensor, nb: int = 0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked LU with partial pivoting, as one solver span."""
    with _span("getrf", a) as placed:
        return lapack.getrf(placed, nb=_resolve_nb(nb))


def getrs(lu: torch.Tensor, piv: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Solve from getrf output (the row permutation + two trsms), as one
    span."""
    with _span("getrs", lu) as placed:
        return lapack.getrs(placed, piv, b)


def gesv(a: torch.Tensor, b: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """Factor and solve (the zgetrf + zgetrs pair MuST calls) as one span
    covering both phases, so the factor stays pinned through the
    triangular solves that re-read it."""
    with _span("gesv", a) as placed:
        lu, piv = lapack.getrf(placed, nb=_resolve_nb(nb))
        return lapack.getrs(lu, piv, b)


# --------------------------------------------------------------------- #
# Cholesky tier                                                          #
# --------------------------------------------------------------------- #
def potrf(a: torch.Tensor, nb: int = 0, *, uplo: str = "L") -> torch.Tensor:
    """Blocked Cholesky (real-symmetric or complex-Hermitian)."""
    with _span("potrf", a) as placed:
        return lapack.potrf(placed, _resolve_nb(nb), uplo=uplo)


def potrs(f: torch.Tensor, b: torch.Tensor, *, uplo: str = "L"
          ) -> torch.Tensor:
    """Solve from potrf output (two triangular solves)."""
    with _span("potrs", f) as placed:
        return lapack.potrs(placed, b, uplo=uplo)


# --------------------------------------------------------------------- #
# eigensolver tier                                                       #
# --------------------------------------------------------------------- #
def syev(a: torch.Tensor, nb: int = 0, *,
         uplo: str = "L") -> Tuple[torch.Tensor, torch.Tensor]:
    """Hermitian eigensolve (blocked tridiagonalization + host tridiagonal
    solve + blocked back-transform), as one span."""
    with _span("syev", a) as placed:
        return _eigen.syev(placed, nb=_resolve_nb(nb), uplo=uplo)

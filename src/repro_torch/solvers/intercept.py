"""Solver-symbol interception: the LAPACK half of the DBI analogue.

The port's counterpart of ``repro/solvers/intercept.py``.  The paper's
tool patches LAPACK entry points (``zgetrf_``, ``zpotrf_``, ``zheev_``
...) like BLAS ones; the PyTorch equivalents are the public factorization
and solve symbols application code calls:

* ``torch.linalg.cholesky(A, *, upper=False)``: ``jnp.linalg.cholesky``;
* ``torch.linalg.solve(A, B, *, left=True)``: ``jnp.linalg.solve``;
* ``torch.linalg.lu_factor(A, *, pivot=True)``: ``jsl.lu_factor``;
* ``torch.linalg.lu_solve(LU, pivots, B, *, left, adjoint)``:
  ``jsl.lu_solve`` (``left=True, adjoint=False`` only);
* ``torch.cholesky_solve(B, L, upper=False)``: ``jsl.cho_solve``;
* ``torch.linalg.solve_triangular(A, B, *, upper, left=True, ...)``:
  ``jsl.solve_triangular`` (``left=True`` only);
* ``torch.linalg.eigh`` and ``torch.linalg.eigvalsh``: ``jsl.eigh``.

PyTorch has no ``cho_factor``: ``cholesky`` stands for it.  The
trampolines route super-threshold, square, float or complex systems onto
the span-wrapped blocked drivers (:mod:`repro_torch.solvers.drivers`),
with the gating discipline of :mod:`repro_torch.core.intercept`, and fall
through to the originals for everything else (sub-threshold sizes,
batched inputs, keyword arguments the drivers do not model), counting
each fall-through as uninstrumented.  Calls the runtime itself issues
while dispatching a BLAS call (``kernels/ref.py``'s triangular solve,
``core/precision.py``'s) and calls under ``torch.compile`` tracing go
straight to the originals and count nowhere; :func:`native` hands any
module the original of a patched symbol (``core/lapack.py``'s diagonal
Cholesky block, ``apps/dft.py``'s Rayleigh-Ritz ``eigh``).

Patching is refcounted and owned per session: ``OffloadConfig.lapack``
(``SCILIB_LAPACK=1``) makes an intercepting session take a reference on
open and release it on close, so with the flag unset these symbols are
never touched.

Pivot convention: the patched ``lu_factor`` returns the *absolute 0-based
row permutation* (``A[piv] == L @ U``), not LAPACK's 1-based ipiv, and
the patched ``lu_solve`` consumes the same; a factor produced while
patched must not be fed to an unpatched ``lu_solve``.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict

import torch

from repro_torch.core import blas, callsite
from repro_torch.core import runtime as rt
from repro_torch.solvers import drivers

callsite.register_machinery(__file__)

_ORIG: Dict[str, Callable] = {}
_PATCHED = 0
_PATCH_LOCK = threading.Lock()

#: the BLAS types the drivers factor
_TYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _passthrough() -> bool:
    """Straight to the original, counting nothing: inside the dispatch
    pipeline or under compile tracing."""
    return rt.dispatching() or torch.compiler.is_compiling()


def _solvable(*arrays) -> bool:
    """The solver-tier gate: an active runtime, tensors of one BLAS type
    outside autograd, and a leading square 2-D system at or above the
    threshold (sub-threshold factorizations stay native: the blocked
    drivers only pay off where offload does)."""
    r = rt.active()
    if r is None:
        return False
    for x in arrays:
        if not isinstance(x, torch.Tensor) or x.dtype not in _TYPES:
            return False
        if x.dtype != arrays[0].dtype:
            return False
        if x.requires_grad and torch.is_grad_enabled():
            return False
    a = arrays[0]
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        return False
    return a.shape[0] >= r.config.resolved_threshold()


def _rhs(a: torch.Tensor, b, dims=(1, 2)) -> bool:
    """``b`` is a right-hand side of the square system ``a``."""
    return (_solvable(a, b) and b.dim() in dims
            and b.shape[0] == a.shape[0])


def _fall(name: str, *args, **kw):
    r = rt.active()
    if r is not None:
        r.note_uninstrumented()
    return _ORIG[name](*args, **kw)


def native(name: str) -> Callable:
    """The original of a solver symbol (``"cholesky"``, ``"eigh"`` ...),
    whether or not the solver tier has patched it."""
    with _PATCH_LOCK:
        fn = _ORIG.get(name)
    if fn is not None:
        return fn
    return getattr(_MODULES[name], name)


# --------------------------------------------------------------------- #
# trampolines                                                            #
# --------------------------------------------------------------------- #
def _cholesky(A, *, upper=False, out=None):
    if _passthrough():
        return _ORIG["cholesky"](A, upper=upper, out=out)
    if out is None and _solvable(A):
        return drivers.potrf(A, uplo="U" if upper else "L")
    return _fall("cholesky", A, upper=upper, out=out)


def _solve(A, B, *, left=True, out=None):
    if _passthrough():
        return _ORIG["solve"](A, B, left=left, out=out)
    if left and out is None and _rhs(A, B):
        return drivers.gesv(A, B)
    return _fall("solve", A, B, left=left, out=out)


def _lu_factor(A, *, pivot=True, out=None):
    if _passthrough():
        return _ORIG["lu_factor"](A, pivot=pivot, out=out)
    if pivot and out is None and _solvable(A):
        return torch.return_types.linalg_lu_factor(drivers.getrf(A))
    return _fall("lu_factor", A, pivot=pivot, out=out)


def _lu_solve(LU, pivots, B, *, left=True, adjoint=False, out=None):
    if _passthrough():
        return _ORIG["lu_solve"](LU, pivots, B, left=left, adjoint=adjoint,
                                 out=out)
    if (left and not adjoint and out is None and _rhs(LU, B)
            and isinstance(pivots, torch.Tensor)):
        return drivers.getrs(LU, pivots, B)
    return _fall("lu_solve", LU, pivots, B, left=left, adjoint=adjoint,
                 out=out)


def _cholesky_solve(B, L, upper=False, *, out=None):
    if _passthrough():
        return _ORIG["cholesky_solve"](B, L, upper, out=out)
    if out is None and _rhs(L, B):
        return drivers.potrs(L, B, uplo="U" if upper else "L")
    return _fall("cholesky_solve", B, L, upper, out=out)


def _solve_triangular(A, B, *, upper, left=True, unitriangular=False,
                      out=None):
    if _passthrough():
        return _ORIG["solve_triangular"](A, B, upper=upper, left=left,
                                         unitriangular=unitriangular,
                                         out=out)
    if left and out is None and _rhs(A, B, dims=(2,)):
        return blas.trsm(A, B, side="L", uplo="U" if upper else "L",
                         trans="N", diag="U" if unitriangular else "N")
    return _fall("solve_triangular", A, B, upper=upper, left=left,
                 unitriangular=unitriangular, out=out)


def _eigh(A, UPLO="L", *, out=None):
    if _passthrough():
        return _ORIG["eigh"](A, UPLO, out=out)
    if out is None and UPLO in ("L", "U") and _solvable(A):
        return torch.return_types.linalg_eigh(drivers.syev(A, uplo=UPLO))
    return _fall("eigh", A, UPLO, out=out)


def _eigvalsh(A, UPLO="L", *, out=None):
    if _passthrough():
        return _ORIG["eigvalsh"](A, UPLO, out=out)
    if out is None and UPLO in ("L", "U") and _solvable(A):
        return drivers.syev(A, uplo=UPLO)[0]
    return _fall("eigvalsh", A, UPLO, out=out)


# --------------------------------------------------------------------- #
# symbol patching (refcounted, as in core.intercept)                     #
# --------------------------------------------------------------------- #
_SYMBOLS = (
    (torch.linalg, "cholesky", _cholesky),
    (torch.linalg, "solve", _solve),
    (torch.linalg, "lu_factor", _lu_factor),
    (torch.linalg, "lu_solve", _lu_solve),
    (torch, "cholesky_solve", _cholesky_solve),
    (torch.linalg, "solve_triangular", _solve_triangular),
    (torch.linalg, "eigh", _eigh),
    (torch.linalg, "eigvalsh", _eigvalsh),
)

_MODULES = {name: mod for mod, name, _ in _SYMBOLS}


def patch_symbols() -> None:
    """Install the solver trampolines (refcounted: nested ``lapack``
    sessions share one patch)."""
    global _PATCHED
    with _PATCH_LOCK:
        _PATCHED += 1
        if _PATCHED == 1:
            for mod, name, wrapper in _SYMBOLS:
                _ORIG[name] = getattr(mod, name)
                setattr(mod, name, wrapper)


def unpatch_symbols() -> None:
    """Release one patch reference; restore the originals at zero."""
    global _PATCHED
    with _PATCH_LOCK:
        if _PATCHED == 0:
            return
        _PATCHED -= 1
        if _PATCHED == 0:
            for mod, name, _ in _SYMBOLS:
                setattr(mod, name, _ORIG.pop(name))

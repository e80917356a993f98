"""Symbol interception — the DBI / LD_PRELOAD analogue (paper §3.1).

The port's counterpart of ``repro/core/intercept.py:96-248``.  The paper
patches BLAS symbols in an *unmodified CPU binary* with a trampoline that
runs the offload wrapper.  In PyTorch the public matrix-product entry
points play that role, and :func:`patch_symbols` rebinds them to
trampolines that route level-3-shaped calls through the offload runtime
and fall through to the original for everything else:

=========================================  ==========================
PyTorch symbol                             reference symbol
=========================================  ==========================
``torch.matmul`` and ``Tensor.__matmul__`` ``jnp.matmul``
``torch.mm``                               ``jnp.dot`` (2-D operands)
``torch.mv``                               ``jnp.dot`` (matrix, vector)
``torch.dot``                              ``jnp.dot`` (two vectors)
``torch.bmm``                              ``jnp.matmul`` (3-D operands)
``torch.einsum``                           ``jnp.einsum``
``torch.tensordot``                        ``jnp.tensordot``
=========================================  ==========================

Matrix-vector products through ``torch.matmul``/``@``/``torch.mv`` are
intercepted as gemv-shaped calls (counted, traced, threshold-dispatched);
``torch.bmm`` is a batched gemm.  ``torch.dot`` of two vectors has no
BLAS-3 or gemv shape: it is counted as uninstrumented and runs the
original, as ``jnp.dot`` of two vectors does in the reference.
``torch.mm`` takes matrices only, as the original does.  Calls made while
the runtime is already dispatching
(:func:`repro_torch.core.runtime.dispatching`), and calls traced by
``torch.compile``, go straight to the originals and count nowhere.

The patch is refcounted and lock-guarded, so nested sessions share one set
of trampolines and the originals come back only when the last one closes.
:func:`install`, :func:`uninstall` and :func:`offload` are the legacy
shims of ``repro/core/intercept.py:254-293`` over an implicit session.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from repro_torch.core import blas
from repro_torch.core import runtime as rt

_ORIG: Dict[str, callable] = {}


def _passthrough() -> bool:
    """Straight to the original, counting nothing: inside the pipeline
    (a product the runtime itself issues) or under compile tracing."""
    return rt.dispatching() or torch.compiler.is_compiling()


def _blasable(*arrays) -> bool:
    """Eager, same-dtype floating or complex tensors outside autograd."""
    if rt.active() is None:
        return False
    dtype = None
    for x in arrays:
        if not isinstance(x, torch.Tensor):
            return False
        if not (x.dtype.is_floating_point or x.dtype.is_complex):
            return False
        if x.requires_grad and torch.is_grad_enabled():
            return False
        if dtype is not None and x.dtype != dtype:
            return False
        dtype = x.dtype
    return True


def _note_uninstrumented() -> None:
    runtime = rt.active()
    if runtime is not None:
        runtime.note_uninstrumented()


def _gemv_shaped(a, b) -> Optional[tuple]:
    """Matrix-vector operands canonicalized to ``(matrix, vector,
    trans)`` — ``A @ x`` is a plain gemv, ``x @ A`` the transposed one."""
    if a.dim() == 2 and b.dim() == 1 and a.shape[1] == b.shape[0]:
        return a, b, "N"
    if a.dim() == 1 and b.dim() == 2 and b.shape[0] == a.shape[0]:
        return b, a, "T"
    return None


# --------------------------------------------------------------------- #
# trampolines                                                            #
# --------------------------------------------------------------------- #
def _matmul(a, b, *, out=None):
    if _passthrough():
        return _ORIG["matmul"](a, b, out=out)
    if out is None and _blasable(a, b):
        if a.dim() >= 2 and b.dim() >= 2:
            return blas.gemm(a, b)
        mv = _gemv_shaped(a, b)
        if mv is not None:
            return blas.gemv(mv[0], mv[1], trans=mv[2])
    _note_uninstrumented()
    return _ORIG["matmul"](a, b, out=out)


def _tensor_matmul(self, other):
    if _passthrough():
        return _ORIG["__matmul__"](self, other)
    if _blasable(self, other):
        if self.dim() >= 2 and other.dim() >= 2:
            return blas.gemm(self, other)
        mv = _gemv_shaped(self, other)
        if mv is not None:
            return blas.gemv(mv[0], mv[1], trans=mv[2])
    _note_uninstrumented()
    return _ORIG["__matmul__"](self, other)


def _mm(a, b, **kw):
    if _passthrough():
        return _ORIG["mm"](a, b, **kw)
    if (not kw and _blasable(a, b) and a.dim() == 2 and b.dim() == 2):
        return blas.gemm(a, b)
    _note_uninstrumented()
    return _ORIG["mm"](a, b, **kw)


def _mv(a, x, **kw):
    if _passthrough():
        return _ORIG["mv"](a, x, **kw)
    if (not kw and _blasable(a, x) and a.dim() == 2 and x.dim() == 1
            and a.shape[1] == x.shape[0]):
        return blas.gemv(a, x)
    _note_uninstrumented()
    return _ORIG["mv"](a, x, **kw)


def _dot(a, b, **kw):
    """Two vectors: no BLAS shape the runtime models (``_dot`` of
    ``repro/core/intercept.py:108-119`` on 1-D operands)."""
    if _passthrough():
        return _ORIG["dot"](a, b, **kw)
    _note_uninstrumented()
    return _ORIG["dot"](a, b, **kw)


def _bmm(a, b, **kw):
    if _passthrough():
        return _ORIG["bmm"](a, b, **kw)
    if (not kw and _blasable(a, b) and a.dim() == 3 and b.dim() == 3
            and a.shape[0] == b.shape[0] and a.shape[2] == b.shape[1]):
        return blas.gemm(a, b)
    _note_uninstrumented()
    return _ORIG["bmm"](a, b, **kw)


_GEMM_PATTERNS = {}
for _ta in ("N", "T"):
    for _tb in ("N", "T"):
        _GEMM_PATTERNS[("ij" if _ta == "N" else "ji") + ","
                       + ("jk" if _tb == "N" else "kj") + "->ik"] = (_ta, _tb)


def _canon_spec(spec: str):
    """Canonicalize a two-operand einsum that is exactly a (possibly
    transposed, possibly leading-batched) gemm.

    Returns ``(canonical_2d_spec, batched)`` or None.  Batched specs are
    ``bij,bjk->bik`` and its transposed variants: one leading index shared
    by both operands and the output, with a plain gemm on the trailing
    two."""
    spec = spec.replace(" ", "")
    if "->" not in spec or spec.count(",") != 1:
        return None
    lhs, out = spec.split("->")
    a, b = lhs.split(",")
    batched = False
    if len(a) == 3 and len(b) == 3 and len(out) == 3:
        bt = a[0]
        if not (b[0] == bt and out[0] == bt):
            return None
        if bt in a[1:] or bt in b[1:] or bt in out[1:]:
            return None
        a, b, out = a[1:], b[1:], out[1:]
        batched = True
    if len(a) != 2 or len(b) != 2 or len(out) != 2:
        return None
    # the contraction index is the one shared between a and b
    shared = set(a) & set(b)
    if len(shared) != 1:
        return None
    j = shared.pop()
    rest_a = [c for c in a if c != j]
    rest_b = [c for c in b if c != j]
    if len(rest_a) != 1 or len(rest_b) != 1:
        return None
    i, k = rest_a[0], rest_b[0]
    if set(out) != {i, k} or out[0] != i:
        return None
    ren = {i: "i", j: "j", k: "k"}
    canon = "".join(ren[c] for c in a) + "," + \
        "".join(ren[c] for c in b) + "->ik"
    return canon, batched


def _einsum(spec, *operands, **kw):
    if _passthrough():
        return _ORIG["einsum"](spec, *operands, **kw)
    ops = (tuple(operands[0]) if len(operands) == 1
           and isinstance(operands[0], (list, tuple)) else operands)
    if (isinstance(spec, str) and len(ops) == 2 and not kw
            and _blasable(*ops)):
        canon = _canon_spec(spec)
        if canon is not None and canon[0] in _GEMM_PATTERNS:
            spec2d, batched = canon
            a, b = ops
            want = 3 if batched else 2
            if (a.dim() == want and b.dim() == want
                    and (not batched or a.shape[0] == b.shape[0])):
                ta, tb = _GEMM_PATTERNS[spec2d]
                return blas.gemm(a, b, trans_a=ta, trans_b=tb)
    _note_uninstrumented()
    return _ORIG["einsum"](spec, *operands, **kw)


def _tensordot(a, b, dims=2, out=None):
    """2-D contractions with one contracted axis per operand are exactly
    a (possibly transposed) gemm."""
    if _passthrough():
        return _ORIG["tensordot"](a, b, dims, out=out)
    if (out is None and _blasable(a, b) and a.dim() == 2
            and b.dim() == 2):
        flags = blas.tensordot_flags(dims)
        if flags is not None:
            return blas.gemm(a, b, trans_a=flags[0], trans_b=flags[1])
    _note_uninstrumented()
    return _ORIG["tensordot"](a, b, dims, out=out)


# --------------------------------------------------------------------- #
# symbol patching (refcounted and lock-guarded: concurrent sessions      #
# opening and closing must not double-patch or restore early)            #
# --------------------------------------------------------------------- #
_PATCHED = 0
_PATCH_LOCK = threading.Lock()

#: the module-level symbols patched over ``torch``
_SYMBOLS = (("matmul", _matmul), ("mm", _mm), ("mv", _mv), ("dot", _dot),
            ("bmm", _bmm), ("einsum", _einsum), ("tensordot", _tensordot))


def patch_symbols() -> None:
    """Install the trampolines over the public symbols (refcounted)."""
    global _PATCHED
    with _PATCH_LOCK:
        _PATCHED += 1
        if _PATCHED == 1:
            for name, wrapper in _SYMBOLS:
                _ORIG[name] = getattr(torch, name)
                setattr(torch, name, wrapper)
            _ORIG["__matmul__"] = torch.Tensor.__matmul__
            # Tensor.__matmul__ is inherited from the C base class; the
            # subclass attribute shadows it and deleting it restores it
            torch.Tensor.__matmul__ = _tensor_matmul


def unpatch_symbols() -> None:
    """Release one patch reference; restore the originals at zero."""
    global _PATCHED
    with _PATCH_LOCK:
        if _PATCHED == 0:
            return
        _PATCHED -= 1
        if _PATCHED == 0:
            for name, _ in _SYMBOLS:
                setattr(torch, name, _ORIG.pop(name))
            _ORIG.pop("__matmul__")
            del torch.Tensor.__matmul__


# --------------------------------------------------------------------- #
# install / uninstall / offload: legacy shims over an implicit session   #
# --------------------------------------------------------------------- #
def install(policy: Optional[str] = None,
            threshold: Optional[float] = None,
            record_trace: bool = True, config=None,
            device=None) -> rt.OffloadRuntime:
    """Activate a runtime and patch the public symbols (the
    ``.init_array`` analogue), as a shim over an implicit session.  The
    ``SCILIB_*`` knobs are honoured through ``OffloadConfig.legacy``; an
    explicit ``config`` bypasses the environment.  ``device`` is the
    session's (``None``: ``cuda:0``; ``"cpu"``: the simulated tiers)."""
    from repro_torch.core import session as ses
    from repro_torch.core.config import OffloadConfig
    if config is None:
        config = OffloadConfig.legacy(policy=policy, threshold=threshold)
    return ses.open_legacy(config, record_trace=record_trace,
                           intercept=True, device=device).runtime


def uninstall():
    """Restore the symbols and return the final statistics (the
    ``.fini_array`` analogue); shares one stack with
    ``runtime.uninstall``."""
    from repro_torch.core import session as ses
    return ses.close_legacy()


@contextlib.contextmanager
def offload(policy: Optional[str] = None,
            threshold: Optional[float] = None,
            record_trace: bool = True, device=None):
    """``with offload("dfu", device="cpu"): ...`` — scoped automatic BLAS
    offload."""
    runtime = install(policy=policy, threshold=threshold,
                      record_trace=record_trace, device=device)
    try:
        yield runtime
    finally:
        uninstall()

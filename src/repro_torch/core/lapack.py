"""Blocked LAPACK routines built on the intercepted BLAS (paper §4.2).

The port's counterpart of ``repro/core/lapack.py``.  MuST's hot path is
LU factorization and solve (``zgetrf``/``zgetrs``), whose inner loops are
the very ``zgemm``/``ztrsm`` calls SCILIB-Accel offloads.  This module
reproduces that call structure: right-looking blocked LU with partial
pivoting, triangular solves and blocked Cholesky.  Every panel update
goes through :mod:`repro_torch.core.blas`, so an active offload runtime
sees exactly the BLAS stream a LAPACK-linked binary would emit.

These are eager, host-orchestrated drivers, like LAPACK itself: Python
plays the Fortran driver, the FLOPs are in the BLAS calls.  The reference
is functional; here the LU factor is a clone of the input, updated in
place, and the Cholesky factor a fresh tensor, both on the input's device.

The unblocked panel (:func:`_pivot_panel`) reads no value on the host;
its pivots come to the host once per panel.  The reference jits it
(``jax.jit`` of a ``fori_loop``); its counterpart here is a CUDA graph
(:class:`_PanelGraphs`): on the card the whole column loop of a panel
is one graph, captured once per process for each bucket of panel
heights (:data:`BUCKETS` per ``(nb, dtype, device)``) and replayed by
every later panel of that bucket, so the second getrf of a shape runs
each of its panels as one replay.  The panel is copied into a static
buffer (one per ``(nb, dtype, device)``, of the largest height seen,
shared as views with one memory pool) above zero rows up to its
bucket's height, replayed and copied back.  The first panel of a dtype
in a process warms up eagerly on a scratch copy; a capture that fails
raises (no eager fallback on the card).  The CPU runs the column loop
eagerly.  The trsm and gemm updates between panels stay live calls
through :mod:`repro_torch.core.blas`, so the runtime sees every one of
them; a Python wrapper around :func:`_pivot_panel` sees only the warm-up
and the captures, one around :func:`_factor_panel` sees every panel.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import blas
from repro_torch.core import runtime as rtm
from repro_torch.core import spans
from repro_torch.kernels import compat

DEFAULT_NB = 128

_PREC = {torch.float32: "s", torch.float64: "d",
         torch.complex64: "c", torch.complex128: "z"}


def _prec(dtype: torch.dtype) -> str:
    return _PREC.get(dtype, "d")


def _note_panel(prec: str, m: int, nb: int, panel: torch.Tensor) -> None:
    """Report an unblocked panel factorization to the active runtime.
    Inside a solver span (:mod:`repro_torch.solvers`) it counts toward the
    span's panel share and appears as a ``getf2`` trace call; outside a
    span it is a no-op."""
    rt = rtm.active()
    if rt is not None:
        rt.note_panel(prec, m, nb, panel)


def _pivot_panel(p: torch.Tensor, piv: torch.Tensor,
                 m_real: Optional[torch.Tensor] = None) -> None:
    """Unblocked LU with partial pivoting of an (m x nb) panel, in place
    (``repro/core/lapack.py:45-81``); the local pivot rows go into
    ``piv`` (int64, length nb, on the panel's device).

    Per column j: the pivot is the first row at or below j of largest
    modulus (``jnp.argmax`` of ``abs``, first index on ties), rows j and
    the pivot swap, the column below j is scaled by the pivot's
    reciprocal (0 for a zero pivot), and the trailing panel columns take
    the rank-1 update.  ``m_real`` (a 0-d int64 tensor on the panel's
    device) leaves the rows from it on out of every pivot search: the
    padding below a panel in a taller buffer, which can turn NaN (0 times
    an infinite pivot row or reciprocal) where a NaN would win
    ``argmax``.  Nothing is read on the host, so one CUDA graph holds the
    whole loop (``j`` is fixed in it, as in the slices)."""
    m, nb = p.shape
    rows = torch.arange(m, device=p.device)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    real = None if m_real is None else rows < m_real
    for j in range(nb):
        r = piv[j]
        mod = p[j:, j].abs()
        if real is not None:
            mod = torch.where(real[j:], mod, -1)
        torch.add(torch.argmax(mod), j, out=r)
        # rows (j, r) are read and written back as (r, j): one index
        # tensor (j, r, j) holds both orders
        order = torch.stack((rows[j], r, rows[j]))
        p.index_copy_(0, order[1:], p.index_select(0, order[:2]))
        pivval = p[j, j]
        scale = torch.where(pivval != 0, pivval.reciprocal(), zero)
        col = p[j + 1:, j]
        col.mul_(scale)
        p[j + 1:, j + 1:].sub_(col[:, None] * p[j, j + 1:][None, :])


#: panels factored on the card: graphs captured, and replays (each panel
#: of the card's getrf is one replay)
captures = 0
replays = 0


def reset_launches() -> None:
    global captures, replays
    with compat.COUNT_LOCK:
        captures = replays = 0


#: a panel is padded with zero rows below it up to a multiple of 1/8 of
#: its group's height (:class:`_Group`), so the 27 panel heights of a
#: getrf at n 6912, nb 256 share 8 graphs: the padding is left out of
#: every pivot search (``_pivot_panel``'s ``m_real``) and no padded row
#: is read by a row of the panel, so the panel's own rows come out bit
#: for bit as unpadded, infinities and NaNs included
BUCKETS = 8


@dataclasses.dataclass
class _Graph:
    """One captured panel: its graph, its static panel (a view of the
    shared buffer, of its bucket's height), its static pivots and the
    static count of the panel's own rows above the padding."""
    graph: Any                  # torch.cuda.CUDAGraph
    panel: torch.Tensor
    piv: torch.Tensor
    m_real: torch.Tensor        # 0-d int64

    def replay(self) -> None:
        self.graph.replay()
        compat.count(globals(), replays=1)


@dataclasses.dataclass
class _Group:
    """The panels of one (nb, dtype, device): a flat static buffer of
    ``BUCKETS * quantum`` rows (the tallest panel seen, rounded up), one
    memory pool and side stream, the graphs by bucket height (a multiple
    of ``quantum``)."""
    flat: torch.Tensor
    quantum: int
    pool: Any
    stream: Any
    graphs: Dict[int, _Graph]

    def bucket(self, m: int) -> int:
        return self.quantum * -(-m // self.quantum)


class _PanelGraphs:
    """The card's captured panels, per process.  A lock serializes the
    static buffers' users: copy in, replay, copy out, the pivots to the
    host."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[Tuple, _Group] = {}
        self._warm: set = set()

    def clear(self) -> None:
        """Drop every graph, buffer and pool."""
        with self._lock:
            self._groups.clear()
            self._warm.clear()

    def group(self, panel: torch.Tensor) -> _Group:
        """``panel``'s group, made anew (its graphs dropped) when the
        panel is taller than the group's buffer."""
        m, nb = panel.shape
        key = (nb, panel.dtype, panel.device)
        grp = self._groups.get(key)
        if grp is None or grp.bucket(m) * nb > grp.flat.numel():
            q = -(-m // BUCKETS)
            grp = self._groups[key] = _Group(
                torch.empty(BUCKETS * q * nb, dtype=panel.dtype,
                            device=panel.device),
                q, torch.cuda.graph_pool_handle(),
                torch.cuda.Stream(panel.device), {})
        return grp

    def get(self, panel: torch.Tensor) -> _Graph:
        """The graph of ``panel``'s bucket, captured now if it is new
        (after a warm-up if the dtype is new on the device)."""
        m, nb = panel.shape
        dev = panel.device
        grp = self.group(panel)
        h = grp.bucket(m)
        if h in grp.graphs:
            return grp.graphs[h]
        current = torch.cuda.current_stream(dev)
        if (panel.dtype, dev) not in self._warm:
            # load every kernel of the loop outside a capture, on a
            # scratch copy of the panel
            scratch = panel.clone()
            piv = torch.empty(nb, dtype=torch.int64, device=dev)
            m_real = torch.full((), m, dtype=torch.int64, device=dev)
            grp.stream.wait_stream(current)
            with torch.cuda.stream(grp.stream):
                _pivot_panel(scratch, piv, m_real)
            current.wait_stream(grp.stream)
            self._warm.add((panel.dtype, dev))
        g = _Graph(torch.cuda.CUDAGraph(), grp.flat[:h * nb].view(h, nb),
                   torch.empty(nb, dtype=torch.int64, device=dev),
                   torch.full((), h, dtype=torch.int64, device=dev))
        grp.stream.wait_stream(current)
        with torch.cuda.stream(grp.stream):
            g.graph.capture_begin(pool=grp.pool,
                                  capture_error_mode="thread_local")
            try:
                _pivot_panel(g.panel, g.piv, g.m_real)
            except BaseException:
                try:
                    g.graph.capture_end()
                except RuntimeError:
                    pass        # the capture was already invalidated
                raise
            g.graph.capture_end()
        current.wait_stream(grp.stream)
        compat.count(globals(), captures=1)
        grp.graphs[h] = g
        return g

    def factor(self, panel: torch.Tensor) -> List[int]:
        """Factor ``panel`` in place by its bucket's graph (the panel on
        top, zero rows below it); its local pivots."""
        m = panel.shape[0]
        with self._lock:
            g = self.get(panel)
            g.panel[:m].copy_(panel)
            g.panel[m:].zero_()
            g.m_real.fill_(m)
            g.replay()
            panel.copy_(g.panel[:m])
            return g.piv.tolist()


_GRAPHS = _PanelGraphs()


def release_graphs() -> None:
    """Free the card's captured panels: their graphs, static buffers and
    memory pools.  The last open session's close calls it, so the panels
    live as long as some session does; after a getrf outside any session
    they stay until this is called."""
    _GRAPHS.clear()


def _factor_panel(panel: torch.Tensor) -> List[int]:
    """Factor one panel in place and return its local pivot rows: the
    column loop eagerly on the CPU, one replay of the panel's captured
    graph on the card."""
    with spans.span("scilib.panel"):
        if panel.device.type == "cuda":
            return _GRAPHS.factor(panel)
        piv = torch.empty(panel.shape[1], dtype=torch.int64,
                          device=panel.device)
        _pivot_panel(panel, piv)
        return piv.tolist()


def getrf(a: torch.Tensor, nb: int = DEFAULT_NB
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU with partial pivoting (general m x n).

    Returns ``(LU, piv)``: ``piv`` (int32, on the factor's device) is the
    absolute row permutation (length ``m``) with ``A[piv] == L @ U``, the
    composed form of LAPACK's sequential ipiv swaps.  The trailing-matrix
    updates are the trsm + gemm pairs that dominate MuST's runtime."""
    m, n = a.shape
    prec = _prec(a.dtype)
    k_max = min(m, n)
    lu = a.clone(memory_format=torch.contiguous_format)
    piv = list(range(m))
    for j0 in range(0, k_max, nb):
        jb = min(nb, k_max - j0)
        panel = lu[j0:, j0:j0 + jb]
        lpiv = _factor_panel(panel)
        _note_panel(prec, m - j0, jb, panel)
        with spans.span("scilib.swap"):
            # compose the panel's swaps into one permutation of rows j0:
            perm = list(range(m - j0))
            for jj, r in enumerate(lpiv):
                perm[jj], perm[r] = perm[r], perm[jj]
            piv[j0:] = [piv[j0 + r] for r in perm]
            # the panel's rows are swapped already: permute the rows of
            # the columns left and right of it
            if perm != list(range(m - j0)):
                idx = torch.tensor(perm, dtype=torch.int64,
                                   device=lu.device)
                for cols in (slice(0, j0), slice(j0 + jb, n)):
                    blk = lu[j0:, cols]
                    if blk.numel():
                        blk.copy_(blk.index_select(0, idx))
        if j0 + jb < n:
            # U12 = L11^{-1} A12           (trsm, unit lower)
            l11 = lu[j0:j0 + jb, j0:j0 + jb]
            a12 = lu[j0:j0 + jb, j0 + jb:]
            u12 = blas.trsm(l11, a12, side="L", uplo="L", trans="N",
                            diag="U")
            a12.copy_(u12)
            if j0 + jb < m:
                # A22 -= L21 U12           (gemm: the hot spot)
                l21 = lu[j0 + jb:, j0:j0 + jb]
                a22 = lu[j0 + jb:, j0 + jb:]
                upd = blas.gemm(l21, u12, a22, alpha=-1.0, beta=1.0)
                a22.copy_(upd)
    return lu, torch.tensor(piv, dtype=torch.int32, device=lu.device)


def _as_matrix(b: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    return (b[:, None], True) if b.dim() == 1 else (b, False)


def getrs(lu: torch.Tensor, piv: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Solve A X = B from getrf output (the row permutation + two trsm
    calls): A x = b  <=>  LU x = b[piv]."""
    b, squeeze = _as_matrix(b)
    x = b.index_select(0, piv.to(device=b.device, dtype=torch.int64))
    y = blas.trsm(lu, x, side="L", uplo="L", trans="N", diag="U")
    z = blas.trsm(lu, y, side="L", uplo="U", trans="N", diag="N")
    return z[:, 0] if squeeze else z


def gesv(a: torch.Tensor, b: torch.Tensor,
         nb: int = DEFAULT_NB) -> torch.Tensor:
    """Driver: solve A X = B (the zgetrf + zgetrs pair MuST calls)."""
    lu, piv = getrf(a, nb=nb)
    return getrs(lu, piv, b)


def _conj_t(a: torch.Tensor) -> torch.Tensor:
    """A^H as a contiguous tensor with its conjugation applied (never a
    lazily conjugated view, which the kernels would read unconjugated)."""
    return a.mH.resolve_conj().contiguous()


def _chol_block(blk: torch.Tensor) -> torch.Tensor:
    """Unblocked Cholesky of a diagonal block on the *native*
    ``torch.linalg.cholesky``, also while the solver tier has patched it
    (a block at or above the threshold would otherwise re-enter
    :func:`potrf` without end).  The block is symmetrized first, as
    ``jnp.linalg.cholesky`` does with its input."""
    from repro_torch.solvers.intercept import native
    return native("cholesky")((blk + blk.mH) / 2)


def potrf(a: torch.Tensor, nb: int = DEFAULT_NB, *,
          uplo: str = "L") -> torch.Tensor:
    """Blocked Cholesky (gemm updates + right-side trsm + an unblocked
    diagonal block) of a real-symmetric or complex-Hermitian matrix.
    ``uplo="U"`` factors the conjugate transpose and returns ``U`` with
    ``A = U^H U``."""
    if uplo == "U":
        return _conj_t(potrf(_conj_t(a), nb, uplo="L"))
    n = a.shape[0]
    l = torch.zeros_like(a, memory_format=torch.contiguous_format)
    for j0 in range(0, n, nb):
        jb = min(nb, n - j0)
        # diagonal block: A11 - L10 L10^H
        l10 = l[j0:j0 + jb, :j0]
        a11 = a[j0:j0 + jb, j0:j0 + jb]
        if j0 > 0:
            a11 = blas.gemm(l10, l10, a11, alpha=-1.0, beta=1.0,
                            trans_b="C")
        l11 = _chol_block(a11)
        l[j0:j0 + jb, j0:j0 + jb] = l11
        if j0 + jb < n:
            l20 = l[j0 + jb:, :j0]
            a21 = a[j0 + jb:, j0:j0 + jb]
            if j0 > 0:
                a21 = blas.gemm(l20, l10, a21, alpha=-1.0, beta=1.0,
                                trans_b="C")
            # L21 = A21 L11^{-H}    (right-side trsm)
            l21 = blas.trsm(l11, a21, side="R", uplo="L", trans="C",
                            diag="N")
            l[j0 + jb:, j0:j0 + jb] = l21
    return l


def potrs(f: torch.Tensor, b: torch.Tensor, *,
          uplo: str = "L") -> torch.Tensor:
    """Solve A X = B from potrf output (two triangular solves)."""
    b, squeeze = _as_matrix(b)
    if uplo == "L":
        # A = L L^H: solve L y = b, then L^H x = y
        y = blas.trsm(f, b, side="L", uplo="L", trans="N", diag="N")
        x = blas.trsm(f, y, side="L", uplo="L", trans="C", diag="N")
    else:
        # A = U^H U: solve U^H y = b, then U x = y
        y = blas.trsm(f, b, side="L", uplo="U", trans="C", diag="N")
        x = blas.trsm(f, y, side="L", uplo="U", trans="N", diag="N")
    return x[:, 0] if squeeze else x

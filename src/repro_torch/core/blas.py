"""Level-3 BLAS surface in PyTorch (paper §3: "all level-3 BLAS routines").

The port's counterpart of ``repro/core/blas.py``.  This is
the dlsym-mode API: applications (or the interceptor) call these
functions directly; each routes through the active ``OffloadRuntime`` for
the offload decision, data placement and statistics, then computes
through ``kernels/ops.py``.  Real BLAS semantics are honoured: ``uplo``
triangles are the only parts of symmetric/triangular operands referenced,
``beta`` scaling, unit diagonals, side selection, and conjugate
transposes.

Precision prefix follows dtype: s/d/c/z for f32/f64/c64/c128 (bf16 and
f16 map to the s-path).  Leading batch dimensions select the batched
variants with the same placement logic.

Every product here goes through ``kernels.ops.matmul`` (the gemm kernel
on the card) and every real solve through ``kernels.ops.trsm``; the
matrix-vector product uses the un-intercepted ``torch.matmul``
(``kernels.ref.torch_matmul``), so nothing here re-enters the
interceptor.  With ``kernel_path`` on, gemm/syrk/trsm also offer the
runtime the ``pallas``-venue closures over ``kernels.ops.kernel_*`` (the
syrk kernel computes one triangle), and with a ``precision`` scheme the
split-precision closures over ``core/precision.py``.

With more than one device tier (``OffloadConfig.devices``) each routine
also hands the runtime a tile builder (``_shard_*``, the reference's
BLASX-style decomposition): gemm tiles its output 2-D, symm/trmm/trsm
split the rectangular panel along its free dimension (the triangle
replicates), syrk/herk and syr2k/her2k tile the stored triangle of C.
The tiles follow the call's venue: on ``pallas`` gemm tiles run
``kops.kernel_matmul`` (the gemm kernel), syrk tiles the masked full
product on it (not the syrk kernel, as in the reference), trsm tiles
``kops.kernel_trsm``, and split tiles the fused split kernel.

Failure semantics: every call returns a correct result or raises.  A
transfer or kernel failure on the offload path is retried and, on
exhaustion, the call reruns on the host path with the same operands
(:mod:`repro_torch.core.faults`).  Bugs, and the port's own build and
launch errors, propagate to the caller.
"""
from __future__ import annotations

import functools
import math
import operator
from contextvars import ContextVar
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch.core import precision as prc
from repro_torch.core import runtime as rt
from repro_torch.core.runtime import Tile, TileOp, TilePlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

__all__ = ["gemm", "gemv", "symm", "hemm", "syrk", "herk", "syr2k",
           "her2k", "trmm", "trsm", "routine_name", "tensordot_flags"]

_PREFIX = {"float32": "s", "float64": "d", "complex64": "c",
           "complex128": "z", "bfloat16": "s", "float16": "s"}
_RNAMES: Dict[Tuple[str, torch.dtype], str] = {}


def dtype_name(dt: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.float32`` ->
    ``"float32"``), as the reference's keys and routine names use."""
    return str(dt).rpartition(".")[2]


def routine_name(base: str, dtype: torch.dtype) -> str:
    name = _RNAMES.get((base, dtype))
    if name is None:
        name = _RNAMES[(base, dtype)] = (
            _PREFIX.get(dtype_name(dtype), "s") + base)
    return name


# ----------------------------------------------------------------------- #
# dispatch fast path: memoized compute closures per call-site signature    #
# (``dispatch_cache=False`` restores the per-call re-derivation)           #
# ----------------------------------------------------------------------- #
_CACHE_ON = True
_CACHE_VAR: ContextVar[Optional[bool]] = (
    ContextVar("scilib_torch_dispatch_cache", default=None))
_BOUND: Dict[Hashable, Callable] = {}
_CACHE_LIMIT = 4096


def refresh_cache_flag(enabled: bool) -> None:
    """Follow the owning config's ``dispatch_cache`` field (runtime
    construction and reconfigure call this)."""
    global _CACHE_ON
    _CACHE_VAR.set(bool(enabled))
    _CACHE_ON = bool(enabled)


def _cache_enabled() -> bool:
    v = _CACHE_VAR.get()
    return _CACHE_ON if v is None else v


def clear_caches() -> None:
    """Drop the memoized compute closures.  The port keeps no scalar
    cache: alpha and beta stay Python numbers (:func:`_scalar`)."""
    _BOUND.clear()


def _hashable(v):
    """Scalar cache key for alpha/beta, or None if uncacheable (tensors)."""
    if isinstance(v, (bool, int, float, complex)):
        return v
    return None


def _bound(key: Optional[Hashable], factory: Callable[[], Callable]):
    """Memoize the bound compute closure for one call-site signature."""
    if not _cache_enabled() or key is None:
        return factory()
    fn = _BOUND.get(key)
    if fn is None:
        if len(_BOUND) > _CACHE_LIMIT:
            _BOUND.clear()
        fn = _BOUND[key] = factory()
    return fn


def _call_key(bkey: Optional[Hashable], m: int, n: int, k: int,
              batch: int) -> Optional[Hashable]:
    """Dispatch-cache key: (routine, flags, dtype, alpha, beta) + shape."""
    if bkey is None:
        return None
    return (bkey, m, n, k, batch)


def tensordot_flags(axes) -> Optional[Tuple[str, str]]:
    """Canonicalize a 2-D ``tensordot`` dims spec into gemm transpose
    flags, or None when the contraction is not gemm-shaped.

    For two matrices, a single contracted axis per operand is exactly a
    (possibly transposed) gemm — tensordot orders the output as (free
    axes of a, free axes of b), which is gemm's ``ik`` layout:

    ========================  ==========
    dims                      (ta, tb)
    ========================  ==========
    ``1`` / ``(1, 0)``        ``N, N``
    ``(0, 0)``                ``T, N``
    ``(1, 1)``                ``N, T``
    ``(0, 1)``                ``T, T``
    ========================  ==========

    ``dims=2`` (full double contraction -> scalar) and anything
    higher-rank are not level-3 calls and return None.
    """
    if isinstance(axes, int):
        if axes != 1:
            return None
        ax_a, ax_b = 1, 0              # a's last axis against b's first
    else:
        try:
            ax_a, ax_b = axes
        except (TypeError, ValueError):
            return None
        ax_a, ax_b = _single_axis(ax_a), _single_axis(ax_b)
        if ax_a is None or ax_b is None:
            return None
    ta = "N" if ax_a == 1 else "T"
    tb = "N" if ax_b == 0 else "T"
    return ta, tb


def _single_axis(ax) -> Optional[int]:
    """One matrix axis as a plain 0/1 int, or None.  Accepts ints,
    integer-likes, and single-axis sequences."""
    if not isinstance(ax, int):
        try:                           # single-element sequence?
            if len(ax) != 1:
                return None
            ax = ax[0]
        except TypeError:
            pass                       # scalar-like: fall through
    try:
        ax = operator.index(ax)
    except TypeError:
        return None
    if ax not in (-2, -1, 0, 1):
        return None                    # out of range for a matrix
    return ax % 2                      # accept negative axes


def _op(x: torch.Tensor, trans: str) -> torch.Tensor:
    if trans == "N":
        return x
    return x.mH if trans == "C" else x.mT


def _scalar(v, dtype: torch.dtype):
    """alpha/beta as a Python number of the routine's type: a complex
    scalar loses its imaginary part on a real routine, as
    ``alpha.astype(dtype)`` does in the reference."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    if not dtype.is_complex:
        v = v.real if isinstance(v, complex) else float(v)
    return v


def _tri_mask(n: int, uplo: str, device) -> torch.Tensor:
    r = torch.arange(n, device=device)
    if uplo == "L":
        return r[:, None] >= r[None, :]
    return r[:, None] <= r[None, :]


def _sym_full(a: torch.Tensor, uplo: str, conj: bool = False) -> torch.Tensor:
    """Materialize the full symmetric/hermitian matrix from one triangle."""
    tri = torch.tril(a, -1) if uplo == "L" else torch.triu(a, 1)
    other = tri.mT
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    if conj:
        other = other.conj()
        diag = diag.real.to(a.dtype)   # hermitian diag is real
    return tri + other + torch.diag_embed(diag)


def _batch_of(*arrays) -> int:
    b = 1
    for a in arrays:
        if a is not None and a.dim() > 2:
            b = int(functools.reduce(lambda x, y: x * y, a.shape[:-2], 1))
    return b


# ----------------------------------------------------------------------- #
# arithmetic (every product through kernels.ops)                          #
#                                                                          #
# ``mm`` is the product the closure runs: ``kops.matmul`` (the generic     #
# `xla` venue), ``kops.kernel_matmul`` (the `pallas` venue) or a split     #
# product (:func:`_split_matmul`), so one closure serves all three.        #
# ----------------------------------------------------------------------- #
def _gemm_kernel(a, b, c, alpha, beta, *, trans_a, trans_b, mm=kops.matmul):
    acc = mm(_op(a, trans_a), _op(b, trans_b))
    out = alpha * acc
    if c is not None:
        out = out + beta * c
    return out.to(a.dtype)


def _symm_kernel(a, b, c, alpha, beta, *, side, uplo, conj):
    full = _sym_full(a, uplo, conj=conj)
    acc = kops.matmul(full, b) if side == "L" else kops.matmul(b, full)
    out = alpha * acc
    if c is not None:
        out = out + beta * c
    return out.to(b.dtype)


def _syrk_kernel(a, c, alpha, beta, *, uplo, trans, conj, mm=kops.matmul):
    opa = _op(a, trans)
    at = opa.mH if conj else opa.mT
    upd = alpha * mm(opa, at)
    mask = _tri_mask(upd.shape[-1], uplo, upd.device)
    if c is not None:
        tri = torch.where(mask, upd + beta * c, c)
    else:
        tri = torch.where(mask, upd, torch.zeros_like(upd))
    return tri.to(a.dtype)


def _syr2k_kernel(a, b, c, alpha, beta, *, uplo, trans, conj):
    opa, opb = _op(a, trans), _op(b, trans)
    if conj:
        # her2k: C := alpha A B^H + conj(alpha) B A^H + beta C
        upd = (alpha * kops.matmul(opa, opb.mH)
               + alpha.conjugate() * kops.matmul(opb, opa.mH))
    else:
        upd = alpha * (kops.matmul(opa, opb.mT) + kops.matmul(opb, opa.mT))
    mask = _tri_mask(upd.shape[-1], uplo, upd.device)
    if c is not None:
        tri = torch.where(mask, upd + beta * c, c)
    else:
        tri = torch.where(mask, upd, torch.zeros_like(upd))
    return tri.to(a.dtype)


def _syrk_block_kernel(ai, aj, c, alpha, beta, *, trans, conj,
                       mm=kops.matmul):
    """Off-diagonal block of a tiled syrk/herk:
    C[i,j] := alpha op(A)_i op(A)_j^{T|H} + beta C[i,j] (full block)."""
    opi, opj = _op(ai, trans), _op(aj, trans)
    out = alpha * mm(opi, opj.mH if conj else opj.mT)
    if c is not None:
        out = out + beta * c
    return out.to(ai.dtype)


def _syr2k_block_kernel(ai, bi, aj, bj, c, alpha, beta, *, trans, conj):
    """Off-diagonal block of a tiled syr2k/her2k — the two-term rank-2k
    analogue of :func:`_syrk_block_kernel` (her2k conjugate-transposes
    and uses conj(alpha) on the second term)."""
    opai, opbi = _op(ai, trans), _op(bi, trans)
    opaj, opbj = _op(aj, trans), _op(bj, trans)
    if conj:
        out = (alpha * kops.matmul(opai, opbj.mH)
               + alpha.conjugate() * kops.matmul(opbi, opaj.mH))
    else:
        out = alpha * (kops.matmul(opai, opbj.mT)
                       + kops.matmul(opbi, opaj.mT))
    if c is not None:
        out = out + beta * c
    return out.to(ai.dtype)


def _trmm_kernel(a, b, alpha, *, side, uplo, trans, diag):
    tri = _op(ref.triangle(a, uplo, diag), trans)
    out = kops.matmul(tri, b) if side == "L" else kops.matmul(b, tri)
    return (alpha * out).to(b.dtype)


def _trsm_kernel(a, b, alpha, *, side, uplo, trans, diag):
    return kops.trsm(a, alpha * b, side=side, uplo=uplo, trans=trans,
                     diag=diag).to(b.dtype)


# ----------------------------------------------------------------------- #
# pallas-venue arithmetic (OffloadConfig.kernel_path / SCILIB_KERNELS)     #
#                                                                          #
# Built only when the kernel path is on and the routine has a kernel       #
# (``kops.kernel_available``).  The ``_*_klean`` variants serve the        #
# dominant alpha=1 / beta=0 / no-C call shape with no scalar epilogue;    #
# the others are the generic closures above with ``kops.kernel_matmul``    #
# (``kops.kernel_trsm`` is the recursion of ``kops.trsm``, so trsm's       #
# generic closure serves the venue as it is).                              #
# ----------------------------------------------------------------------- #
def _gemm_klean(a, b, *, block=0):
    return kops.kernel_matmul(a, b, block=block)


def _syrk_klean(a, *, uplo, trans):
    # real syrk only reaches the venue (kernel_available), so "C" == "T"
    return kops.kernel_syrk(a, uplo=uplo, trans="N" if trans == "N" else "T")


def _trsm_klean(a, b, *, side, uplo, trans, diag):
    return kops.kernel_trsm(a, b, side=side, uplo=uplo, trans=trans,
                            diag=diag).to(b.dtype)


# ----------------------------------------------------------------------- #
# split-precision arithmetic (OffloadConfig.precision / SCILIB_PRECISION)  #
#                                                                          #
# The fp64 inner product as split low-precision slice passes               #
# (core/precision.py).  Built only when a split scheme is configured and   #
# the base/dtype supports one (real 2-D fp64).  The `xla` venue runs the   #
# plain fp32 product per pass, the `pallas` venue the fused split kernel   #
# (kernels/split_gemm.py).                                                 #
# ----------------------------------------------------------------------- #
def _split_product(venue: str):
    """The whole split product ``(a, b, scheme) -> a @ b`` of one venue:
    on `pallas` the fused split kernel's entry (kernels/split_gemm.py,
    whose plain passes run on CPU tensors); on `xla` None, the precision
    module's passes on the plain fp32 product."""
    if venue == "pallas":
        from repro_torch.kernels import split_gemm
        return split_gemm.matmul
    return None


def _split_matmul(scheme: str, venue: str):
    """The fp64 product of one (scheme, venue) as an ``mm`` for the
    closures above."""
    product = _split_product(venue) or prc.matmul

    def mm(a, b):
        return product(a, b, scheme)
    return mm


def _split_trsm_kernel(a, b, alpha, *, side, uplo, trans, diag, scheme,
                       venue):
    """fp32 solve + one refinement step whose residual runs the split
    matmul.  The referenced triangle is materialized first: the
    refinement's ``op(A) X`` product reads the full array."""
    return prc.trsm(ref.triangle(a, uplo, diag), alpha * b, scheme,
                    left_side=(side == "L"), lower=(uplo == "L"),
                    trans_a=(trans != "N"), unit_diag=(diag == "U"),
                    product=_split_product(venue)).to(b.dtype)


def _split_bound(base, dt, bkey, sfactory, flat2d=True):
    """Build the ``(scheme, venue) -> compute`` factory the runtime's
    precision stage consults, or None when no split scheme is configured
    or the call has no split formulation (real 2-D fp64 only; batched
    calls stay native).  Memo keys get a ``"split"`` prefix so split
    closures never collide with the others in ``_BOUND``."""
    runtime = rt.active()
    if runtime is None or not runtime.precision or not flat2d:
        return None
    if not prc.supported(base, dt):
        return None

    def split_compute(scheme, venue):
        venue = venue or "xla"
        skey = (("split", scheme, venue) + bkey
                if bkey is not None else None)
        return _bound(skey, functools.partial(sfactory, scheme, venue))
    return split_compute


def _kernel_bound(base, dt, bkey, kfactory):
    """The pallas-venue twin of ``_bound``: the kernel-backed compute
    closure for one call-site signature, or None when the kernel path is
    off or the routine/dtype has no kernel.  ``kfactory`` takes the gemm
    kernel's tile edge (``kernel_block``); memo keys get a ``"kern"``
    prefix plus that edge."""
    runtime = rt.active()
    if (runtime is None or not runtime.kernel_path
            or not kops.kernel_available(base, dt)):
        return None
    block = runtime.kernel_block
    kkey = ("kern", block) + bkey if bkey is not None else None
    return _bound(kkey, functools.partial(kfactory, block))


# ----------------------------------------------------------------------- #
# multi-device tile decomposition (BLASX-style 2-D sharding)               #
#                                                                          #
# With more than one device tier, super-threshold calls split into tiles   #
# the scheduler deals round-robin with affinity across the tiers.  The     #
# decomposition is per routine: gemm tiles the output 2-D; symm/trmm/trsm  #
# split the rectangular panel along its free dimension (the triangle       #
# replicates); syrk/herk tile the stored triangle of C by block, diagonal  #
# blocks through the masked full product, off-diagonal ones through a      #
# gemm-shaped block product; syr2k/her2k ride the same triangle grid.      #
# Builders return None when the matrix is too small to split (tile_min),   #
# which leaves the call on the single-device path.                         #
# ----------------------------------------------------------------------- #
def _tile_min() -> int:
    """Minimum tile edge, from the active runtime's config."""
    runtime = rt.active()
    return runtime.config.tile_min if runtime is not None else 64


def _kernel_block() -> int:
    runtime = rt.active()
    return runtime.kernel_block if runtime is not None else 0


def _shard_active(batch: int, *arrays) -> bool:
    """Tile decomposition applies to plain 2-D calls only: a leading
    batch axis — even a singleton one — uses the batched kernels, whose
    axes the 2-D tile coordinates do not address."""
    runtime = rt.active()
    if runtime is None or batch != 1 or runtime.n_devices < 2:
        return False
    return all(x is None or x.dim() == 2 for x in arrays)


def _splits(dim: int, g: int) -> List[Tuple[int, int]]:
    """g contiguous block ranges covering [0, dim)."""
    base, rem = divmod(dim, g)
    edges = [0]
    for i in range(g):
        edges.append(edges[-1] + base + (1 if i < rem else 0))
    return [(edges[i], edges[i + 1]) for i in range(g)]


def _grid2d(n_dev: int, m: int, n: int) -> Optional[Tuple[int, int]]:
    """Near-square tile grid with >= n_dev tiles, clamped so no tile edge
    drops under the minimum; None when the call is too small to shard."""
    min_tile = _tile_min()
    gm = max(1, math.isqrt(n_dev))
    gn = -(-n_dev // gm)
    if n < m:                       # split the longer dimension more finely
        gm, gn = gn, gm
    gm = min(gm, max(1, m // min_tile))
    gn = min(gn, max(1, n // min_tile))
    if gm * gn < 2:
        return None
    return gm, gn


def _grid1d(n_dev: int, dim: int) -> Optional[int]:
    g = min(n_dev, max(1, dim // _tile_min()))
    return g if g >= 2 else None


def _assemble(blocks: List[List[torch.Tensor]]) -> torch.Tensor:
    rows = [row[0] if len(row) == 1 else torch.cat(row, dim=-1)
            for row in blocks]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=-2)


def _full_coords(x: torch.Tensor) -> Tuple[int, int, int, int]:
    return (0, x.shape[-2], 0, x.shape[-1])


def _rowblock_coords(x: torch.Tensor, trans: str,
                     r0: int, r1: int) -> Tuple[int, int, int, int]:
    """Coords on the parent for row block [r0:r1) of op(x)."""
    if trans == "N":
        return (r0, r1, 0, x.shape[-1])
    return (0, x.shape[-2], r0, r1)


def _colblock_coords(x: torch.Tensor, trans: str,
                     c0: int, c1: int) -> Tuple[int, int, int, int]:
    """Coords on the parent for column block [c0:c1) of op(x)."""
    if trans == "N":
        return (0, x.shape[-2], c0, c1)
    return (c0, c1, 0, x.shape[-1])


def _tile_mm(venue: str, precision: str):
    """The product a tile closure runs: a scheme's split product, the
    gemm kernel's entry on the pallas venue, else ``kops.matmul``."""
    if precision:
        return _split_matmul(precision, venue)
    if venue == "pallas":
        return functools.partial(kops.kernel_matmul, block=_kernel_block())
    return kops.matmul


def _shard_gemm(a, b, c, alpha, beta, trans_a, trans_b,
                n_dev, venue="xla", precision="") -> Optional[TilePlan]:
    m = a.shape[-2] if trans_a == "N" else a.shape[-1]
    n = b.shape[-1] if trans_b == "N" else b.shape[-2]
    g = _grid2d(n_dev, m, n)
    if g is None:
        return None
    gm, gn = g
    rows, cols = _splits(m, gm), _splits(n, gn)
    dt = a.dtype
    has_c = c is not None
    alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
    kw = dict(trans_a=trans_a, trans_b=trans_b,
              mm=_tile_mm(venue, precision))
    if has_c:
        def tile_fn(a_, b_, c_):
            return _gemm_kernel(a_, b_, c_, alpha_, beta_, **kw)
    else:
        def tile_fn(a_, b_):
            return _gemm_kernel(a_, b_, None, alpha_, beta_, **kw)
    tiles = []
    for (r0, r1) in rows:
        for (q0, q1) in cols:
            ops = [TileOp("A", a, _rowblock_coords(a, trans_a, r0, r1),
                          shared=(gm == 1)),
                   TileOp("B", b, _colblock_coords(b, trans_b, q0, q1),
                          shared=(gn == 1))]
            if has_c:
                ops.append(TileOp("C", c, (r0, r1, q0, q1), written=True))
            tiles.append(Tile(tuple(ops), tile_fn, (r0, r1, q0, q1)))

    def gather(outs):
        it = iter(outs)
        return _assemble([[next(it) for _ in cols] for _ in rows])

    return TilePlan((gm, gn), tuple(tiles), gather)


def _shard_symm(a, b, c, alpha, beta, side, uplo, conj,
                n_dev) -> Optional[TilePlan]:
    m, n = b.shape[-2], b.shape[-1]
    dim = n if side == "L" else m
    g = _grid1d(n_dev, dim)
    if g is None:
        return None
    panels = _splits(dim, g)
    dt = b.dtype
    alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
    kw = dict(side=side, uplo=uplo, conj=conj)
    if c is not None:
        def tile_fn(a_, b_, c_):
            return _symm_kernel(a_, b_, c_, alpha_, beta_, **kw)
    else:
        def tile_fn(a_, b_):
            return _symm_kernel(a_, b_, None, alpha_, beta_, **kw)
    tiles = []
    for (p0, p1) in panels:
        coords = (0, m, p0, p1) if side == "L" else (p0, p1, 0, n)
        ops = [TileOp("A", a, _full_coords(a), shared=True),
               TileOp("B", b, coords)]
        if c is not None:
            ops.append(TileOp("C", c, coords, written=True))
        tiles.append(Tile(tuple(ops), tile_fn, coords))

    def gather(outs):
        return torch.cat(outs, dim=-1 if side == "L" else -2)

    return TilePlan((1, g) if side == "L" else (g, 1), tuple(tiles), gather)


def _tri_blocks(n_dev: int, n: int) -> Optional[List[Tuple[int, int]]]:
    """Block ranges of the stored-triangle grid: the smallest g whose
    g(g+1)/2 stored blocks cover the tiers, clamped by the minimum tile
    edge; None when the call is too small to shard."""
    g = 2
    while g * (g + 1) // 2 < n_dev:
        g += 1
    g = min(g, max(1, n // _tile_min()))
    return _splits(n, g) if g >= 2 else None


def _tri_plan(blocks, uplo, c, dt, block_ops, diag_fn, off_fn) -> TilePlan:
    """The stored-triangle tiles of a syrk-like call, and the gather that
    fills the unreferenced triangle with C verbatim (or zeros)."""
    g = len(blocks)
    tiles, stored = [], {}
    for i in range(g):
        for j in range(g):
            if not (i >= j if uplo == "L" else i <= j):
                continue
            (r0, r1), (q0, q1) = blocks[i], blocks[j]
            coords = (r0, r1, q0, q1)
            ops = block_ops(i, j)
            if c is not None:
                ops.append(TileOp("C", c, coords, written=True))
            stored[(i, j)] = len(tiles)
            tiles.append(Tile(tuple(ops), diag_fn if i == j else off_fn,
                              coords))

    def gather(outs):
        home = outs[0].device
        grid = []
        for i in range(g):
            row = []
            for j in range(g):
                idx = stored.get((i, j))
                if idx is not None:
                    row.append(outs[idx])
                    continue
                (r0, r1), (q0, q1) = blocks[i], blocks[j]
                if c is not None:      # untouched triangle keeps C verbatim
                    row.append(c[r0:r1, q0:q1].to(device=home, dtype=dt))
                else:
                    row.append(torch.zeros((r1 - r0, q1 - q0), dtype=dt,
                                           device=home))
            grid.append(row)
        return _assemble(grid)

    return TilePlan((g, g), tuple(tiles), gather)


def _shard_syrk(a, c, alpha, beta, uplo, trans, conj,
                n_dev, venue="xla", precision="") -> Optional[TilePlan]:
    n = a.shape[-2] if trans == "N" else a.shape[-1]
    blocks = _tri_blocks(n_dev, n)
    if blocks is None:
        return None
    dt = a.dtype
    alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
    mm = _tile_mm(venue, precision)
    dkw = dict(uplo=uplo, trans=trans, conj=conj, mm=mm)
    okw = dict(trans=trans, conj=conj, mm=mm)
    if c is not None:
        def diag_fn(a_, c_):
            return _syrk_kernel(a_, c_, alpha_, beta_, **dkw)

        def off_fn(ai, aj, cij):
            return _syrk_block_kernel(ai, aj, cij, alpha_, beta_, **okw)
    else:
        def diag_fn(a_):
            return _syrk_kernel(a_, None, alpha_, beta_, **dkw)

        def off_fn(ai, aj):
            return _syrk_block_kernel(ai, aj, None, alpha_, beta_, **okw)

    def block_ops(i, j):
        ops = [TileOp("A", a, _rowblock_coords(a, trans, *blocks[i]))]
        if i != j:
            ops.append(TileOp("A", a,
                              _rowblock_coords(a, trans, *blocks[j])))
        return ops

    return _tri_plan(blocks, uplo, c, dt, block_ops, diag_fn, off_fn)


def _shard_syr2k(a, b, c, alpha, beta, uplo, trans, conj,
                 n_dev) -> Optional[TilePlan]:
    """syr2k/her2k on the syrk triangle grid: diagonal blocks run the
    full rank-2k closure on the matching op-row blocks of A and B,
    off-diagonal blocks the two-term block product."""
    n = a.shape[-2] if trans == "N" else a.shape[-1]
    blocks = _tri_blocks(n_dev, n)
    if blocks is None:
        return None
    dt = a.dtype
    alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
    dkw = dict(uplo=uplo, trans=trans, conj=conj)
    okw = dict(trans=trans, conj=conj)
    if c is not None:
        def diag_fn(a_, b_, c_):
            return _syr2k_kernel(a_, b_, c_, alpha_, beta_, **dkw)

        def off_fn(ai, bi, aj, bj, cij):
            return _syr2k_block_kernel(ai, bi, aj, bj, cij, alpha_, beta_,
                                       **okw)
    else:
        def diag_fn(a_, b_):
            return _syr2k_kernel(a_, b_, None, alpha_, beta_, **dkw)

        def off_fn(ai, bi, aj, bj):
            return _syr2k_block_kernel(ai, bi, aj, bj, None, alpha_,
                                       beta_, **okw)

    def block_ops(i, j):
        ops = [TileOp("A", a, _rowblock_coords(a, trans, *blocks[i])),
               TileOp("B", b, _rowblock_coords(b, trans, *blocks[i]))]
        if i != j:
            ops += [TileOp("A", a, _rowblock_coords(a, trans, *blocks[j])),
                    TileOp("B", b, _rowblock_coords(b, trans, *blocks[j]))]
        return ops

    return _tri_plan(blocks, uplo, c, dt, block_ops, diag_fn, off_fn)


def _shard_tri(a, b, side, uplo, trans, diag, alpha, kernel,
               n_dev, venue="xla", precision="") -> Optional[TilePlan]:
    """trmm/trsm: the RHS panel splits along its free dimension; each
    panel solve/multiply is independent, the triangle replicates."""
    m, n = b.shape[-2], b.shape[-1]
    dim = n if side == "L" else m
    g = _grid1d(n_dev, dim)
    if g is None:
        return None
    panels = _splits(dim, g)
    alpha_ = _scalar(alpha, b.dtype)
    flags = dict(side=side, uplo=uplo, trans=trans, diag=diag)
    if precision and kernel is _trsm_kernel:
        # split trsm panels: the same geometry, refined fp32 solves
        def tile_fn(a_, b_):
            return _split_trsm_kernel(a_, b_, alpha_, **flags,
                                      scheme=precision, venue=venue)
    elif venue == "pallas" and kernel is _trsm_kernel and alpha_ == 1:
        # the venue's lean solve (only trsm reaches the pallas venue)
        def tile_fn(a_, b_):
            return _trsm_klean(a_, b_, **flags)
    else:
        def tile_fn(a_, b_):
            return kernel(a_, b_, alpha_, **flags)
    tiles = []
    for (p0, p1) in panels:
        coords = (0, m, p0, p1) if side == "L" else (p0, p1, 0, n)
        tiles.append(Tile((TileOp("A", a, _full_coords(a), shared=True),
                           TileOp("B", b, coords, written=True)),
                          tile_fn, coords))

    def gather(outs):
        return torch.cat(outs, dim=-1 if side == "L" else -2)

    return TilePlan((1, g) if side == "L" else (g, 1), tuple(tiles), gather)


def _shard(builder, batch: int, arrays, *args):
    """A call's tile builder bound to its operands, or None when the call
    cannot shard (one tier, a batched call)."""
    if not _shard_active(batch, *arrays):
        return None
    return functools.partial(builder, *args)


# ----------------------------------------------------------------------- #
# public routines                                                          #
# ----------------------------------------------------------------------- #
def _dispatch(routine, m, n, k, operands, compute, batch=1, key=None,
              shard=None, kernel_compute=None, split_compute=None,
              split_check=None):
    runtime = rt.active()
    if runtime is None:
        return compute(*[x for _, x, _, _ in operands])
    return runtime.blas_call(routine, m, n, k, operands, compute,
                             batch=batch, key=key, shard=shard,
                             kernel_compute=kernel_compute,
                             split_compute=split_compute,
                             split_check=split_check)



def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
         *, alpha=1.0, beta=0.0, trans_a: str = "N",
         trans_b: str = "N") -> torch.Tensor:
    """C := alpha op(A) op(B) + beta C (the paper's headline routine)."""
    opm = a.shape[-2] if trans_a == "N" else a.shape[-1]
    opk = a.shape[-1] if trans_a == "N" else a.shape[-2]
    opn = b.shape[-1] if trans_b == "N" else b.shape[-2]
    batch = _batch_of(a, b, c)
    dt = a.dtype
    has_c = c is not None
    av, bv = _hashable(alpha), _hashable(beta)
    bkey = (("gemm", dt, trans_a, trans_b, has_c, av, bv)
            if av is not None and bv is not None else None)

    def build(mm):
        alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
        kw = dict(trans_a=trans_a, trans_b=trans_b, mm=mm)
        if has_c:
            def compute(a_, b_, c_):
                return _gemm_kernel(a_, b_, c_, alpha_, beta_, **kw)
        else:
            def compute(a_, b_):
                return _gemm_kernel(a_, b_, None, alpha_, beta_, **kw)
        return compute

    def kfactory(block):
        if (not has_c and av == 1 and bv == 0
                and trans_a == "N" and trans_b == "N"):
            # lean: no scalar epilogue
            return functools.partial(_gemm_klean, block=block)
        return build(functools.partial(kops.kernel_matmul, block=block))

    def sfactory(scheme, venue):
        return build(_split_matmul(scheme, venue))

    compute = _bound(bkey, functools.partial(build, kops.matmul))
    kernel_compute = _kernel_bound("gemm", dt, bkey, kfactory)
    flat2d = a.dim() == 2 and b.dim() == 2 and (c is None or c.dim() == 2)
    split_compute = _split_bound("gemm", dt, bkey, sfactory, flat2d)
    split_check = None
    if split_compute is not None:
        alpha_s, beta_s = _scalar(alpha, dt), _scalar(beta, dt)

        def split_check(out, a_, b_, c_=None):
            return prc.gemm_residual(out, _op(a_, trans_a),
                                     _op(b_, trans_b), c_, alpha_s, beta_s)
    ops = [("A", a, float(opn), False), ("B", b, float(opm), False)]
    if has_c:
        ops.append(("C", c, 1.0, True))
    shard = _shard(_shard_gemm, batch, (a, b, c), a, b, c, alpha, beta,
                   trans_a, trans_b)
    return _dispatch(routine_name("gemm", dt), opm, opn, opk, ops, compute,
                     batch, key=_call_key(bkey, opm, opn, opk, batch),
                     shard=shard, kernel_compute=kernel_compute,
                     split_compute=split_compute, split_check=split_check)


def _gemv_n(a, x):
    return ref.torch_matmul(a, x)


def _gemv_t(a, x):
    return ref.torch_matmul(a.mT, x)


def gemv(a: torch.Tensor, x: torch.Tensor, *, trans: str = "N"
         ) -> torch.Tensor:
    """y := op(A) x — the matrix-vector (level-2) interception surface.

    Matrix-vector products are recorded and counted as gemv-shaped calls
    and routed through the same dispatch pipeline with the ordinary
    threshold rule: N_avg = (m*n)^(1/3) sits below any level-3 threshold
    until the matrix alone is ~0.5 GB, so dispatch stays host at
    realistic sizes while the call is visible in every statistic.
    """
    m, n = a.shape[-2], a.shape[-1]
    opm, opn = (m, n) if trans == "N" else (n, m)
    dt = a.dtype
    bkey = ("gemv", dt, trans)
    compute = _gemv_t if trans == "T" else _gemv_n
    # A streams once; x is re-read for every one of the opm output rows.
    ops = [("A", a, 1.0, False), ("X", x, float(opm), False)]
    return _dispatch(routine_name("gemv", dt), opm, opn, 0, ops, compute,
                     key=_call_key(bkey, opm, opn, 0, 1))


def symm(a, b, c=None, *, side="L", uplo="L", alpha=1.0, beta=0.0):
    """C := alpha A B + beta C with A symmetric (one triangle referenced)."""
    return _symm_like(a, b, c, side=side, uplo=uplo, alpha=alpha,
                      beta=beta, conj=False, base="symm")


def hemm(a, b, c=None, *, side="L", uplo="L", alpha=1.0, beta=0.0):
    return _symm_like(a, b, c, side=side, uplo=uplo, alpha=alpha,
                      beta=beta, conj=True, base="hemm")


def _symm_like(a, b, c, *, side, uplo, alpha, beta, conj, base):
    m, n = b.shape[-2], b.shape[-1]
    batch = _batch_of(a, b, c)
    dt = b.dtype
    has_c = c is not None
    av, bv = _hashable(alpha), _hashable(beta)
    bkey = ((base, dt, side, uplo, has_c, av, bv)
            if av is not None and bv is not None else None)

    def factory():
        alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
        if has_c:
            def compute(a_, b_, c_):
                return _symm_kernel(a_, b_, c_, alpha_, beta_, side=side,
                                    uplo=uplo, conj=conj)
        else:
            def compute(a_, b_):
                return _symm_kernel(a_, b_, None, alpha_, beta_, side=side,
                                    uplo=uplo, conj=conj)
        return compute

    ops = [("A", a, float(n if side == "L" else m), False),
           ("B", b, float(a.shape[-1]), False)]
    if has_c:
        ops.append(("C", c, 1.0, True))
    shard = _shard(_shard_symm, batch, (a, b, c), a, b, c, alpha, beta,
                   side, uplo, conj)
    return _dispatch(routine_name(base, dt), a.shape[-1], n, 0, ops,
                     _bound(bkey, factory), batch,
                     key=_call_key(bkey, a.shape[-1], n, 0, batch),
                     shard=shard)


def syrk(a, c=None, *, uplo="L", trans="N", alpha=1.0, beta=0.0):
    """C := alpha op(A) op(A)^T + beta C, triangle ``uplo`` only."""
    return _syrk_like(a, c, uplo=uplo, trans=trans, alpha=alpha, beta=beta,
                      conj=False, base="syrk")


def herk(a, c=None, *, uplo="L", trans="N", alpha=1.0, beta=0.0):
    return _syrk_like(a, c, uplo=uplo, trans=trans, alpha=alpha, beta=beta,
                      conj=True, base="herk")


def _syrk_like(a, c, *, uplo, trans, alpha, beta, conj, base):
    n = a.shape[-2] if trans == "N" else a.shape[-1]
    k = a.shape[-1] if trans == "N" else a.shape[-2]
    batch = _batch_of(a, c)
    dt = a.dtype
    has_c = c is not None
    av, bv = _hashable(alpha), _hashable(beta)
    bkey = ((base, dt, uplo, trans, has_c, av, bv)
            if av is not None and bv is not None else None)

    def build(mm):
        alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
        kw = dict(uplo=uplo, trans=trans, conj=conj, mm=mm)
        if has_c:
            def compute(a_, c_):
                return _syrk_kernel(a_, c_, alpha_, beta_, **kw)
        else:
            def compute(a_):
                return _syrk_kernel(a_, None, alpha_, beta_, **kw)
        return compute

    def kfactory(block):
        if not has_c and av == 1 and bv == 0:
            def kcompute(a_):              # lean: no scalar epilogue
                return _syrk_klean(a_, uplo=uplo, trans=trans)
            return kcompute
        return build(functools.partial(kops.kernel_matmul, block=block))

    def sfactory(scheme, venue):
        return build(_split_matmul(scheme, venue))

    compute = _bound(bkey, functools.partial(build, kops.matmul))
    kernel_compute = _kernel_bound(base, dt, bkey, kfactory)
    flat2d = a.dim() == 2 and (c is None or c.dim() == 2)
    # no sampled-residual check for syrk: the rank-k update has no
    # cancellation channel beyond gemm's and the masked triangle defeats
    # the O(n^2) matvec probe; acceptance rests on the a-priori bound
    split_compute = _split_bound(base, dt, bkey, sfactory, flat2d)
    ops = [("A", a, float(n), False)]
    if has_c:
        ops.append(("C", c, 1.0, True))
    shard = _shard(_shard_syrk, batch, (a, c), a, c, alpha, beta, uplo,
                   trans, conj)
    return _dispatch(routine_name(base, dt), n, n, k, ops, compute, batch,
                     key=_call_key(bkey, n, n, k, batch), shard=shard,
                     kernel_compute=kernel_compute,
                     split_compute=split_compute)


def syr2k(a, b, c=None, *, uplo="L", trans="N", alpha=1.0, beta=0.0):
    return _syr2k_like(a, b, c, uplo=uplo, trans=trans, alpha=alpha,
                       beta=beta, conj=False, base="syr2k")


def her2k(a, b, c=None, *, uplo="L", trans="N", alpha=1.0, beta=0.0):
    return _syr2k_like(a, b, c, uplo=uplo, trans=trans, alpha=alpha,
                       beta=beta, conj=True, base="her2k")


def _syr2k_like(a, b, c, *, uplo, trans, alpha, beta, conj, base):
    n = a.shape[-2] if trans == "N" else a.shape[-1]
    k = a.shape[-1] if trans == "N" else a.shape[-2]
    batch = _batch_of(a, b, c)
    dt = a.dtype
    has_c = c is not None
    av, bv = _hashable(alpha), _hashable(beta)
    bkey = ((base, dt, uplo, trans, has_c, av, bv)
            if av is not None and bv is not None else None)

    def factory():
        alpha_, beta_ = _scalar(alpha, dt), _scalar(beta, dt)
        if has_c:
            def compute(a_, b_, c_):
                return _syr2k_kernel(a_, b_, c_, alpha_, beta_, uplo=uplo,
                                     trans=trans, conj=conj)
        else:
            def compute(a_, b_):
                return _syr2k_kernel(a_, b_, None, alpha_, beta_, uplo=uplo,
                                     trans=trans, conj=conj)
        return compute

    ops = [("A", a, float(n), False), ("B", b, float(n), False)]
    if has_c:
        ops.append(("C", c, 1.0, True))
    shard = _shard(_shard_syr2k, batch, (a, b, c), a, b, c, alpha, beta,
                   uplo, trans, conj)
    return _dispatch(routine_name(base, dt), n, n, k, ops,
                     _bound(bkey, factory), batch,
                     key=_call_key(bkey, n, n, k, batch), shard=shard)


def trmm(a, b, *, side="L", uplo="L", trans="N", diag="N", alpha=1.0):
    """B := alpha op(A) B (or B op(A)), A triangular."""
    return _tri_like(a, b, side=side, uplo=uplo, trans=trans, diag=diag,
                     alpha=alpha, base="trmm", kernel=_trmm_kernel)


def trsm(a, b, *, side="L", uplo="L", trans="N", diag="N", alpha=1.0):
    """Solve op(A) X = alpha B (or X op(A) = alpha B), A triangular."""
    return _tri_like(a, b, side=side, uplo=uplo, trans=trans, diag=diag,
                     alpha=alpha, base="trsm", kernel=_trsm_kernel)


def _tri_like(a, b, *, side, uplo, trans, diag, alpha, base, kernel):
    m, n = b.shape[-2], b.shape[-1]
    batch = _batch_of(a, b)
    dt = b.dtype
    av = _hashable(alpha)
    bkey = ((base, dt, side, uplo, trans, diag, av)
            if av is not None else None)
    flags = dict(side=side, uplo=uplo, trans=trans, diag=diag)

    def build(fn, **extra):
        alpha_ = _scalar(alpha, dt)

        def compute(a_, b_):
            return fn(a_, b_, alpha_, **flags, **extra)
        return compute

    def kfactory(block):
        del block                          # trsm's base edge is fixed
        if av == 1:
            def kcompute(a_, b_):          # lean: no alpha scaling
                return _trsm_klean(a_, b_, **flags)
            return kcompute
        return build(kernel)

    def sfactory(scheme, venue):
        return build(_split_trsm_kernel, scheme=scheme, venue=venue)

    compute = _bound(bkey, functools.partial(build, kernel))
    kernel_compute = _kernel_bound(base, dt, bkey, kfactory)
    flat2d = a.dim() == 2 and b.dim() == 2
    split_compute = (_split_bound(base, dt, bkey, sfactory, flat2d)
                     if base == "trsm" else None)
    split_check = None
    if split_compute is not None:
        alpha_s = _scalar(alpha, dt)

        def split_check(out, a_, b_):
            return prc.trsm_residual(out, ref.triangle(a_, uplo, diag), b_,
                                     left_side=(side == "L"),
                                     lower=(uplo == "L"),
                                     trans_a=(trans != "N"), alpha=alpha_s)
    tri_n = a.shape[-1]
    opn = n if side == "L" else m
    ops = [("A", a, float(opn), False),
           ("B", b, float(tri_n), True)]
    shard = _shard(_shard_tri, batch, (a, b), a, b, side, uplo, trans, diag,
                   alpha, kernel)
    return _dispatch(routine_name(base, dt), tri_n, opn, 0, ops, compute,
                     batch, key=_call_key(bkey, tri_n, opn, 0, batch),
                     shard=shard, kernel_compute=kernel_compute,
                     split_compute=split_compute, split_check=split_check)

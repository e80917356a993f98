"""Split-representation fp64 emulation (pilot study, arXiv 2503.22875).

The port's copy of ``repro/core/precision.py``.  The interception point
that moves data (the paper) is also the right place to rewrite precision:
an fp64 operand is decomposed into 2-3 lower-precision slices, the slice
cross products run as fp32 matrix products, and the partial products are
re-accumulated in fp64.  Accuracy degradation is opt-in and bounded,
never silent: every scheme carries a computed a-priori error bound
(:func:`error_bound`) and a cheap sampled-residual check
(:func:`gemm_residual` / :func:`trsm_residual`) that the runtime compares
against ``precision_rtol`` — a result that misses the bound escalates
back to native fp64.

Schemes
-------

``split2``
    ``x = hi + lo`` with two fp32 slices.  Three cross passes (``hi*hi``,
    ``hi*lo``, ``lo*hi``), each an fp32 product with fp32 accumulation,
    summed in fp64.  Bound ``~(k+12)*eps32`` relative to ``|A|@|B|``.

``split3``
    Adds a third bf16 slice of the remaining residual and three more
    cross passes, and chunks the contraction at ``SPLIT3_CHUNK`` columns
    with fp64 inter-chunk accumulation, which caps the accumulation term
    at ``~(256+24)*eps32`` independent of ``k``.

The pass primitive is injectable (``mm=``): the ``xla`` venue runs the
plain fp32 product (:func:`_plain_mm`, ``torch.matmul`` outside any
kernel, as the reference runs ``jnp.matmul``), the ``pallas`` venue the
gemm kernel (:mod:`repro_torch.kernels.split_gemm`).  Both must be true
fp32 products: the bounds assume them, so the plain product raises when
TF32 (or a lower float32 matmul precision) is allowed.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import ref

#: Schemes orderable by pass count; "auto" resolves to the cheapest
#: member whose a-priori bound meets the configured rtol.
SCHEMES = ("split2", "split3")

EPS32 = 2.0 ** -24
EPS64 = 2.0 ** -53

#: split3 contraction chunk: per-pass fp32 accumulation runs over at
#: most this many columns before the partial product is widened to
#: fp64, capping the accumulation error independently of k.
SPLIT3_CHUNK = 256

#: BLAS bases the split schemes implement.
SPLIT_BASES = ("gemm", "syrk", "trsm")

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: a whole split product ``(a, b, scheme) -> a @ b`` in fp64
Product = Callable[[torch.Tensor, torch.Tensor, str], torch.Tensor]


def supported(base: str, dtype: torch.dtype) -> bool:
    """True when ``base`` has a split formulation for ``dtype``: real
    fp64 only (fp32 inputs gain nothing; complex would need 4M on top)."""
    return base in SPLIT_BASES and dtype == torch.float64


def slices(x: torch.Tensor, scheme: str) -> Tuple[torch.Tensor, ...]:
    """Decompose an fp64 matrix into the scheme's low-precision slices.

    Every slice is fp32 (the bf16 third slice of split3 is rounded
    through bf16, then widened) and row-major contiguous, whatever the
    layout of ``x``, so its column chunks reach the gemm kernel as
    row-strided views, uncopied."""
    fmt = torch.contiguous_format
    hi = x.to(torch.float32, memory_format=fmt)
    rem = x - hi.double()
    lo = rem.to(torch.float32, memory_format=fmt)
    if scheme == "split2":
        return hi, lo
    if scheme == "split3":
        rem2 = rem - lo.double()
        tail = rem2.to(torch.bfloat16, memory_format=fmt).float()
        return hi, lo, tail
    raise ValueError(f"unknown split scheme: {scheme!r}")


#: Cross passes per scheme as (slice_i, slice_j) index pairs.  split2
#: drops lo*lo (below its accumulation floor); split3 keeps every term
#: that can reach the fp64 accumulation level.
_PASSES = {
    "split2": ((0, 0), (0, 1), (1, 0)),
    "split3": ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0)),
}


def _plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain fp32 pass: one library product, refused where it would
    not be a true fp32 product."""
    if (torch.get_float32_matmul_precision() != "highest"
            or (a.is_cuda and torch.backends.cuda.matmul.allow_tf32)):
        raise RuntimeError("split precision needs true float32 products: "
                           "TF32 (or a lower float32 matmul precision) is "
                           "allowed; set torch.backends.cuda.matmul."
                           "allow_tf32 = False and the float32 matmul "
                           "precision to 'highest'")
    return ref.torch_matmul(a, b)


def _pass_mm(a: torch.Tensor, b: torch.Tensor, mm: MatMul,
             chunk: int) -> torch.Tensor:
    """One slice cross product in fp64, fp32-accumulated per chunk."""
    if not chunk or a.shape[-1] <= chunk:
        return mm(a, b).double()
    k = a.shape[-1]
    out = None
    for c0 in range(0, k, chunk):
        p = mm(a[..., c0:c0 + chunk], b[c0:c0 + chunk, :])
        out = p.double() if out is None else out.add_(p)
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, scheme: str,
           mm: Optional[MatMul] = None) -> torch.Tensor:
    """``a @ b`` for fp64 2-D operands via split low-precision passes.
    ``mm`` is the fp32 pass primitive (default :func:`_plain_mm`)."""
    mm = mm or _plain_mm
    chunk = SPLIT3_CHUNK if scheme == "split3" else 0
    sa = slices(a, scheme)
    sb = slices(b, scheme)
    out = None
    for i, j in _PASSES[scheme]:
        p = _pass_mm(sa[i], sb[j], mm, chunk)
        out = p if out is None else out.add_(p)
    return out


def syrk(a: torch.Tensor, scheme: str, trans: bool = False,
         mm: Optional[MatMul] = None) -> torch.Tensor:
    """``a @ a.T`` (or ``a.T @ a``) via the split matmul."""
    at = a.mT
    return matmul(at, a, scheme, mm) if trans else matmul(a, at, scheme, mm)


def _solve32(a32: torch.Tensor, rhs: torch.Tensor, *, left_side: bool,
             lower: bool, trans_a: bool, unit_diag: bool) -> torch.Tensor:
    """The fp32 triangular solve of ``op(A) X = rhs`` (left) or
    ``X op(A) = rhs`` (right), as ``lax.linalg.triangular_solve``
    (the library solve, as the reference's)."""
    am, upper = a32, not lower
    if trans_a:
        am, upper = a32.mT, lower
    return torch.linalg.solve_triangular(am, rhs.float(), upper=upper,
                                         left=left_side,
                                         unitriangular=unit_diag)


def trsm(a: torch.Tensor, b: torch.Tensor, scheme: str, *,
         left_side: bool = True, lower: bool = True, trans_a: bool = False,
         unit_diag: bool = False, mm: Optional[MatMul] = None,
         product: Optional[Product] = None) -> torch.Tensor:
    """Triangular solve via fp32 solve + one split-residual refinement.

    ``X0 = solve32(A, B)`` seeds the solution, the residual
    ``R = B - op(A) X0`` is formed with the split matmul (so no fp64
    product sneaks in), and one fp32 correction solve is added back.
    ``product`` runs that whole split product (the fused kernel of
    ``kernels/split_gemm.py``); without it :func:`matmul` runs it on
    ``mm``."""
    a32 = a.float()
    kw = dict(left_side=left_side, lower=lower, trans_a=trans_a,
              unit_diag=unit_diag)
    if product is None:
        def product(x, y, s):
            return matmul(x, y, s, mm)

    def apply_a(x):
        am = a.mT if trans_a else a
        if left_side:
            return product(am, x, scheme)
        return product(x, am, scheme)

    x = _solve32(a32, b, **kw).double()
    r = b - apply_a(x)
    return x + _solve32(a32, r, **kw).double()


def error_bound(scheme: str, k: int, base: str = "gemm") -> float:
    """A-priori relative error bound of an accepted split result,
    relative to the ``(|A| @ |B|)`` inner-product scale (trsm: four times
    the gemm-level bound, a modest conditioning allowance)."""
    k = max(1, int(k))
    if scheme == "split2":
        bound = (k + 12) * EPS32
    elif scheme == "split3":
        bound = (min(k, SPLIT3_CHUNK) + 24) * EPS32
    else:
        raise ValueError(f"unknown split scheme: {scheme!r}")
    if base == "trsm":
        bound *= 4.0
    return bound


def choose(scheme: str, base: str, k: int, rtol: float) -> str:
    """Resolve a configured scheme for one call: ``auto`` picks the
    cheapest scheme whose a-priori bound fits ``rtol`` (or native, the
    empty string, when none does); explicit schemes are refused up front
    when their own bound cannot fit."""
    if scheme == "auto":
        for cand in SCHEMES:
            if error_bound(cand, k, base) <= rtol:
                return cand
        return ""
    if scheme in SCHEMES:
        return scheme if error_bound(scheme, k, base) <= rtol else ""
    return ""


def probe_vector(n: int, device=None) -> torch.Tensor:
    """Deterministic +-1 probe for the sampled-residual check."""
    signs = torch.ones(n, dtype=torch.float64, device=device)
    signs[1::2] = -1.0
    return signs


def _rel(err_vec: torch.Tensor, ref_vec: torch.Tensor) -> float:
    denom = ref_vec.abs().max().item() + 1e-300
    return err_vec.abs().max().item() / denom


def gemm_residual(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: Optional[torch.Tensor], alpha, beta) -> float:
    """Sampled forward-error estimate of a split GEMM result: one fp64
    matvec chain (O(n^2), against the O(n^3) call) compares ``out @ x``
    with ``(alpha op(A) op(B) + beta C) @ x``, relative to the
    reference's magnitude, so catastrophic cancellation shows up as a
    large value and triggers escalation."""
    mv = ref.torch_matmul
    x = probe_vector(out.shape[-1], out.device)
    want = alpha * mv(a, mv(b, x))
    if c is not None:
        want = want + beta * mv(c, x)
    return _rel(mv(out, x) - want, want)


def trsm_residual(x_out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  *, left_side: bool = True, lower: bool = True,
                  trans_a: bool = False, alpha=1.0) -> float:
    """Sampled forward-error estimate of a split triangular solve
    ``op(A) X = alpha B`` (left) or ``X op(A) = alpha B`` (right): the
    probe residual is back-solved through ``op(A)`` (an O(n^2) vector
    solve), turning the backward residual into a forward-error estimate
    on ``X`` itself."""
    mv = ref.torch_matmul
    am = a.mT if trans_a else a
    upper = (not lower) != trans_a
    if left_side:
        v = probe_vector(x_out.shape[-1], x_out.device)
        r = mv(am, mv(x_out, v)) - alpha * mv(b, v)
        err = torch.linalg.solve_triangular(am, r[:, None], upper=upper)
        return _rel(err[:, 0], mv(x_out, v))
    v = probe_vector(x_out.shape[0], x_out.device)
    r = mv(mv(v, x_out), am) - alpha * mv(v, b)
    err = torch.linalg.solve_triangular(am, r[None, :], upper=upper,
                                        left=False)
    return _rel(err[0], mv(v, x_out))

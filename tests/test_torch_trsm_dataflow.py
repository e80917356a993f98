"""The trsm kernel's block-row order against the JAX reference on the CPU.

``repro_torch.kernels.trsm.trsm_dataflow_plain`` is the arithmetic of the
one-launch kernel (``csrc/trsm.cu``) in plain PyTorch: 64-row block rows,
each taking ``R'_i = B_i - sum_{j<i-1} L_ij X_j`` one ``j`` at a time,
then ``X_i = L_ii^-1 R'_i - (L_ii^-1 L_i,i-1) X_{i-1}`` with the diagonal
block inverted by substitution on the identity.  These tests feed the same numpy inputs to it and to the JAX
package's ``repro.kernels.ref.trsm`` (XLA's triangular solve).  The kernel
itself is held to ``trsm_dataflow_plain`` on the card (``-m cuda`` tests in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances, relative to max|reference|, and why:
float64 — diagonally dominant triangles (condition ~1): both sides are
          float64 solves whose errors grow like m*eps64 ~ 3e-14 at m = 300
float32 — the same in float32: m*eps32 ~ 2e-5 at m = 300 in the worst
          case, ~1e-6 typically
LU factors — the unit-lower factor of a random matrix is not diagonally
          dominant (condition ~5e2 at m = 300): any backward-stable
          solve's forward error is at most ~cond(L) * eps times a modest
          factor, so the limit is 20 * cond(L) * eps of the dtype, for the
          inverse of the kernel's diagonal blocks as for substitution.
"""
import numpy as np
import pytest
import scipy.linalg

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import trsm  # noqa: E402

TOL = {"float64": 1e-12, "float32": 2e-5}
SHAPES = [(m, n) for m in (1, 63, 64, 65, 300) for n in (1, 32, 40)]
VARIANTS = [(side, uplo, trans, diag) for side in "LR" for uplo in "LU"
            for trans in "NT" for diag in "NU"]


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _tri(rng, n, uplo):
    """Diagonally dominant triangle, as tests/test_kernels.py builds it,
    with garbage in the other triangle, which no solve may read."""
    a = rng.standard_normal((n, n)) / n
    np.fill_diagonal(a, 1.0 + np.abs(np.diag(a)))
    junk = rng.standard_normal((n, n))
    return (np.tril(a) + np.triu(junk, 1) if uplo == "L"
            else np.triu(a) + np.tril(junk, -1))


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _reference(a, b, uplo, **kw):
    """The reference's solve on the referenced triangle only."""
    a = np.tril(a) if uplo == "L" else np.triu(a)
    return np.asarray(jref.trsm(jnp.asarray(a), jnp.asarray(b), uplo=uplo,
                                **kw))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("side,uplo,trans,diag", VARIANTS)
def test_dataflow_order_matches_reference(side, uplo, trans, diag, dtype):
    """Every variant at m in {1, 63, 64, 65, 300} (one block row, a
    ragged one, exactly one, one row over, five) and n in {1, 32, 40}
    (one column, one panel, a ragged second panel)."""
    rng = np.random.default_rng(VARIANTS.index((side, uplo, trans, diag)))
    kw = dict(side=side, trans=trans, diag=diag)
    for m, n in SHAPES:
        a = _tri(rng, m if side == "L" else n, uplo).astype(dtype)
        b = rng.standard_normal((m, n)).astype(dtype)
        want = _reference(a, b, uplo, **kw)
        got = trsm.trsm_dataflow_plain(torch.as_tensor(a),
                                       torch.as_tensor(b), uplo=uplo, **kw)
        assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
        assert _rel(got, want) <= TOL[dtype], (m, n)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dataflow_order_batched(dtype):
    rng = np.random.default_rng(5)
    a = np.stack([_tri(rng, 130, "L") for _ in range(3)]).astype(dtype)
    b = rng.standard_normal((3, 130, 40)).astype(dtype)
    for trans in "NT":
        want = _reference(a, b, "L", trans=trans)
        got = trsm.trsm_dataflow_plain(torch.as_tensor(a),
                                       torch.as_tensor(b), trans=trans)
        assert got.shape == (3, 130, 40)
        assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [300, 1000])
def test_dataflow_order_on_lu_factor(m, dtype):
    """The unit-lower triangle of scipy's LU factor of a seeded randn:
    entries up to 1 in magnitude, condition in the hundreds to
    thousands."""
    rng = np.random.default_rng(m)
    _, lf, _ = scipy.linalg.lu(rng.standard_normal((m, m)))
    b = rng.standard_normal((m, 32))
    cond = np.linalg.cond(lf)
    tol = 20 * cond * np.finfo(dtype).eps
    want = _reference(lf.astype(dtype), b.astype(dtype), "L", diag="U")
    got = trsm.trsm_dataflow_plain(torch.as_tensor(lf.astype(dtype)),
                                   torch.as_tensor(b.astype(dtype)),
                                   diag="U")
    assert _rel(got, want) <= tol
    exact = scipy.linalg.solve_triangular(lf, b, lower=True,
                                          unit_diagonal=True)
    assert _rel(got, exact) <= tol


def test_diagonal_step_is_the_blocks_inverse():
    """The kernel's diagonal step: each 64-row diagonal block inverted by
    substitution on the identity, the last block padded with it."""
    rng = np.random.default_rng(2)
    for unit in (False, True):
        a = _tri(rng, 150, "L")
        inv = trsm._diag_inverses(torch.as_tensor(a), unit=unit).numpy()
        assert inv.shape == (3, 64, 64)
        lt = np.tril(a, -1) + (np.eye(150) if unit else np.diag(np.diag(a)))
        for blk, i in enumerate(range(0, 150, 64)):
            e = min(i + 64, 150)
            want = np.linalg.inv(lt[i:e, i:e])
            assert _rel(inv[blk, :e - i, :e - i], want) <= 1e-13
            assert np.array_equal(inv[blk, e - i:, e - i:],
                                  np.eye(64 - (e - i)))
            assert not np.triu(inv[blk], 1).any()


def test_cpu_solve_is_the_kernels_plain_order():
    """On CPU tensors trsm.trsm computes exactly what the kernel's plain
    version computes, and launches nothing."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(_tri(rng, 200, "U"))
    b = torch.as_tensor(rng.standard_normal((24, 200)))
    kw = dict(side="R", uplo="U", trans="T", diag="N")
    launched, memsets = trsm.launches, trsm.memsets
    assert torch.equal(trsm.trsm(a, b, **kw),
                       trsm.trsm_dataflow_plain(a, b, **kw))
    assert (trsm.launches, trsm.memsets) == (launched, memsets)


@pytest.mark.parametrize("m,n,batch,want", [
    (6912, 32, 1, 108), (300, 40, 1, 10), (1, 1, 1, 1), (65, 33, 3, 12)])
def test_work_units(m, n, batch, want):
    """Blocks of one launch: 64-row block rows x 32-column panels x
    batch (the main path's 6912 x 32 solve: 108 blocks on 132 SMs)."""
    assert trsm.units(m, n, batch) == want

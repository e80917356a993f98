"""The trsm kernel's block-row orders against the JAX reference on the CPU.

``repro_torch.kernels.trsm.trsm_dataflow_plain`` is the arithmetic of the
kernel's one-launch dataflow path (``csrc/trsm.cu``) in plain PyTorch:
64-row block rows, each taking ``R'_i = B_i - sum_{j<i-1} L_ij X_j`` one
``j`` at a time, then ``X_i = L_ii^-1 R'_i - (L_ii^-1 L_i,i-1) X_{i-1}``
with the diagonal block inverted by substitution on the identity.
``trsm._wide_lower`` is its wide path's order, which ``trsm.trsm`` takes on
CPU tensors wherever ``trsm.plan`` says wide: the same inverses once, then
128-row block rows, ``R = B_I - L_I,<I X_<I`` in one product, ``X_a = W_a
R_a``, ``X_b = W_b R_b - (W_b L_ba) X_a``.  These tests feed the same
numpy inputs to them and to the JAX package's ``repro.kernels.ref.trsm``
(XLA's triangular solve).  Either path of the kernel is held to
``trsm_dataflow_plain`` on the card (``-m cuda`` tests in
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
#: right-hand sides that take the wide path: 133 panels of 128, the last
#: ragged
WIDE_N = 132 * 128 + 37
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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("side,uplo,trans,diag", VARIANTS)
def test_wide_order_matches_reference(side, uplo, trans, diag, dtype):
    """Every variant at m 200 (a ragged second block row of 64 + 8 rows)
    with :data:`WIDE_N` right-hand sides: ``trsm.trsm`` on the CPU takes
    the wide order, within TOL of the reference's solve, and of the TPU
    wrapper's recursion (``trsm_plain``) on the last 300 right-hand sides
    (the solve is independent per right-hand side; the recursion's
    substitution steps are slow at full width)."""
    rng = np.random.default_rng(100 + VARIANTS.index((side, uplo, trans,
                                                      diag)))
    kw = dict(side=side, uplo=uplo, trans=trans, diag=diag)
    m = 200
    shape = (m, WIDE_N) if side == "L" else (WIDE_N, m)
    a = torch.as_tensor(_tri(rng, m, uplo).astype(dtype))
    b = torch.as_tensor(rng.standard_normal(shape).astype(dtype))
    assert trsm.plan(m, WIDE_N, 1) == (True, 133)
    got = trsm.trsm(a, b, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    want = _reference(a.numpy(), b.numpy(), uplo, side=side, trans=trans,
                      diag=diag)
    assert _rel(got, want) <= TOL[dtype]
    tail = (slice(None), slice(-300, None)) if side == "L" else (
        slice(-300, None), slice(None))
    assert _rel(got[tail], trsm.trsm_plain(a, b[tail], **kw)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wide_order_batched(dtype):
    """Three problems of 44 ragged panels each, 132 blocks: wide; m 130
    has three diagonal blocks, so its last block row has no second half."""
    rng = np.random.default_rng(6)
    n = 44 * 128 - 5
    a = np.stack([_tri(rng, 130, "L") for _ in range(3)]).astype(dtype)
    b = rng.standard_normal((3, 130, n)).astype(dtype)
    assert trsm.plan(130, n, 3) == (True, 132)
    for trans in "NT":
        want = _reference(a, b, "L", trans=trans)
        got = trsm.trsm(torch.as_tensor(a), torch.as_tensor(b), trans=trans)
        assert got.shape == (3, 130, n)
        assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wide_order_on_lu_factor(dtype):
    """The unit-lower triangle of an LU factor at m 300, as the dataflow
    order's test: ``trsm.trsm`` on the CPU is exactly the wide order, and
    within 20 cond(L) eps of the reference and of scipy."""
    m = 300
    rng = np.random.default_rng(m + 1)
    _, lf, _ = scipy.linalg.lu(rng.standard_normal((m, m)))
    b = rng.standard_normal((m, 132 * 128))
    tol = 20 * np.linalg.cond(lf) * np.finfo(dtype).eps
    lt = torch.as_tensor(lf.astype(dtype))
    bt = torch.as_tensor(b.astype(dtype))
    got = trsm.trsm(lt, bt, diag="U")
    assert torch.equal(got, trsm._wide_lower(lt, bt, unit=True))
    want = _reference(lf.astype(dtype), b.astype(dtype), "L", diag="U")
    assert _rel(got, want) <= tol
    exact = scipy.linalg.solve_triangular(lf, b, lower=True,
                                          unit_diagonal=True)
    assert _rel(got, exact) <= tol


@pytest.mark.parametrize("m,n,batch,want", [
    (2400, 93536, 1, (True, 731)),      # CheFSI's Psi R^-1, canonical
    (256, 6656, 1, (False, 832)),       # potrf's first panel solve
    (6912, 32, 1, (False, 108)),        # getrs's solves
    (6912, 256, 1, (False, 864)),       # the tier's 6912 x 256
    (64, 131 * 128, 1, (False, 524)),   # 131 panels: one SM short
    (64, 131 * 128 + 1, 1, (True, 132)),
    (130, 5627, 3, (True, 132))])
def test_plan_picks_the_path(m, n, batch, want):
    """The wide path exactly where its 128-column panels (times the
    batch) reach the 132 SMs; the dataflow path's blocks otherwise."""
    assert trsm.plan(m, n, batch) == want

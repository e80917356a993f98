"""The port's blocked LAPACK drivers (``core/lapack.py``,
``solvers/drivers.py``, ``solvers/eigen.py``) against the reference's on
the same numpy inputs, and against the scipy oracles, at the reference
tests' sizes and tolerances (tests/test_solvers.py:29-130)."""
import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import lapack as jlapack  # noqa: E402
from repro.solvers import drivers as jdrivers  # noqa: E402

from repro_torch.core import lapack  # noqa: E402
from repro_torch.solvers import drivers  # noqa: E402

DTYPES = ("float32", "float64", "complex64", "complex128")


def _tol(dtype) -> float:
    """The reference tests' tolerance (tests/test_solvers.py:29-31)."""
    return 5e-3 if np.finfo(np.dtype(dtype)).eps > 1e-10 else 1e-9


def _rng(seed):
    return np.random.default_rng(seed)


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return np.asarray(x, dtype=dtype)


def _diag_dominant(rng, n, dtype):
    return np.asarray(_rand(rng, (n, n), dtype) / n + np.eye(n), dtype=dtype)


def _hpd(rng, n, dtype):
    g = _rand(rng, (n, n), dtype) / n
    return np.asarray(g @ g.conj().T + np.eye(n), dtype=dtype)


def _hermitian(rng, n, dtype):
    g = _rand(rng, (n, n), dtype)
    return np.asarray((g + g.conj().T) / 2, dtype=dtype)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("shape,nb", [
    ((7, 7), 3), ((10, 6), 4), ((6, 10), 4),
    ((130, 70), 48), ((70, 130), 48), ((100, 100), 48),
])
def test_getrf_matches_reference(shape, nb):
    """Rectangular inputs and ragged last blocks: the same absolute
    pivots as repro.core.lapack.getrf, the factors within 1e-12 (two
    float64 eliminations of the same matrix in the same order), and
    A[piv] == L @ U."""
    m, n = shape
    a = _rand(_rng(1), shape, "float64")
    jlu, jpiv = jlapack.getrf(jnp.asarray(a), nb=nb)
    lu, piv = lapack.getrf(_t(a), nb=nb)
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), atol=1e-12)
    k = min(m, n)
    low = np.tril(lu.numpy()[:, :k], -1) + np.eye(m, k)
    up = np.triu(lu.numpy()[:k, :])
    np.testing.assert_allclose(a[piv.numpy()], low @ up, atol=1e-10)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gesv_matches_reference(dtype):
    rng = _rng(2)
    a, b = _diag_dominant(rng, 96, dtype), _rand(rng, (96, 7), dtype)
    want = np.asarray(jdrivers.gesv(jnp.asarray(a), jnp.asarray(b), nb=32))
    got = drivers.gesv(_t(a), _t(b), nb=32).numpy()
    np.testing.assert_allclose(got, want, atol=_tol(dtype))
    np.testing.assert_allclose(got, np.linalg.solve(a, b), atol=_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", ("L", "U"))
def test_potrf_potrs_match_reference(dtype, uplo):
    rng = _rng(3)
    a, b = _hpd(rng, 80, dtype), _rand(rng, (80, 5), dtype)
    jf = jdrivers.potrf(jnp.asarray(a), nb=32, uplo=uplo)
    f = drivers.potrf(_t(a), nb=32, uplo=uplo)
    assert not f.is_conj() and f.is_contiguous()
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=_tol(dtype))
    fn = f.numpy()
    tri = np.tril(fn) if uplo == "L" else np.triu(fn)
    rebuilt = tri @ tri.conj().T if uplo == "L" else tri.conj().T @ tri
    np.testing.assert_allclose(rebuilt, a, atol=_tol(dtype))
    want = np.asarray(jdrivers.potrs(jf, jnp.asarray(b), uplo=uplo))
    x = drivers.potrs(f, _t(b), uplo=uplo).numpy()
    np.testing.assert_allclose(x, want, atol=_tol(dtype))
    np.testing.assert_allclose(x, np.linalg.solve(a, b), atol=_tol(dtype))


#: the eigensolver parity size: the reference's syev runs eagerly and
#: compiles every column's shapes (~0.5 s a column on the CPU), so its
#: calls here share one order and block size (n 36, nb 24: panels of 24
#: and 11), at or under the reference tests' own (n 40-67, nb 16-24)
EIG_N, EIG_NB = 36, 24


@pytest.mark.parametrize("dtype", DTYPES)
def test_syev_matches_reference(dtype):
    """Eigenvalues against the reference's syev and scipy; the vectors
    through their residual and orthogonality, as the reference test
    checks them (two runs of the same algorithm may pick a vector's sign
    differently only at a degenerate eigenvalue)."""
    a = _hermitian(_rng(4), EIG_N, dtype)
    jw, _ = jdrivers.syev(jnp.asarray(a), nb=EIG_NB)
    w, s = drivers.syev(_t(a), nb=EIG_NB)
    assert w.dtype == torch.empty(0, dtype=getattr(torch, dtype)).real.dtype
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=_tol(dtype))
    np.testing.assert_allclose(w.numpy(), sla.eigh(a, eigvals_only=True),
                               atol=_tol(dtype))
    sn, wn = s.numpy(), w.numpy()
    np.testing.assert_allclose(a @ sn, sn * wn, atol=20 * _tol(dtype))
    np.testing.assert_allclose(sn.conj().T @ sn, np.eye(EIG_N),
                               atol=_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_syev_oracle_at_the_reference_size(dtype):
    """The port's syev at the reference test's size (n 67, nb 24)
    against scipy: eigenvalues, residual and orthogonality."""
    a = _hermitian(_rng(14), 67, dtype)
    w, s = drivers.syev(_t(a), nb=24)
    np.testing.assert_allclose(w.numpy(), sla.eigh(a, eigvals_only=True),
                               atol=_tol(dtype))
    sn, wn = s.numpy(), w.numpy()
    np.testing.assert_allclose(a @ sn, sn * wn, atol=20 * _tol(dtype))
    np.testing.assert_allclose(sn.conj().T @ sn, np.eye(67),
                               atol=_tol(dtype))


def test_syev_uplo_u_ignores_lower_garbage():
    """uplo="U" reads only the upper triangle (LAPACK's convention), as
    the reference's syev does."""
    rng = _rng(5)
    a = _hermitian(rng, EIG_N, "complex128")
    dirty = np.array(a)
    low = np.tril_indices(EIG_N, -1)
    dirty[low] = rng.standard_normal(len(low[0])) * 1e3
    w, _ = drivers.syev(_t(dirty), nb=EIG_NB, uplo="U")
    jw, _ = jdrivers.syev(jnp.asarray(dirty), nb=EIG_NB, uplo="U")
    np.testing.assert_allclose(w.numpy(), sla.eigh(a, eigvals_only=True),
                               atol=1e-9)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-9)

"""The solver tier's capturable panel against the eager panel it replaces
and against the JAX package, on the CPU.

The reference jits its unblocked panel (``repro/core/lapack.py:45-81``,
one ``fori_loop``); the port's counterpart is a CUDA graph of
``core/lapack.py`` ``_pivot_panel``, whose column loop therefore reads
nothing on the host and writes its pivots into a device tensor.  Here:

* the capturable loop against the eager loop it replaced (kept below as
  ``_eager_panel``, the code of the previous revision): factors and
  pivots bit for bit, in float32, float64, complex64 and complex128;
* zero rows below a panel (the card's padding up to a bucket height)
  change none of its bits, also where an infinite pivot row or an
  overflowing reciprocal turns them NaN (they are left out of the pivot
  search);
* the same panel against the reference's jitted ``_pivot_panel`` at
  square and tall shapes, with ties in modulus (the first row of
  largest modulus wins, ``jnp.argmax``'s rule, not LAPACK's |re| + |im|)
  and a zero-pivot column (scale 0): pivots equal, factors within 1e-5
  (float32, complex64) or 1e-12 (float64, complex128) of the largest
  entry, the roundings of XLA's fused updates against PyTorch's;
* ``getrf`` at square, tall and wide shapes against the reference's:
  pivots equal, factors within 1e-12 (float64) or 1e-4 (complex64) of
  the largest entry: the trailing products sum up to 96 terms in another
  order, ~n eps = 5.7e-6 in float32 per entry before the element growth
  of a random matrix (a few times);
* no ``item``/``tolist``/``bool``/``int``/``float``/``index`` inside a
  panel;
* a ``lapack=True`` session: the trace's calls, the per-routine and
  per-solver counters equal a live reference session's, each ``getf2``
  operand its own panel's buffer id.

The card's capture and replay are ``tests/test_torch_cuda_lapack_graph.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core import lapack as jlapack  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import lapack  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402

DTYPES = ["float32", "float64", "complex64", "complex128"]
TOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12,
       "complex128": 1e-12}


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return np.asarray(x, dtype=dtype)


def _panel(rng, m, nb, dtype):
    """A panel whose first column ties in modulus (3 at rows 5, 2 and 9,
    as 3, -3 and 3i for complex types) above entries of modulus < 1, and
    whose column 3 is zero (it stays zero through the updates: its pivot
    is 0, its scale 0)."""
    p = _rand(rng, (m, nb), dtype) * 0.1
    cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
    p[5, 0], p[2, 0], p[9, 0] = 3, -3, (3j if cplx else 3)
    p[:, 3] = 0
    return p


def _eager_panel(p):
    """The column loop as it ran before it was made capturable."""
    m, nb = p.shape
    rows = torch.arange(m, device=p.device)
    piv = torch.empty(nb, dtype=torch.int64, device=p.device)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    for j in range(nb):
        r = torch.argmax(p[j:, j].abs()) + j
        piv[j] = r
        pair = torch.stack((rows[j], r))
        p.index_copy_(0, pair.flip(0), p.index_select(0, pair))
        pivval = p[j, j]
        scale = torch.where(pivval != 0, pivval.reciprocal(), zero)
        col = p[j + 1:, j]
        col.mul_(scale)
        p[j + 1:, j + 1:].sub_(col[:, None] * p[j, j + 1:][None, :])
    return piv.tolist()


def _port_panel(x, m_real=None):
    p = torch.from_numpy(x.copy())
    piv = torch.empty(x.shape[1], dtype=torch.int64)
    lapack._pivot_panel(p, piv, None if m_real is None
                        else torch.tensor(m_real))
    return p, piv.tolist()


@pytest.mark.parametrize("shape", [(48, 48), (160, 32), (97, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_capturable_panel_equals_the_eager_panel(dtype, shape):
    x = _panel(np.random.default_rng(1), *shape, dtype)
    got, gpiv = _port_panel(x)
    want = torch.from_numpy(x.copy())
    wpiv = _eager_panel(want)
    assert gpiv == wpiv
    assert torch.equal(got, want)
    # the CPU entry point getrf calls runs the same loop
    again = torch.from_numpy(x.copy())
    assert lapack._factor_panel(again) == wpiv
    assert torch.equal(again, want)


@pytest.mark.parametrize("pad", [1, 7, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_rows_below_a_panel_change_no_bit(dtype, pad):
    """The card pads a panel with zero rows up to its bucket's height
    (``lapack.BUCKETS``) and leaves them out of the pivot search
    (``m_real``); they stay zero on finite values, so the panel's rows
    and pivots are bit for bit the unpadded loop's, with the search left
    unmasked too."""
    x = _panel(np.random.default_rng(6), 97, 16, dtype)
    want, wpiv = _port_panel(x)
    padded = np.concatenate([x, np.zeros((pad, 16), x.dtype)])
    for m_real in (97, None):
        got, gpiv = _port_panel(padded, m_real)
        assert gpiv == wpiv
        assert torch.equal(got[:97], want)
        assert not got[97:].any()


@pytest.mark.parametrize("case", ["inf_in_the_pivot_row",
                                  "subnormal_pivot"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_padding_is_left_out_of_the_pivot_search(dtype, case):
    """An infinite entry in a pivot row, or a subnormal pivot whose
    reciprocal overflows, turns the zero padding NaN (0 * inf), and a
    NaN wins ``argmax``: with ``m_real`` the padded panel's rows and
    pivots are byte for byte the unpadded loop's (its infinities and
    NaNs included); without it a padded row is taken as a pivot."""
    x = _rand(np.random.default_rng(7), (97, 16), dtype)
    if case == "inf_in_the_pivot_row":
        x[5, 0] = 9                     # column 0's pivot
        x[5, 1] = np.inf
    else:
        tiny = np.finfo(dtype).tiny
        x[:, 0] *= tiny / 1024          # all subnormal
        x[5, 0] = tiny / 16             # 1 / pivot overflows
    want, wpiv = _port_panel(x)
    assert not torch.isfinite(want).all()
    padded = np.concatenate([x, np.zeros((7, 16), x.dtype)])
    got, gpiv = _port_panel(padded, 97)
    assert gpiv == wpiv
    assert got[:97].numpy().tobytes() == want.numpy().tobytes()
    _, unmasked = _port_panel(padded)
    assert max(unmasked) >= 97          # the control: a padded pivot


@pytest.mark.parametrize("shape", [(48, 48), (160, 32)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_matches_the_reference(dtype, shape):
    x = _panel(np.random.default_rng(2), *shape, dtype)
    got, gpiv = _port_panel(x)
    jp, jpiv = jlapack._pivot_panel(jnp.asarray(x))
    want = np.asarray(jp)
    assert gpiv == np.asarray(jpiv).tolist()
    assert gpiv[0] == 2         # the first of the three rows of modulus 3
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL[dtype]
    # column 3 was zero on and below the diagonal: no pivot row beyond 3,
    # and the scale of a zero pivot is 0 (no inf, no nan)
    assert gpiv[3] == 3
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy()[4:, 3]).max() == 0


@pytest.mark.parametrize("shape", [(96, 96), (128, 64), (64, 112)])
@pytest.mark.parametrize("dtype", ["float64", "complex64"])
def test_getrf_matches_the_reference(dtype, shape):
    x = _rand(np.random.default_rng(3), shape, dtype)
    lu, piv = lapack.getrf(torch.from_numpy(x.copy()), nb=32)
    jlu, jpiv = jlapack.getrf(jnp.asarray(x), nb=32)
    assert piv.tolist() == np.asarray(jpiv).tolist()
    want = np.asarray(jlu)
    err = np.abs(lu.numpy() - want).max() / np.abs(want).max()
    assert err <= (1e-12 if dtype == "float64" else 1e-4)


class _HostReads:
    """Makes every read of a tensor's value into Python raise while
    armed: ``item``, ``tolist``, ``bool``, ``int``, ``float``, ``index``."""
    NAMES = ("item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self, monkeypatch):
        self.armed = False
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, real))

    def _guard(self, name, real):
        def read(t, *args, **kw):
            if self.armed:
                raise AssertionError(f"Tensor.{name} inside the panel")
            return real(t, *args, **kw)
        return read


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_panel_reads_nothing_on_the_host(dtype, monkeypatch):
    x = _panel(np.random.default_rng(4), 64, 24, dtype)
    p = torch.from_numpy(x.copy())
    piv = torch.empty(24, dtype=torch.int64)
    guard = _HostReads(monkeypatch)
    guard.armed = True
    try:
        lapack._pivot_panel(p, piv)
    finally:
        guard.armed = False
    want = torch.from_numpy(x.copy())
    assert piv.tolist() == _eager_panel(want)
    assert torch.equal(p, want)


def test_session_trace_and_counters_equal_the_reference():
    """A lapack=True session's LU (three panel heights at nb 32): the
    trace's (routine, m, n, k, solver_id), the per-routine (calls,
    offloaded, on_host) and per-solver (spans, calls, panel_calls)
    against a live reference session, and one buffer id per panel."""
    x = _rand(np.random.default_rng(5), (96, 96), "float64") / 96 \
        + np.eye(96)
    cfg = dict(lapack=True, threshold=32.0, lapack_nb=32)

    def summary(s):
        st, trace = s.runtime.stats, s.runtime.trace
        return ([(c.routine, c.m, c.n, c.k, c.solver_id) for c in trace],
                {k: (v.calls, v.offloaded, v.on_host)
                 for k, v in st.per_routine.items()},
                {k: (v.spans, v.calls, v.panel_calls)
                 for k, v in st.solvers.items()},
                [c.operands[0][1] for c in trace
                 if c.routine.endswith("getf2")])

    import jax.scipy.linalg as jsl
    with repro.session(JConfig(**cfg)) as s:
        jlu, _ = jsl.lu_factor(jnp.asarray(x))
        jsum = summary(s)
    with repro_torch.session(OffloadConfig(**cfg), device="cpu") as s:
        lu, _ = torch.linalg.lu_factor(torch.from_numpy(x))
        tsum = summary(s)
    assert tsum[:3] == jsum[:3]
    assert tsum[2]["getrf"] == (1, 7, 3)
    assert len(tsum[3]) == 3 and len(set(tsum[3])) == 3
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), atol=1e-12)

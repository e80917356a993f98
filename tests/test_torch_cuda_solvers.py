"""The solver tier on the card: the same drivers and intercepted surface
as on the CPU, with the tier's updates on the port's kernels.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import OffloadConfig  # noqa: E402
from repro_torch.core import host_array, lapack  # noqa: E402
from repro_torch.kernels import gemm, trsm  # noqa: E402
from repro_torch.solvers import drivers  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return np.asarray(x, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("shape,nb", [((300, 300), 64), ((257, 130), 32),
                                      ((130, 257), 32)])
def test_getrf_on_the_card_equals_the_cpu(dev, dtype, shape, nb):
    """The panel on the card (pivot on the device, one host copy of the
    pivots per panel) picks the CPU's pivots, and the factors agree to
    float64 rounding; A[piv] == L @ U."""
    a = _rand(np.random.default_rng(0), shape, dtype)
    lu_c, piv_c = lapack.getrf(torch.as_tensor(a), nb=nb)
    lu_d, piv_d = lapack.getrf(torch.as_tensor(a, device=dev), nb=nb)
    assert lu_d.device.type == "cuda" and piv_d.device.type == "cuda"
    assert torch.equal(piv_d.cpu(), piv_c)
    np.testing.assert_allclose(lu_d.cpu().numpy(), lu_c.numpy(),
                               atol=1e-12)
    m, n = shape
    k = min(m, n)
    lu = lu_d.cpu().numpy()
    low = np.tril(lu[:, :k], -1) + np.eye(m, k)
    np.testing.assert_allclose(a[piv_c.numpy()], low @ np.triu(lu[:k, :]),
                               atol=1e-10)


def test_lapack_session_on_the_card_counts_like_the_cpu(dev):
    """torch.linalg.solve / cholesky / cholesky_solve / eigh under a
    lapack session on the card: the trace's sequence and the per-solver
    counters equal a CPU session's on the same inputs; the real updates
    launch gemm.cu and trsm.cu; the results match the CPU's."""
    rng = np.random.default_rng(1)
    n = 200
    a = _rand(rng, (n, n), "float64") / n + np.eye(n)
    b = _rand(rng, (n, 4), "float64")
    g = _rand(rng, (n, n), "float64") / n
    spd = g @ g.T + np.eye(n)
    h = _rand(rng, (96, 96), "float64")
    herm = (h + h.T) / 2
    out = {}
    for where in ("cpu", dev):
        gemm.reset_launches()
        trsm.reset_launches()
        with repro_torch.session(OffloadConfig(lapack=True, threshold=64.0,
                                               lapack_nb=48),
                                 device=where) as s:
            t = {k: torch.as_tensor(v, device=where) for k, v in
                 dict(a=a, b=b, spd=spd, herm=herm).items()}
            x = torch.linalg.solve(t["a"], t["b"])
            f = torch.linalg.cholesky(t["spd"])
            y = torch.cholesky_solve(t["b"], f)
            w, v = torch.linalg.eigh(t["herm"])
            s.sync()
            out[str(where)] = dict(
                seq=[(c.routine, c.m, c.n, c.k, c.solver_id)
                     for c in s.trace],
                solvers={k: (sv.spans, sv.calls, sv.panel_calls)
                         for k, sv in s.stats.solvers.items()},
                res=[r.cpu().numpy() for r in (x, y, w)],
                launches=(gemm.launches, trsm.launches))
    cpu, card = out["cpu"], out[str(dev)]
    assert card["seq"] == cpu["seq"]
    assert card["solvers"] == cpu["solvers"]
    assert card["launches"][0] > 0 and card["launches"][1] > 0
    for got, want in zip(card["res"], cpu["res"]):
        np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_allclose(card["res"][0], np.linalg.solve(a, b),
                               atol=1e-10)


def test_host_factor_is_pinned_once_on_the_card(dev):
    """A host_array factor (pinned CPU memory) reaches the card once, at
    the span's pin; the factor comes back on the card."""
    rng = np.random.default_rng(2)
    a = _rand(rng, (160, 160), "complex128") / 160 + np.eye(160)
    with repro_torch.session(OffloadConfig(lapack=True, threshold=64.0,
                                           lapack_nb=32), device=dev) as s:
        lu, piv = torch.linalg.lu_factor(host_array(a))
        assert lu.device.type == "cuda"
        assert s.stats.solvers["getrf"].moved_bytes == 0
        assert s.trace.event_count("place") >= 1
    lu_c, piv_c = drivers.getrf(torch.as_tensor(a), nb=32)
    assert torch.equal(piv.cpu(), piv_c)
    np.testing.assert_allclose(lu.cpu().numpy(), lu_c.numpy(), atol=1e-12)

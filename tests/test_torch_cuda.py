"""The port's CUDA kernels and main path on the card.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import OffloadConfig  # noqa: E402
from repro_torch.core import blas, host_array  # noqa: E402
from repro_torch.kernels import gemm, ops, ref, trsm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, want):
    return ((got.to(want.dtype) - want).abs().max()
            / want.abs().max()).item()


def _tri(n, dtype, dev):
    """Diagonally dominant lower triangle, as tests/test_kernels.py."""
    a = torch.randn(n, n, dtype=torch.float64).tril() / n
    a.diagonal().copy_(1.0 + a.diagonal().abs())
    return a.to(dtype).to(dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2),
                                       (torch.float16, 5e-2),
                                       (torch.float64, 1e-10)])
def test_gemm_kernel_matches_plain_version(dev, dtype, tol):
    """Ragged edges, a batch, a row-strided view; tolerances as in
    chip_smoke.py (float32: IEEE sums, sqrt(K)*eps32 ~ 1e-6 expected)."""
    a = torch.randn(3, 301, 170, device=dev).to(dtype)
    b = torch.randn(3, 170, 93, device=dev).to(dtype)
    launched = gemm.launches
    assert _rel(gemm.gemm(a, b), gemm.gemm_plain(a, b)) <= tol
    view = a[0, :, 10:150]                  # row stride 170, no copy
    assert _rel(gemm.gemm(view, b[0, :140]),
                gemm.gemm_plain(view, b[0, :140])) <= tol
    assert gemm.launches == launched + 2
    if dtype in (torch.bfloat16, torch.float16):
        out = gemm.gemm(a[0], b[0], out_dtype=torch.float32)
        assert out.dtype == torch.float32


def test_gemm_kernel_refuses_what_it_does_not_take(dev):
    a = torch.randn(8, 8, device=dev)
    with pytest.raises(TypeError):
        gemm.gemm(a, a.double())
    with pytest.raises(ValueError):
        gemm.gemm(a[:, ::2], a[:4])         # neither dim has unit stride
    with pytest.raises(TypeError):
        gemm.gemm(a.to(torch.int32), a.to(torch.int32))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("side,uplo,trans,diag", [
    ("L", "L", "N", "N"), ("L", "U", "T", "U"), ("R", "L", "T", "N"),
    ("R", "U", "N", "U")])
def test_trsm_matches_plain_version(dev, dtype, tol, side, uplo, trans,
                                    diag):
    a = _tri(300, dtype, dev)
    if uplo == "U":
        a = a.mT.contiguous()
    b = (torch.randn(300, 40, device=dev) if side == "L"
         else torch.randn(40, 300, device=dev)).to(dtype)
    kw = dict(side=side, uplo=uplo, trans=trans, diag=diag)
    launched = trsm.launches
    assert _rel(trsm.trsm(a, b, **kw), trsm.trsm_plain(a, b, **kw)) <= tol
    assert trsm.launches > launched


def test_batched_trsm_and_complex_product(dev):
    a = torch.stack([_tri(200, torch.float64, dev) for _ in range(3)])
    b = torch.randn(3, 200, 16, dtype=torch.float64, device=dev)
    assert _rel(trsm.trsm(a, b), ref.trsm(a, b)) <= 1e-10
    za = torch.randn(130, 70, dtype=torch.complex128, device=dev)
    zb = torch.randn(70, 50, dtype=torch.complex128, device=dev)
    assert _rel(ops.matmul(za, zb), ref.matmul(za, zb)) <= 1e-10


def test_session_on_card_places_once_and_launches(dev):
    rng = np.random.default_rng(0)
    a = host_array(rng.standard_normal((600, 600)), torch.float64)
    assert a.device.type == "cpu" and a.is_pinned()
    launched = gemm.launches
    with repro_torch.session(OffloadConfig(threshold=100.0)) as s:
        c = a @ a
        d = blas.gemm(a, c, trans_a="T")
        s.sync()
        st = s.stats.per_routine["dgemm"]
        assert (st.calls, st.offloaded, st.bytes_in) == (2, 2, 600 * 600 * 8)
        assert c.device.type == "cuda"
    assert gemm.launches >= launched + 2
    an = a.numpy()
    np.testing.assert_allclose(d.cpu().numpy(), an.T @ (an @ an),
                               rtol=1e-10, atol=1e-9)

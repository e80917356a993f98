"""The port's syrk kernel, split passes and kernel venue on the card.

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
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.kernels import split_gemm, syrk  # noqa: E402

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
def test_syrk_kernel_matches_plain_version(dev, dtype, tol, uplo, trans):
    """Ragged n and k, both layouts, a batch and a row-strided view; the
    other triangle stays zero; tolerances as in chip_smoke.py."""
    n, k = 301, 170
    shape = (n, k) if trans == "N" else (k, n)
    a = torch.randn(2, *shape, device=dev).to(dtype)
    launched = syrk.launches
    got = syrk.syrk(a, uplo=uplo, trans=trans)
    want = syrk.syrk_plain(a, uplo=uplo, trans=trans)
    torch.cuda.synchronize()
    assert syrk.launches == launched + 1
    assert _rel(got, want) <= tol
    other = got.triu(1) if uplo == "L" else got.tril(-1)
    assert not bool(other.any())
    view = a[0, :, 10:150] if trans == "N" else a[0, 10:150]
    assert _rel(syrk.syrk(view, uplo=uplo, trans=trans),
                syrk.syrk_plain(view, uplo=uplo, trans=trans)) <= tol


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("n,k", [(301, 9001), (1000, 50001)])
def test_syrk_float64_splits_k_in_a_fixed_order(dev, uplo, trans, n, k):
    """float64 on DMMA with K split across blocks (2 and 7 ranges; n not a
    multiple of the 128-wide tile, k not a multiple of the range): within
    1e-10 of the plain version, the other triangle zero, one launch
    counted per call, and two calls equal bit for bit (the partials are
    summed in split order, without atomics)."""
    assert syrk.plan(n, k).splits > 1
    shape = (n, k) if trans == "N" else (k, n)
    a = torch.randn(*shape, dtype=torch.float64, device=dev)
    launched = syrk.launches
    got = syrk.syrk(a, uplo=uplo, trans=trans)
    again = syrk.syrk(a, uplo=uplo, trans=trans)
    torch.cuda.synchronize()
    assert syrk.launches == launched + 2
    assert _rel(got, syrk.syrk_plain(a, uplo=uplo, trans=trans)) <= 1e-10
    assert torch.equal(got, again)
    other = got.triu(1) if uplo == "L" else got.tril(-1)
    assert not bool(other.any())


def test_split_passes_run_the_gemm_kernel_within_bound(dev):
    """split3 at k = 1000 in the fused split kernel: two launches (the
    passes, the reduction) and no gemm launch; the error relative to
    |A||B| stays within the bound."""
    from repro_torch.kernels import gemm
    a = torch.randn(48, 1000, dtype=torch.float64, device=dev)
    b = torch.randn(1000, 40, dtype=torch.float64, device=dev)
    launched, gemms = split_gemm.launches, gemm.launches
    out = split_gemm.matmul(a.mT.contiguous().mT, b, "split3")
    assert split_gemm.launches == launched + 2
    assert gemm.launches == gemms
    scale = a.abs() @ b.abs()
    err = ((out - a @ b).abs() / scale).max().item()
    assert err <= prec.error_bound("split3", 1000)


def test_session_races_the_syrk_venue_on_the_card(dev):
    """An adaptive kernel-path session on the card: the warmup probes
    host/xla/pallas, the pallas probes launch the syrk kernel, the site
    locks, and every result is the plain version's."""
    rng = np.random.default_rng(0)
    psi = host_array(rng.standard_normal((4000, 300)), torch.float64)
    cfg = OffloadConfig(policy="dfu", threshold=50.0, kernel_path=True,
                        adaptive=True, adaptive_warmup=6)
    want = syrk.syrk_plain(psi.to(dev), trans="T")
    launched = syrk.launches
    with repro_torch.session(cfg) as s:
        outs = [blas.syrk(psi, trans="T") for _ in range(8)]
        s.sync()
        (prof,) = list(s.runtime.callsites)
        venues = [c.venue for c in s.trace.calls]
    assert venues[:6] == ["host", "xla", "pallas"] * 2
    assert prof.locked is not None and prof.kernel_timed == 2
    assert syrk.launches >= launched + 2
    for out in outs:
        assert _rel(out, want) <= 1e-10

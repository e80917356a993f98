"""The port's syrk kernel module against the JAX reference.

On the CPU the wrapper takes its plain version (``syrk_plain``), which is
held here to the TPU kernel itself, run interpreted
(``repro.kernels.syrk.syrk(..., interpret=True)``), over uplo x trans x
the three shapes of ``tests/test_kernels.py::test_syrk``.  The CUDA
kernel is held to the same plain version on the card by
``tests/test_torch_cuda_venue.py`` (``cuda``-marked, no JAX) and by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.syrk import syrk as pallas_syrk  # noqa: E402
from repro_torch.kernels import compat, ops, ref, syrk  # noqa: E402

RNG = np.random.default_rng(17)

#: tolerances of max|port - reference|: float32 — the reference test's
#: 2e-3 (float32 sums of up to 256 terms in different orders, ~K*eps32
#: of |A|^2 ~ 256); float64 — both sum in float64, ~K*eps64*|A|^2
TOL = {"float32": 2e-3, "float64": 1e-12}


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("n,k", [(200, 130), (128, 256), (65, 33)])
def test_plain_version_matches_interpreted_pallas(dtype, uplo, trans, n, k):
    shape = (n, k) if trans == "N" else (k, n)
    a = RNG.standard_normal(shape).astype(dtype)
    want = np.asarray(pallas_syrk(jnp.asarray(a), uplo=uplo, trans=trans,
                                  interpret=True))
    launched = syrk.launches
    got = syrk.syrk(torch.as_tensor(a), uplo=uplo, trans=trans)
    assert syrk.launches == launched        # the CPU route launches nothing
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    # the other triangle is exactly zero, as the TPU kernel returns it
    other = np.triu(got.numpy(), 1) if uplo == "L" else np.tril(
        got.numpy(), -1)
    assert not other.any()


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
def test_ref_syrk_matches_reference(dtype):
    a = RNG.standard_normal((3, 40, 24))
    if dtype == "complex128":
        a = a + 1j * RNG.standard_normal(a.shape)
    a = a.astype(dtype)
    for uplo in "LU":
        for trans in "NT":
            want = np.asarray(jref.syrk(jnp.asarray(a), uplo=uplo,
                                        trans=trans))
            got = ref.syrk(torch.as_tensor(a), uplo=uplo, trans=trans)
            tol = 1e-5 if dtype == "float32" else 1e-12
            np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                       atol=tol)


def test_ops_syrk_takes_transposed_views_uncopied():
    """A transposed view of a row-major matrix flips ``trans`` instead of
    being copied, so a Psi^T operand reaches the kernel as Psi."""
    psi = torch.as_tensor(RNG.standard_normal((300, 40)))
    view, tr = ops._syrk_operand(psi.mT, "N")
    assert tr == "T" and view.data_ptr() == psi.data_ptr()
    assert view.stride() == psi.stride()
    want = ref.syrk(psi, uplo="L", trans="T")
    for x, t in ((psi, "T"), (psi.mT, "N")):
        assert torch.equal(ops.syrk(x, uplo="L", trans=t), want)
        assert torch.equal(ops.kernel_syrk(x, uplo="L", trans=t), want)


def test_complex_syrk_goes_to_library():
    a = torch.as_tensor(RNG.standard_normal((20, 9))
                        + 1j * RNG.standard_normal((20, 9)))
    launched = syrk.launches
    assert torch.equal(ops.syrk(a, uplo="U"), ref.syrk(a, uplo="U"))
    assert syrk.launches == launched


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        syrk.syrk(a)


def test_source_names_the_tpu_kernel_and_is_built_with_the_others():
    text = compat.sources()["syrk"].read_text()
    assert "src/repro/kernels/syrk.py:_syrk_kernel" in text
    assert "What bounds it" in text and "Design" in text
    assert compat.library_path("syrk").parent == compat.BUILD_DIR

"""The frozen counts against hand values (PARSEC's shapes, Tables 5-6;
LSMS's at n 6912)."""
import pytest

from portbench import counts


def test_parsec_dgemm_counts_and_bound():
    flops, nbytes = counts.gemm(32, 2400, 93536, "float64")
    assert flops == pytest.approx(1.43671e10, rel=1e-5)
    # Psi read once dominates: 8 (32 K + K 2400 + 32 2400) bytes
    assert nbytes == 8 * (32 * 93536 + 93536 * 2400 + 32 * 2400)
    assert counts.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.5434,
                                                                 rel=1e-4)


def test_parsec_gram_counts_and_bound():
    flops, nbytes = counts.syrk(2400, 93536, "float64")
    assert flops == pytest.approx(5.3899e11, rel=1e-4)
    assert counts.bound_s(flops, nbytes) * 1e3 == pytest.approx(8.0447,
                                                                 rel=1e-4)


def test_parsec_sweep_operations():
    """A step is one block's 46 products; a filter sweep is 75 steps."""
    step = 46 * counts.gemm(32, 2400, 93536, "float64")[0]
    assert step == pytest.approx(6.60887e11, rel=1e-5)
    assert 75 * step == pytest.approx(4.95665e13, rel=1e-5)


def test_lsms_step_operations():
    n = 6912
    zgemm = counts.gemm(n, n, n, "complex128")[0]
    assert zgemm == 8.0 * n ** 3
    assert counts.bound_s(*counts.gemm(n, n, n, "complex128")) == \
        pytest.approx(8.0 * n ** 3 / 67e12)
    assert counts.getrf(n, "complex128") == pytest.approx(8.0 * n ** 3 / 3)
    assert counts.getrs(n, 32, "complex128") == 8.0 * n * n * 32
    step = zgemm + counts.getrf(n, "complex128") + counts.getrs(
        n, 32, "complex128")
    assert step == pytest.approx(3.534e12, rel=1e-3)


@pytest.mark.parametrize("fn,args", [(counts.gemm, (2, 2, 2)),
                                     (counts.syrk, (2, 2)),
                                     (counts.getrf, (2,)),
                                     (counts.getrs, (2, 1))])
def test_unknown_dtype_refused(fn, args):
    with pytest.raises(ValueError):
        fn(*args, "bfloat16")

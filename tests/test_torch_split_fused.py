"""The fused split kernel's routing, the gemm kernel's plan and layouts,
and the ported ``kernel_block``, on the CPU.

On CPU tensors ``split_gemm.matmul`` takes its plain version (the passes
of ``core/precision.py`` on the gemm kernel's plain fp32 product), so the
same numpy inputs go through the JAX package's
``repro.kernels.split_gemm.matmul`` and the port's, and both are held to
the a-priori bound.  The gemm kernel's path choice (``gemm.plan``) and
its layout reading (``gemm.layout``) are arithmetic on shapes, strides
and addresses, so they are checked here; the kernels themselves run in
``tests/test_torch_cuda_gemm.py`` on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro.kernels import split_gemm as jsplit  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, host_array  # noqa: E402
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.kernels import gemm, ops, split_gemm  # noqa: E402

#: exact-pass operands against their exact product (chip_smoke.py)
EXACT_PASS_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _scaled(out, a, b):
    return np.max(np.abs(out - a @ b)) / np.max(np.abs(a) @ np.abs(b))


@pytest.mark.parametrize("scheme", ["split2", "split3"])
@pytest.mark.parametrize("k", [1, 255, 256, 257, 1000])
def test_split_matmul_matches_reference_within_bound(scheme, k):
    """The same numpy inputs, A given as a transposed view: both packages
    within the a-priori bound of the exact product, and within it of
    each other."""
    rng = np.random.default_rng(k)
    at = rng.standard_normal((k, 24))            # A = at.T, a view
    b = rng.standard_normal((k, 18))
    a = at.T
    got = split_gemm.matmul(torch.from_numpy(at).mT, torch.from_numpy(b),
                            scheme).numpy()
    want = np.asarray(jsplit.matmul(jnp.asarray(at).T, jnp.asarray(b),
                                    scheme))
    bound = prec.error_bound(scheme, k)
    assert bound == jprec.error_bound(scheme, k)
    assert _scaled(got, a, b) <= bound
    assert _scaled(want, a, b) <= bound
    assert np.max(np.abs(got - want)) / np.max(np.abs(a) @ np.abs(b)) \
        <= bound


def _exact_pass_pair(m, k, n, seed=11):
    """Exact-pass operands (as chip_smoke.py builds them) and their
    exact product, in numpy."""
    rng = np.random.default_rng(seed)

    def parts(rows, cols):
        def pick(scale):
            return (1.0 + 0.5 * rng.integers(0, 2, (rows, cols))) * scale
        return (2.0 * rng.integers(0, 2, (rows, cols)) - 1.0, pick(1.0),
                pick(2.0 ** -25), pick(2.0 ** -51))
    sa, ha, la, ta = parts(m, k)
    sb, hb, lb, tb = parts(k, n)
    h, c = k // 2, n // 2
    sa[:, h:2 * h], ha[:, h:2 * h] = sa[:, :h], ha[:, :h]
    sb[h:2 * h, :c], hb[h:2 * h, :c] = -sb[:h, :c], hb[:h, :c]
    pa = [sa * x for x in (ha, la, ta)]
    pb = [sb * x for x in (hb, lb, tb)]
    exact = np.zeros((m, n))
    for i, j in sorted(((i, j) for i in range(3) for j in range(3)),
                       key=lambda p: -sum(p)):
        exact += pa[i] @ pb[j]
    return sum(pa), sum(pb), exact


@pytest.mark.parametrize("k", [257, 1000])
def test_split3_exact_pass_operands_both_packages(k):
    a, b, exact = _exact_pass_pair(16, k, 12)
    denom = np.max(np.abs(exact), axis=0)

    def colrel(got):
        return np.max(np.max(np.abs(got - exact), axis=0) / denom)
    got = split_gemm.matmul(torch.from_numpy(a), torch.from_numpy(b),
                            "split3").numpy()
    want = np.asarray(jsplit.matmul(jnp.asarray(a), jnp.asarray(b),
                                    "split3"))
    assert colrel(got) <= EXACT_PASS_TOL
    assert colrel(want) <= EXACT_PASS_TOL


def test_split_syrk_and_trsm_route_through_matmul(monkeypatch):
    """split syrk is matmul(A^T, A); split trsm's refinement product is
    the whole split product of split_gemm.matmul (the fused kernel on the
    card), not a pass primitive."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((300, 20)))
    t = torch.from_numpy(np.tril(rng.standard_normal((20, 20))) / 20
                         + 2 * np.eye(20))
    rhs = torch.from_numpy(rng.standard_normal((20, 7)))
    seen = []
    real = split_gemm.matmul

    def spy(x, y, scheme):
        seen.append((tuple(x.shape), tuple(y.shape), scheme))
        return real(x, y, scheme)
    monkeypatch.setattr(split_gemm, "matmul", spy)
    g = split_gemm.syrk(a, "split3", trans=True)
    an = a.numpy()
    assert _scaled(g.numpy(), an.T, an) <= prec.error_bound("split3", 300)
    x = split_gemm.trsm(t, rhs, "split3")
    resid = np.max(np.abs(t.numpy() @ x.numpy() - rhs.numpy()))
    assert resid <= prec.error_bound("split3", 20, "trsm") * np.max(
        np.abs(rhs.numpy()))
    assert seen == [((20, 300), (300, 20), "split3"),
                    ((20, 20), (20, 7), "split3")]


def test_fused_entry_refuses_cpu_tensors():
    a = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        split_gemm.fused(a, a, "split3")
    assert split_gemm.splits_for(32, 2400, 93536) == 27
    assert split_gemm.splits_for(2400, 2400, 93536) == 1


def test_layout_reads_transposed_views_uncopied():
    t = torch.zeros(10, 24)
    assert gemm.layout(t) == (False, 24)
    assert gemm.layout(t.mT) == (True, 24)
    assert gemm.layout(t[:, 2:20]) == (False, 24)
    assert gemm.layout(t[:, ::2]) is None
    assert gemm.layout(torch.zeros(1, 5)) == (False, 8)
    stack = torch.zeros(3, 10, 24)
    assert gemm.layout(stack.mT) == (True, 24)
    assert gemm.layout(stack.expand(3, 10, 24)[:, :, :4]) == (False, 24)
    assert gemm.layout(torch.zeros(10, 24).expand(3, 10, 24)) is None


def test_vocab_head_passes_the_table_view_uncopied(monkeypatch):
    """ops.matmul(x, table.mT), the tied vocab head, hands the gemm
    wrapper the table's own storage as a transposed view."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(50, 16, generator=gen)
    x = torch.randn(2, 3, 16, generator=gen)
    seen = []
    real = ops.gemm

    def spy(a, b):
        seen.append((b.data_ptr(), gemm.layout(b), tuple(b.shape)))
        return real(a, b)
    monkeypatch.setattr(ops, "gemm", spy)
    out = ops.matmul(x, table.mT)
    assert seen == [(table.data_ptr(), (True, 16), (16, 50))]
    torch.testing.assert_close(out, x @ table.T)


def _bf16(*shape, align_off=0):
    x = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    return x[align_off:align_off + int(np.prod(shape))].view(*shape)


def test_plan_picks_each_path():
    """Tensor cores for aligned 16-bit operands at M >= 64, the skinny
    path below 64 rows or where TMA cannot describe an operand, DMMA for
    float64 (path 3 from 64 rows, path 5 below), FMA for float32; decode
    widths split K."""
    w = _bf16(3584, 2048)
    assert gemm.plan(_bf16(9216, 3584), w) == (gemm.TC, 256, 1)
    assert gemm.plan(_bf16(64, 3584), w).path == gemm.TC
    p = gemm.plan(_bf16(2, 3584), w)
    assert p.path == gemm.SKINNY and p.tile == 0 and p.splits == 28
    assert gemm.plan(_bf16(2, 3584), _bf16(3584, 14336)).splits == 5
    table = _bf16(256000, 3584)
    assert gemm.plan(_bf16(2, 3584), table.mT) == (gemm.SKINNY, 0, 1)
    assert gemm.plan(_bf16(9216, 3584), table.mT).path == gemm.TC
    assert gemm.plan(_bf16(200, 170), _bf16(170, 93)).path == gemm.SKINNY
    assert gemm.plan(_bf16(200, 136, align_off=1),
                     _bf16(136, 96)).path == gemm.SKINNY
    d = torch.zeros(8, 8, dtype=torch.float64)
    assert gemm.plan(d, d) == (gemm.SKINNY_F64, 0, 1)
    d64 = torch.zeros(64, 8, dtype=torch.float64)
    assert gemm.plan(d64, d) == (gemm.DMMA, 128, 1)
    assert gemm.plan(d.float(), d.float(), 64) == (gemm.SIMT, 64, 1)
    assert gemm.plan(_bf16(9216, 3584), w, 128) == (gemm.TC, 128, 1)


def test_kernel_block_is_checked_and_inert_on_cpu():
    a = torch.randn(20, 30, dtype=torch.float64)
    want = gemm.gemm(a, a.mT)
    for block in gemm.EDGES:
        assert torch.equal(gemm.gemm(a, a.mT, block=block), want)
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        gemm.gemm(a, a.mT, block=96)
    with pytest.raises(ValueError, match="kernel_block=96"):
        repro_torch.session(OffloadConfig(kernel_block=96), device="cpu")
    with repro_torch.session(device="cpu") as s:
        with pytest.raises(ValueError, match="kernel_block=256"):
            s.reconfigure(kernel_block=256)


def test_kernel_block_reaches_the_gemm_wrapper(monkeypatch):
    """kernel_block of the session reaches gemm.gemm on the pallas venue
    (lean and epilogue closures), and not on the xla venue."""
    rng = np.random.default_rng(4)
    a = host_array(rng.standard_normal((48, 32)).astype(np.float32))
    b = host_array(rng.standard_normal((32, 40)).astype(np.float32))
    seen = []
    real = gemm.gemm

    def spy(x, y, **kw):
        seen.append(kw.get("block", 0))
        return real(x, y, **kw)
    monkeypatch.setattr(ops, "gemm", spy)
    for kernel_path in (True, False):
        cfg = OffloadConfig(policy="dfu", threshold=1.0, sync=True,
                            kernel_path=kernel_path, kernel_block=64)
        with repro_torch.session(cfg, device="cpu", intercept=False) as s:
            assert s.runtime.kernel_block == 64
            out = blas.gemm(a, b)
            out2 = blas.gemm(a, b, alpha=2.0)
        np.testing.assert_allclose(out.numpy(), a.numpy() @ b.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out2.numpy(), 2 * a.numpy() @ b.numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert seen == [64, 64, 0, 0]

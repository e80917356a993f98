"""The port's gemm kernel on each of its paths, and the fused split kernel,
on the card.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py

Tolerances are chip_smoke.py's, relative to max|plain|: float64 1e-10
(both sides sum in float64), float32 1e-4 (IEEE float32 sums, no TF32),
bf16/f16 5e-2 (float32 sums, one rounding of the output).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.kernels import gemm, split_gemm  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.float64: 1e-10, torch.bfloat16: 5e-2,
       torch.float16: 5e-2}
#: (N, K): multiples of 8 off every tile multiple (path 1 takes them at
#: M >= 64), odd ones (TMA cannot describe them: path 2), and K = 1
SHAPES = ((200, 136), (93, 170), (40, 1))
#: exact-pass operands against their exact product (chip_smoke.py)
EXACT_PASS_TOL = 1e-12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, want):
    return ((got.to(want.dtype) - want).abs().max()
            / want.abs().max()).item()


def _mat(rows, cols, trans, dtype, dev, batch=0):
    """A rows x cols matrix, stored transposed when ``trans``."""
    shape = (batch,) if batch else ()
    if trans:
        return torch.randn(*shape, cols, rows, device=dev).to(dtype).mT
    return torch.randn(*shape, rows, cols, device=dev).to(dtype)


def _expected_path(a, b):
    if a.dtype == torch.float64:
        return gemm.DMMA if a.shape[-2] >= 64 else gemm.SKINNY_F64
    if a.dtype == torch.float32:
        return gemm.SIMT
    lay = (gemm.layout(a), gemm.layout(b))
    ok = all(x.data_ptr() % 16 == 0 and ld % 8 == 0
             for x, (_, ld) in zip((a, b), lay))
    return gemm.TC if a.shape[-2] >= 64 and ok else gemm.SKINNY


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16],
                         ids=["f32", "f64", "bf16", "f16"])
@pytest.mark.parametrize("m", [1, 2, 3, 17, 63, 64, 65, 200])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_gemm_paths_match_plain_version(dev, dtype, m, ta, tb):
    """Every path x input type x out_dtype against the plain version at
    ragged M, N and K, K = 1, and transposed views of either operand."""
    for n, k in SHAPES:
        a = _mat(m, k, ta, dtype, dev)
        b = _mat(k, n, tb, dtype, dev)
        assert gemm.plan(a, b).path == _expected_path(a, b)
        for out_dtype in gemm.OUT_DTYPES[dtype]:
            launched = gemm.launches
            got = gemm.gemm(a, b, out_dtype=out_dtype)
            assert gemm.launches == launched + 1
            assert got.dtype == out_dtype
            want = gemm.gemm_plain(a, b, out_dtype=out_dtype)
            assert _rel(got, want) <= TOL[dtype], (n, k, out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16],
                         ids=["f32", "f64", "bf16", "f16"])
@pytest.mark.parametrize("m", [2, 130])
def test_gemm_batched_and_row_strided_views(dev, dtype, m):
    """A batch of 3 in both layouts, and row-strided views of a larger
    matrix (16-byte aligned, so path 1 takes them at M >= 64)."""
    a = _mat(m, 136, False, dtype, dev, batch=3)
    b = _mat(136, 200, True, dtype, dev, batch=3)
    assert _rel(gemm.gemm(a, b), gemm.gemm_plain(a, b)) <= TOL[dtype]
    big = torch.randn(m + 8, 160, device=dev).to(dtype)
    bigb = torch.randn(300, 216, device=dev).to(dtype)
    view_a, view_b = big[4:4 + m, 8:144], bigb[16:152, 8:208]
    assert view_a.stride(0) == 160 and view_b.stride(0) == 216
    want = gemm.gemm_plain(view_a, view_b)
    assert _rel(gemm.gemm(view_a, view_b), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("block", gemm.EDGES)
def test_gemm_tile_edges_match_plain_version(dev, dtype, block):
    """Each compiled tile edge of paths 1, 3 and 4 (kernel_block)."""
    a = _mat(200, 264, False, dtype, dev)
    b = _mat(264, 136, True, dtype, dev)
    assert gemm.plan(a, b, block).tile == block
    assert _rel(gemm.gemm(a, b, block=block),
                gemm.gemm_plain(a, b)) <= TOL[dtype]
    with pytest.raises(ValueError, match="tile edge"):
        gemm.gemm(a, b, block=96)


def test_gemm_decode_shapes_split_k_and_the_table_view(dev):
    """M = 2 against a 2048-wide row-major weight (K split across blocks,
    a second launch sums the partials) and against the transposed view of
    a tied embedding table (dot products along K, no copy)."""
    x = torch.randn(2, 3584, device=dev).to(torch.bfloat16)
    w = torch.randn(3584, 2048, device=dev).to(torch.bfloat16)
    p = gemm.plan(x, w)
    assert p.path == gemm.SKINNY and p.splits > 1
    reduced = gemm.reduce_launches
    assert _rel(gemm.gemm(x, w), gemm.gemm_plain(x, w)) <= 5e-2
    assert gemm.reduce_launches == reduced + 1
    table = torch.randn(5000, 3584, device=dev).to(torch.bfloat16)
    assert gemm.layout(table.mT) == (True, 3584)
    assert _rel(gemm.gemm(x, table.mT, out_dtype=torch.float32),
                gemm.gemm_plain(x, table.mT, out_dtype=torch.float32)) <= 5e-2


@pytest.mark.parametrize("m", [1, 5, 32, 63])
@pytest.mark.parametrize("n", [2400, 200, 93])
@pytest.mark.parametrize("ta,tb", [(True, False), (False, False),
                                   (True, True), (False, True)])
@pytest.mark.parametrize("batch", [0, 3])
def test_gemm_skinny_f64_matches_plain_and_repeats_bit_for_bit(
        dev, m, n, ta, tb, batch):
    """Path 5 (float64, M < 64: DMMA on all M rows, K split across blocks)
    at K = 20011, ragged against every split and tile, with A as PARSEC
    passes it (a transposed view) or row-major and B either way: within
    1e-10 of the plain version, the same bits on a second call (the
    partials summed in split order, no atomics), and one launch a call on
    the path's own counter."""
    k = 20011
    a = _mat(m, k, ta, torch.float64, dev, batch)
    b = _mat(k, n, tb, torch.float64, dev, batch)
    p = gemm.plan(a, b)
    assert p.path == gemm.SKINNY_F64 and p.tile == 0 and p.splits > 1
    counts = gemm.launches, gemm.skinny_f64_launches, gemm.reduce_launches
    got = gemm.gemm(a, b)
    assert (gemm.launches, gemm.skinny_f64_launches,
            gemm.reduce_launches) == tuple(c + 1 for c in counts)
    assert _rel(got, gemm.gemm_plain(a, b)) <= TOL[torch.float64]
    assert torch.equal(gemm.gemm(a, b), got)
    assert gemm.skinny_f64_launches == counts[1] + 2


@pytest.mark.parametrize("scheme", ["split2", "split3"])
def test_split_kernel_slices_equal_precision_slices(dev, scheme):
    """The kernel's slicing code equals precision.slices bit for bit,
    the bf16 tail included (rounded through float, as PyTorch does)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, generator=g, dtype=torch.float64, device=dev)
    x = torch.cat([x, x * 1e30, x * 1e-30, torch.tensor(
        [0.0, -0.0, 1.0, 2.0 ** -149, 3.4e38], dtype=torch.float64,
        device=dev)])
    for got, want in zip(split_gemm.slices(x, scheme),
                         prec.slices(x, scheme)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("scheme", ["split2", "split3"])
@pytest.mark.parametrize("k", [1, 255, 256, 257, 1000])
def test_split_kernel_within_bound_at_ragged_k(dev, scheme, k):
    """Two launches per product; A given as a transposed view; the error
    relative to |A||B| within the a-priori bound, and close to the plain
    passes."""
    a = torch.randn(k, 48, dtype=torch.float64, device=dev).mT
    b = torch.randn(k, 70, dtype=torch.float64, device=dev)
    launched = split_gemm.launches
    out = split_gemm.matmul(a, b, scheme)
    assert split_gemm.launches == launched + 2
    scale = (a.abs() @ b.abs()).max().item()
    bound = prec.error_bound(scheme, k)
    assert (out - a @ b).abs().max().item() / scale <= bound
    plain = prec.matmul(a, b, scheme, mm=split_gemm.pass_mm())
    assert (out - plain).abs().max().item() / scale <= bound


def _exact_pass_pair(m, k, n, dev):
    """chip_smoke.py's exact-pass operands (each element s (h + l + t)
    with h, l, t exact in fp32, fp32 and bf16; A's second half of columns
    repeats the first's hi part and B's second half of rows negates it)
    and their exact product."""
    g = torch.Generator(device=dev).manual_seed(7)

    def parts(rows, cols):
        def pick(scale):
            return (1.0 + 0.5 * torch.randint(0, 2, (rows, cols), generator=g,
                                              device=dev)) * scale
        sign = 2.0 * torch.randint(0, 2, (rows, cols), generator=g,
                                   device=dev) - 1.0
        return [x.double() for x in (sign, pick(1.0), pick(2.0 ** -25),
                                     pick(2.0 ** -51))]
    sa, ha, la, ta = parts(m, k)
    sb, hb, lb, tb = parts(k, n)
    h, c = k // 2, n // 2
    sa[:, h:2 * h], ha[:, h:2 * h] = sa[:, :h], ha[:, :h]
    sb[h:2 * h, :c], hb[h:2 * h, :c] = -sb[:h, :c], hb[:h, :c]
    pa = [sa * x for x in (ha, la, ta)]
    pb = [sb * x for x in (hb, lb, tb)]
    exact = torch.zeros(m, n, dtype=torch.float64, device=dev)
    for i, j in sorted(((i, j) for i in range(3) for j in range(3)),
                       key=lambda p: -sum(p)):
        exact += pa[i] @ pb[j]
    return sum(pa), sum(pb), exact


def test_split_kernel_exact_pass_operands_and_dropped_pass_controls(dev):
    """split3 in the kernel reads at rounding level against the exact
    product of exact-pass operands; leaving any one pass out reads over
    the limit."""
    a, b, exact = _exact_pass_pair(32, 1000, 40, dev)
    denom = exact.abs().amax(dim=0)

    def colrel(got):
        return ((got - exact).abs().amax(dim=0) / denom).max().item()
    assert colrel(split_gemm.matmul(a, b, "split3")) <= EXACT_PASS_TOL
    for p in prec._PASSES["split3"]:
        got = split_gemm.fused(a, b, "split3", drop=(p,))
        assert colrel(got) > EXACT_PASS_TOL, p

"""The float64 syrk kernel's plan and summation order on the CPU.

``repro_torch.kernels.syrk.plan`` splits K across blocks so that the
on-triangle 128 x 128 tiles fill the card; ``syrk_split_plain`` is the
kernel's order in plain PyTorch: one partial product per K range, summed
in split order, masked to the triangle.  These tests hold the plan's
rules (the last wave at least 90% full where the split can reach it, the
ranges covering [0, K) once) and hold the split order against the TPU
kernel itself, run interpreted (``repro.kernels.syrk.syrk(...,
interpret=True)``), and the reference's ``ref.syrk``.  The CUDA kernel is
held to ``syrk_plain`` on the card (``tests/test_torch_cuda_venue.py``,
``chip_smoke.py``).

Tolerance: 1e-12 of max|C| in float64.  Both sides sum up to ~2e4 terms
of |a|^2 ~ 1 in float64, in different orders: K eps64 ~ 4e-12 of a term's
size in the worst case, ~1e-14 of max|C| for random signs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.syrk import syrk as pallas_syrk  # noqa: E402
from repro_torch.kernels import syrk  # noqa: E402

RNG = np.random.default_rng(29)
TOL = 1e-12

#: (n, k) whose split reaches a last wave at least 90% full
FILLED = [(2400, 93536), (1000, 50001), (3001, 77777), (777, 99999)]
#: (n, k) too shallow or too narrow to reach it
SHALLOW = [(301, 170), (5000, 1000), (5000, 12345), (2400, 8192),
           (128, 100000), (65, 33), (2400, 0)]


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _last_wave(p: syrk.Plan) -> float:
    slots = syrk.SMS * syrk.DMMA_PER_SM
    return (p.blocks % slots or slots) / slots


def _check_ranges(p: syrk.Plan, k: int) -> None:
    ranges = p.ranges(k)
    assert len(ranges) == p.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
        assert hi == nlo                     # no gap, no overlap
    assert all(hi > lo for lo, hi in ranges) or k == 0
    if p.splits > 1:
        assert p.chunk % syrk.DMMA_BK == 0
        assert p.chunk >= syrk.MIN_SPLIT_TILES * syrk.DMMA_BK


def test_plan_at_parsec_shape():
    """PARSEC's Gram matrix: 190 tiles, 9 ranges, 1710 blocks, 12.95
    waves on 132 SMs at one block each."""
    p = syrk.plan(2400, 93536, torch.float64, "T")
    assert (p.edge, p.tiles, p.splits, p.blocks) == (128, 190, 9, 1710)
    assert p.waves == pytest.approx(1710 / 132)
    assert _last_wave(p) >= syrk.LAST_WAVE_FILL
    _check_ranges(p, 93536)


@pytest.mark.parametrize("n,k", FILLED)
def test_plan_fills_the_last_wave(n, k):
    p = syrk.plan(n, k)
    assert _last_wave(p) >= syrk.LAST_WAVE_FILL
    _check_ranges(p, k)
    # the fewest such splits: no smaller count fills the last wave
    for fewer in range(1, p.splits):
        chunk = -(-(-(-k // syrk.DMMA_BK)) // fewer) * syrk.DMMA_BK
        blocks = p.tiles * -(-k // chunk)
        slots = syrk.SMS * syrk.DMMA_PER_SM
        assert (blocks % slots or slots) < syrk.LAST_WAVE_FILL * slots


@pytest.mark.parametrize("n,k", SHALLOW)
def test_plan_keeps_each_range_deep(n, k):
    """Where no split fills the last wave, ranges stay at least 4096 deep
    and the count chosen keeps the waves busiest; K under 8192 is not
    split at all."""
    p = syrk.plan(n, k)
    _check_ranges(p, k)
    if k < 2 * syrk.MIN_SPLIT_TILES * syrk.DMMA_BK:
        assert p.splits == 1 and p.chunk == k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_plan_other_types_walk_all_of_k(dtype):
    p = syrk.plan(2400, 93536, dtype)
    assert (p.edge, p.splits, p.chunk) == (64, 1, 93536)
    assert p.tiles == 38 * 39 // 2


def test_plan_does_not_depend_on_trans():
    assert syrk.plan(2400, 93536, torch.float64, "N") == \
        syrk.plan(2400, 93536, torch.float64, "T")
    with pytest.raises(ValueError, match="trans"):
        syrk.plan(10, 10, torch.float64, "C")


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("n,k", [(200, 9001), (65, 12345), (300, 20000)])
def test_split_order_matches_interpreted_pallas(uplo, trans, n, k):
    """Ragged n and k, each split into 2 to 4 ranges of a K that is not a
    multiple of the range: the split order against the TPU kernel and
    the reference's ref.syrk, and the CPU wrapper (the plain version)
    against both."""
    assert syrk.plan(n, k).splits > 1
    shape = (n, k) if trans == "N" else (k, n)
    a = RNG.standard_normal(shape)
    want = np.asarray(pallas_syrk(jnp.asarray(a), uplo=uplo, trans=trans,
                                  interpret=True))
    want_ref = np.asarray(jref.syrk(jnp.asarray(a), uplo=uplo, trans=trans))
    got = syrk.syrk_split_plain(torch.as_tensor(a), uplo=uplo, trans=trans)
    assert got.dtype == torch.float64 and got.shape == (n, n)
    scale = np.abs(want).max()
    for w in (want, want_ref):
        assert np.abs(got.numpy() - w).max() <= TOL * scale
    other = np.triu(got.numpy(), 1) if uplo == "L" else np.tril(
        got.numpy(), -1)
    assert not other.any()
    plain = syrk.syrk(torch.as_tensor(a), uplo=uplo, trans=trans)
    assert np.abs(plain.numpy() - want).max() <= TOL * scale


def test_split_order_batched():
    """A batch of two: one split order per matrix."""
    a = RNG.standard_normal((2, 70, 9001))
    got = syrk.syrk_split_plain(torch.as_tensor(a), uplo="U")
    for z in range(2):
        want = np.triu(a[z] @ a[z].T)
        assert np.abs(got[z].numpy() - want).max() <= \
            TOL * np.abs(want).max()

"""The solver tier's captured panel on the card.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py

``lapack.getrf`` on the card factors each panel by one replay of the
panel shape's captured graph (``core/lapack.py`` ``_PanelGraphs``).  Held
against the same getrf with every panel's column loop run eagerly from
Python (``_pivot_panel`` itself):

* factors and pivots bit for bit, in float32, float64, complex64 and
  complex128, square, tall and wide: the same kernels on the same values;
* a second getrf of one shape replays every panel without capturing,
  a taller shape captures anew (panels are padded with zero rows up to
  one of ``lapack.BUCKETS`` heights per group);
* a ``lapack=True`` session counts and traces the same calls, each panel
  a ``getf2`` with its own buffer id;
* the padding below a panel stays out of its pivot search: a pivot row
  with an infinite entry replays byte for byte as the unpadded loop;
* a replay makes no host sync (``set_sync_debug_mode("error")``);
* the last open session's close frees the graphs;
* graphs dropped and captured again (a new process) give the same bits;
* a panel that cannot be captured raises: no eager fallback.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import lapack  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
SHAPES = [(320, 320), (448, 256), (256, 384)]
NB = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _matrix(shape, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(shape, dtype=torch.float64, generator=gen)
    if dtype.is_complex:
        a = a + 1j * torch.randn(shape, dtype=torch.float64, generator=gen)
    return a.to(dtype).to(dev)


def _eager_panel(panel):
    piv = torch.empty(panel.shape[1], dtype=torch.int64,
                      device=panel.device)
    lapack._pivot_panel(panel, piv)
    return piv.tolist()


def _eager_getrf(a, nb, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(lapack, "_factor_panel", _eager_panel)
        return lapack.getrf(a, nb=nb)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_replays_equal_the_eager_panels(dtype, shape, dev, monkeypatch):
    a = _matrix(shape, dtype, dev)
    lapack._GRAPHS.clear()
    first = lapack.getrf(a, nb=NB)          # captures
    again = lapack.getrf(a, nb=NB)          # replays
    want = _eager_getrf(a, NB, monkeypatch)
    for got in (first, again):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    # a factorization: A[piv] == L U
    lu, piv = want
    k = min(shape)
    low = torch.tril(lu[:, :k], -1) + torch.eye(shape[0], k, dtype=dtype,
                                                device=dev)
    up = torch.triu(lu[:k])
    tol = 1e-4 if dtype in (torch.float32, torch.complex64) else 1e-12
    err = (a[piv.long()] - low @ up).abs().max() / a.abs().max()
    assert err.item() <= tol


def _graphs(a, nb):
    """The captured graphs of the group of ``a``'s full-width panels."""
    return lapack._GRAPHS._groups[(nb, a.dtype, a.device)].graphs


def test_second_getrf_replays_another_shape_captures(dev):
    """Panels of one width share a group; heights are padded up to the
    group's buckets, one graph each."""
    lapack._GRAPHS.clear()
    lapack.reset_launches()
    a = _matrix((512, 512), torch.complex128, dev)
    panels = len(range(0, 512, 128))
    lapack.getrf(a, nb=128)
    first = len(_graphs(a, 128))
    assert 0 < first <= min(panels, lapack.BUCKETS)
    assert (lapack.captures, lapack.replays) == (first, panels)
    lapack.getrf(a, nb=128)
    assert (lapack.captures, lapack.replays) == (first, 2 * panels)
    # a taller matrix outgrows the group's buffer: a new group
    b = _matrix((1280, 1280), torch.complex128, dev)
    lapack.getrf(b, nb=128)
    second = len(_graphs(b, 128))
    assert lapack.captures == first + second
    assert lapack.replays == 2 * panels + 10
    # the first shape's heights fall in the new group's buckets now
    lapack.getrf(a, nb=128)
    assert lapack.captures == first + second
    assert lapack.replays == 3 * panels + 10
    # a getrf of n 6912 at nb 256 (27 panels) captures at most 8 graphs
    assert -(-6912 // 256) == 27
    assert len({q * -(-h // q) for q in [-(-6912 // lapack.BUCKETS)]
                for h in range(6912, 0, -256)}) == lapack.BUCKETS


def _session_counts(a, nb, dev):
    cfg = OffloadConfig(lapack=True, threshold=32.0, lapack_nb=nb)
    with repro_torch.session(cfg, device=dev) as s:
        lu, piv = torch.linalg.lu_factor(a)
        st, trace = s.stats, s.trace
        seq = [(c.routine, c.m, c.n, c.k, c.solver_id) for c in trace]
        panel_ids = [c.operands[0][1] for c in trace
                     if c.routine.endswith("getf2")]
        return (lu, piv, seq, panel_ids,
                {k: (v.calls, v.offloaded, v.on_host)
                 for k, v in st.per_routine.items()},
                {k: (v.spans, v.calls, v.panel_calls)
                 for k, v in st.solvers.items()})


def test_session_counts_and_traces_as_the_eager_panels(dev, monkeypatch):
    a = _matrix((200, 200), torch.complex128, dev)
    graph = _session_counts(a, 48, dev)
    with monkeypatch.context() as mp:
        mp.setattr(lapack, "_factor_panel", _eager_panel)
        eager = _session_counts(a, 48, dev)
    assert torch.equal(graph[0], eager[0]) and torch.equal(graph[1],
                                                           eager[1])
    assert graph[2:] == eager[2:]
    panels = graph[3]
    assert len(panels) == 5 and len(set(panels)) == 5
    spans, _, panel_calls = graph[5]["getrf"]
    assert (spans, panel_calls) == (1, 5)


def test_a_replay_makes_no_host_sync(dev):
    a = _matrix((384, 64), torch.float64, dev)
    lapack._GRAPHS.clear()
    want = a.clone()
    wpiv = lapack._factor_panel(want)
    g = lapack._GRAPHS.get(a)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.panel.copy_(a)
        g.replay()
        a.copy_(g.panel)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(a, want)
    assert g.piv.tolist() == wpiv


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_an_infinite_pivot_row_replays_as_the_unpadded_loop(dtype, dev):
    """97 rows in a bucket of 104: column 0's pivot row holds an inf in
    column 1, which turns the padding NaN (0 * inf); the padded rows are
    left out of the pivot search, so the replay's factor and pivots are
    byte for byte the unpadded loop's and no pivot lies past the panel."""
    a = _matrix((97, 16), dtype, dev, seed=3)
    a[5, 0] = 9
    a[5, 1] = float("inf")
    lapack._GRAPHS.clear()
    got = a.clone()
    gpiv = lapack._factor_panel(got)
    assert lapack._GRAPHS.get(a).panel.shape[0] > 97
    want = a.clone()
    wpiv = _eager_panel(want)
    assert not bool(torch.isfinite(want).all())
    assert gpiv == wpiv and max(gpiv) < 97
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()


def test_the_last_session_close_frees_the_panels(dev):
    a = _matrix((200, 200), torch.complex128, dev)
    lapack._GRAPHS.clear()
    cfg = OffloadConfig(lapack=True, threshold=32.0, lapack_nb=48)
    with repro_torch.session(cfg, device=dev):
        with repro_torch.session(cfg, device=dev):
            torch.linalg.lu_factor(a)
            assert lapack._GRAPHS._groups
        assert lapack._GRAPHS._groups       # the outer session is open
    assert not lapack._GRAPHS._groups


def test_graphs_captured_again_give_the_same_bits(dev):
    a = _matrix((448, 448), torch.complex64, dev)
    lapack._GRAPHS.clear()
    lu1, piv1 = lapack.getrf(a, nb=NB)
    lapack._GRAPHS.clear()
    lu2, piv2 = lapack.getrf(a, nb=NB)
    assert torch.equal(lu1, lu2) and torch.equal(piv1, piv2)


def test_a_failed_capture_raises(dev, monkeypatch):
    """A host read inside the column loop cannot be captured: getrf
    raises, and nothing factors the panel eagerly in its place."""
    lapack._GRAPHS.clear()
    lapack.reset_launches()
    real = lapack._pivot_panel

    def reading(p, piv, *rest):
        real(p, piv, *rest)
        int(piv[0])         # a host read: illegal while capturing

    monkeypatch.setattr(lapack, "_pivot_panel", reading)
    a = _matrix((256, 256), torch.float64, dev)
    with pytest.raises(RuntimeError):
        lapack.getrf(a, nb=NB)
    assert (lapack.captures, lapack.replays) == (0, 0)
    torch.cuda.synchronize()
    monkeypatch.undo()
    lapack._GRAPHS.clear()
    lu, _ = lapack.getrf(a, nb=NB)
    assert bool(torch.isfinite(lu).all())
    np.testing.assert_equal(lapack.captures, len(_graphs(a, NB)))

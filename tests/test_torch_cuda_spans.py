"""The port's profiler spans on the card.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_spans.py

* a fresh ``.mT`` view of an unchanged pinned host block each call moves
  under ``scilib.move.again``, the copy of its bytes launched inside the
  span; the resident operand moves once, under ``scilib.move.first``;
* a getrf that captures its panels' graphs under the profiler gives the
  bits of one without the profiler, with its panels and calls spanned;
* inside a CUDA graph capture a span is the no-op, profiler or not.
"""
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import lapack, spans  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.policy import host_array  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _events(body):
    """The host's events of ``body`` under the profiler (each range is
    also mirrored on the device's timeline: those are left out)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def test_view_of_an_unchanged_block_moves_again(dev):
    gen = torch.Generator().manual_seed(5)
    h = host_array(torch.randn(512, 32, dtype=torch.float64,
                               generator=gen))
    psi = host_array(torch.randn(512, 256, dtype=torch.float64,
                                 generator=gen))
    cfg = OffloadConfig(policy="dfu", threshold=1.0)
    with repro_torch.session(cfg, device=dev):
        evs = _events(lambda: [torch.matmul(h.mT, psi) for _ in range(3)])
    moves = [e for e in evs if e.name.startswith("scilib.move.")]
    assert [e.name for e in moves] == ["scilib.move.first",
                                       "scilib.move.first",
                                       "scilib.move.again",
                                       "scilib.move.again"]
    copies = [e for e in evs if e.name.startswith("cudaMemcpy")]
    for m in moves:
        inside = [c for c in copies
                  if m.time_range.start <= c.time_range.start
                  and c.time_range.end <= m.time_range.end]
        assert inside, m.name


def test_capture_under_the_profiler(dev):
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(384, 384, dtype=torch.complex128,
                    generator=gen).to(dev)
    cfg = OffloadConfig(policy="dfu", lapack=True, lapack_nb=64,
                        threshold=1.0)
    with repro_torch.session(cfg, device=dev):
        lapack.release_graphs()
        want = torch.linalg.lu_factor(a)
        lapack.release_graphs()
        captures = lapack.captures
        got = []
        evs = _events(lambda: got.extend(torch.linalg.lu_factor(a)))
        assert lapack.captures > captures
    assert all(torch.equal(x, y) for x, y in zip(want, got))
    names = [e.name for e in evs if e.name.startswith("scilib.")]
    assert names.count("scilib.solver.getrf") == 1
    assert names.count("scilib.panel") == 384 // 64
    assert "scilib.call.zgemm" in names


def test_no_span_inside_a_capture(dev):
    x = torch.zeros(4, device=dev)
    graph = torch.cuda.CUDAGraph()
    with profile(activities=[ProfilerActivity.CPU]):
        outside = spans.enabled()
        with torch.cuda.graph(graph):
            inside = spans.span("scilib.compute")
            capturing = spans.enabled()
            x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert outside and not capturing
    assert inside is spans.span("scilib.compute")      # the no-op
    assert x.tolist() == [1.0] * 4

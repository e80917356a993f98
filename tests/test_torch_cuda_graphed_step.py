"""``kernels.compat.GraphedStep`` on the card: new shapes and generators.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py

``GraphedStep`` is the one capture lifecycle of the port: ``Server``'s
decode step, ``Trainer``'s train step and the mesh path's decode step
run through it (their own card tests hold those).  Here a small step of
elementwise ops and reductions, a state tensor it writes in place and
an input that is new every call, is held to the same step run eagerly:

* a call with an input of another shape drops the graph, warms up and
  captures anew, and every output and the state equal the eager steps'
  bit for bit, before and after the new capture;
* with a registered generator each replay draws afresh, and its draws
  equal the eager steps' from the same seed.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import compat  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _step(x, w, state):
    """A step with its own state: the state decays and takes the batch's
    column sums; returns the rows' reductions against it."""
    state.mul_(0.5).add_(torch.tanh(x * w).sum(0))
    return (x * state).sum(1), x.amax(1)


def test_another_shape_captures_anew(dev):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, generator=gen).to(dev)
    state = torch.zeros(64, device=dev)
    want_state = state.clone()
    step = compat.GraphedStep(_step, dev, fresh=(0,))
    graphs = []
    for i, rows in enumerate([4, 4, 4, 4, 8, 8, 8, 8]):
        x = torch.randn(rows, 64, generator=gen).to(dev)
        got = [y.clone() for y in step(x, w, state)]
        want = _step(x, w, want_state)
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        assert torch.equal(state, want_state), i
        graphs.append(step.graph)
    # 4 rows: warm-up, capture, 2 replays; 8 rows: warm-up, capture, ...
    assert graphs[0] is None and graphs[1] is graphs[3] is not None
    assert graphs[4] is None and graphs[5] is graphs[7] is not None
    assert graphs[5] is not graphs[1]
    assert step.replays == 6
    assert step.args[0].shape == (8, 64)


def test_a_registered_generator_draws_afresh(dev):
    def noisy(x, gen):
        return x + torch.empty_like(x).exponential_(1.0, generator=gen)

    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3)
    gen = torch.Generator(device=dev).manual_seed(5)
    ref = torch.Generator(device=dev).manual_seed(5)
    step = compat.GraphedStep(lambda x: noisy(x, gen), dev, fresh=(0,),
                              generators=(gen,))
    got = [step(x).clone() for _ in range(6)]
    want = [noisy(x, ref) for _ in range(6)]
    assert step.replays == 5
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert not torch.equal(got[2], got[3])

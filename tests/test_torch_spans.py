"""The port's profiler spans (``repro_torch.core.spans``), on the CPU.

Under ``torch.profiler`` each layer boundary is a ``scilib.*`` range:

* a DFU zgemm with host operands: ``scilib.call.zgemm`` holds
  ``scilib.decide``, a ``scilib.move.first`` per operand,
  ``scilib.compute`` and ``scilib.fence``; a second call on the same
  operands moves nothing;
* each move names its reason: a fresh ``.mT`` view of an unchanged host
  block (its placement died with the last view) ``again``, an in-place
  write ``stale``, a cap eviction ``refetch``, Mem-Copy's copy-back
  ``out``;
* ``lu_factor`` under ``lapack=True``: ``scilib.solver.getrf`` holds its
  panels, its row swaps and its trsm and gemm calls;
* with no profiler running no ``record_function`` is entered, and the
  outputs and counters are the same with the profiler on and off;
* the placement store remembers at most ``DROPPED_KEYS`` dropped
  anchors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import memspace, residency  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.policy import host_array  # noqa: E402

N = 64
#: offloads every product of these tests
THRESHOLD = 10.0
#: host-clock fields of RoutineStats (they differ between any two runs)
TIMES = ("seconds", "kernel_seconds", "split_seconds")


def _host(rng, *shape, dtype=np.complex128):
    x = rng.standard_normal(shape)
    if np.iscomplexobj(np.empty(0, dtype)):
        x = x + 1j * rng.standard_normal(shape)
    return host_array(x.astype(dtype))


def _spans(body):
    """Run ``body`` under the profiler: the ``scilib.*`` ranges as
    (name, start, end), in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("scilib.")),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans_, outer):
    """The names of the ranges inside the first range named ``outer``."""
    _, a, b = next(s for s in spans_ if s[0] == outer)
    return [n for n, s, e in spans_ if a <= s and e <= b and n != outer]


def _moves(spans_):
    return [n for n, _, _ in spans_ if n.startswith("scilib.move.")]


def test_dfu_call_holds_its_layers(rng):
    cfg = OffloadConfig(policy="dfu", threshold=THRESHOLD)
    with repro_torch.session(cfg, device="cpu"):
        a, b = _host(rng, N, N), _host(rng, N, N)
        first = _spans(lambda: torch.matmul(a, b))
        second = _spans(lambda: torch.matmul(a, b))
    inner = _inside(first, "scilib.call.zgemm")
    assert inner == ["scilib.decide", "scilib.move.first",
                     "scilib.move.first", "scilib.compute", "scilib.fence"]
    assert _inside(second, "scilib.call.zgemm") == [
        "scilib.decide", "scilib.compute", "scilib.fence"]


def _again(rng):
    # on the card a CPU tensor is host memory; the simulated tier tags
    # each fresh view as the application's host block
    h, psi = _host(rng, N, N // 2, dtype=np.float64), _host(
        rng, N, N, dtype=np.float64)

    def body():
        for _ in range(3):
            torch.matmul(memspace.tag_host_input(h.mT), psi)
    return body


def _stale(rng):
    a, b = _host(rng, N, N), _host(rng, N, N)
    torch.matmul(a, b)

    def body():
        a.mul_(2)
        torch.matmul(a, b)
    return body


def _refetch(rng):
    a, b = _host(rng, N, N), _host(rng, N, N)
    torch.matmul(a, b)      # b's placement, then the output's, evict a

    def body():
        torch.matmul(a, b)
    return body


def _out(rng):
    a, b = _host(rng, N, N), _host(rng, N, N)

    def body():
        torch.matmul(a, b)
    return body


@pytest.mark.parametrize("case, policy, cap, want", [
    (_again, "dfu", None, ["scilib.move.first", "scilib.move.first",
                           "scilib.move.again", "scilib.move.again"]),
    (_stale, "dfu", None, ["scilib.move.stale"]),
    (_refetch, "dfu", N * N * 16, ["scilib.move.refetch",
                                   "scilib.move.refetch"]),
    (_out, "memcopy", None, ["scilib.move.first", "scilib.move.first",
                             "scilib.move.out"]),
], ids=["again", "stale", "refetch", "out"])
def test_move_reasons(rng, case, policy, cap, want):
    cfg = OffloadConfig(policy=policy, threshold=THRESHOLD, device_bytes=cap)
    with repro_torch.session(cfg, device="cpu"):
        body = case(rng)
        got = _spans(body)
    assert _moves(got) == want


def test_solver_span_holds_panels_swaps_and_calls(rng):
    cfg = OffloadConfig(policy="dfu", lapack=True, lapack_nb=16,
                        threshold=THRESHOLD)
    with repro_torch.session(cfg, device="cpu"):
        m = torch.as_tensor(rng.standard_normal((N, N))
                            + 1j * rng.standard_normal((N, N)))
        got = _spans(lambda: torch.linalg.lu_factor(m))
    inner = _inside(got, "scilib.solver.getrf")
    assert inner.count("scilib.panel") == N // 16
    assert inner.count("scilib.swap") == N // 16
    assert "scilib.call.ztrsm" in inner and "scilib.call.zgemm" in inner
    # every range of the factorization lies inside the solver's
    assert len(inner) == len(got) - 1


def _workload(rng):
    """Calls of each kind above: outputs and the session's counters."""
    cfg = OffloadConfig(policy="dfu", lapack=True, lapack_nb=16,
                        threshold=THRESHOLD, device_bytes=3 * N * N * 16)
    with repro_torch.session(cfg, device="cpu") as s:
        a, b, c = (_host(rng, N, N) for _ in range(3))
        h = _host(rng, N, N // 2)
        outs = [torch.matmul(a, b), torch.matmul(a, b)]
        a.mul_(2)
        outs += [torch.matmul(a, c), torch.matmul(b, c),
                 torch.matmul(memspace.tag_host_input(h.mT), a),
                 torch.matmul(memspace.tag_host_input(h.mT), a)]
        outs += list(torch.linalg.lu_factor(outs[0] + 8 * torch.eye(N)))
        stats = {k: {f: v for f, v in dataclasses.asdict(r).items()
                     if f not in TIMES}
                 for k, r in s.stats.per_routine.items()}
    return outs, stats


def test_profiler_changes_no_output_or_counter():
    off = _workload(np.random.default_rng(1))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _workload(np.random.default_rng(1))
    for x, y in zip(off[0], on[0]):
        assert torch.equal(x, y)
    assert off[1] == on[1]
    assert off[1]["zgemm"]["bytes_in"] > 0


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _workload(np.random.default_rng(2))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _workload(np.random.default_rng(2))
    assert "scilib.call.zgemm" in entered and "scilib.panel" in entered
    assert spans.span("scilib.decide") is spans.span("scilib.fence")


def test_dropped_anchors_are_bounded():
    store = residency.ResidencyStore("placements")
    anchors = [torch.zeros(1) for _ in range(residency.DROPPED_KEYS + 8)]
    for i, x in enumerate(anchors):
        store.put(i, None, 4, anchor=x, version=i)
    store.put("plain", None, 4, anchor=torch.zeros(1))  # no version
    del x
    for i in range(len(anchors)):                     # die in order
        anchors[i] = None
    assert len(store) == 0
    assert len(store._dropped) == residency.DROPPED_KEYS
    assert store.dropped_version(7) is None           # the oldest went
    last = residency.DROPPED_KEYS + 7
    assert store.dropped_version(last) == last
    assert store.dropped_version("plain") is None

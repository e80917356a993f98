"""The port's fault model against the JAX reference's, on the CPU.

Every test of ``tests/test_faults.py`` runs against the port
(``repro_torch.core.faults`` and a session on ``device="cpu"``), with the
golden values that test asserts, and against the reference live on the
same numpy inputs where it runs here: the spec grammar and its
rejections, the injector's determinism and filters, the backoff, the
breaker on a fake clock, retries absorbing faults bit for bit, exhaustion
and OOM falling back bit for bit, degraded mode, the health section of
the report, quarantine -> re-shard -> recover on three tiers, a faulted
live run against its replay (through both packages' memtier), fault
events through dump and load, the ``sync()`` drain, and the spec matrix.

The reference runs on its single-kind simulated tiers (``ref_tiers``):
this JAX's CPU backend exposes several memory kinds, where the
reference's real-tier mode refuses host-born operands in one op.

The port's departures from the reference's ``classify`` (its module
docstring) have tests of their own: the kernel builder's and launcher's
errors and CUDA's sticky errors propagate out of a session call, and
none of them counts a fault or a fallback.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import blas as jblas  # noqa: E402
from repro.core import faults as jflt  # noqa: E402
from repro.core import memspace as jms  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402
from repro.core.policy import host_array as jhost  # noqa: E402
from repro.core.session import Session as JSession  # noqa: E402
from repro.core.trace import Trace as JTrace  # noqa: E402
from repro.memtier.simulator import MemTierSimulator as JSim  # noqa: E402

from repro_torch.core import blas  # noqa: E402
from repro_torch.core import faults as flt  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.policy import host_array  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.trace import Trace  # noqa: E402
from repro_torch.kernels import compat  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.memtier import MemTierSimulator  # noqa: E402

RNG = np.random.default_rng(23)


def _mat(n, m=None):
    return RNG.standard_normal((n if m is None else m, n)).astype(
        np.float32)


@pytest.fixture
def ref_tiers(monkeypatch):
    """The reference on its simulated tiers: one memory kind, tiers as
    tags, as on the backends its tests were written for."""
    probe = jms.probe

    def simulated(device=None, n_devices=None):
        sp = probe(device, n_devices)
        return jms.MemSpace(host_kind=sp.device_kind,
                            device_kind=sp.device_kind, simulated=True,
                            backend=sp.backend, n_devices=sp.n_devices)

    monkeypatch.setattr(jms, "probe", simulated)
    jms.reset()
    yield
    jms.reset()


def _rules(rules):
    return [tuple(getattr(r, f) for f in ("kind", "p", "nth", "device",
                                          "seed", "ms")) for r in rules]


# --------------------------------------------------------------------- #
# spec grammar                                                           #
# --------------------------------------------------------------------- #
def test_parse_spec_full_grammar():
    spec = "transfer:p=0.05,device=1,seed=7;kernel:nth=13"
    rules = flt.parse_spec(spec)
    assert rules == (
        flt.FaultRule(kind="transfer", p=0.05, device=1, seed=7),
        flt.FaultRule(kind="kernel", nth=13))
    assert _rules(rules) == _rules(jflt.parse_spec(spec))


def test_parse_spec_empty_is_no_rules():
    assert flt.parse_spec("") == ()
    assert flt.parse_spec("  ") == ()
    assert flt.FaultInjector.from_spec("") is None


@pytest.mark.parametrize("bad", [
    "bogus:p=1",           # unknown fault kind
    "transfer:q=1",        # unknown parameter
    "transfer:p=1.5",      # probability out of range
    "transfer:nth=0",      # nth counts from 1
    "transfer:device=-1",  # negative device index
    "transfer",            # non-latency rule with no trigger
    "kernel:p=x",          # unparseable value
])
def test_parse_spec_rejects(bad):
    with pytest.raises(ValueError) as got:
        flt.parse_spec(bad)
    with pytest.raises(ValueError) as want:
        jflt.parse_spec(bad)
    assert str(got.value) == str(want.value)


def test_config_validates_fault_knobs():
    with pytest.raises(ValueError):
        OffloadConfig(faults="bogus:p=1")
    with pytest.raises(ValueError):
        OffloadConfig(retries=-1)
    with pytest.raises(ValueError):
        OffloadConfig(backoff_ms=-0.5)
    cfg = OffloadConfig(faults="transfer:p=0.5,seed=3", retries=4)
    assert cfg.retries == 4


# --------------------------------------------------------------------- #
# exception classification                                               #
# --------------------------------------------------------------------- #
def test_classify_maps_absorbable_errors():
    oom = flt.classify("transfer", MemoryError("boom"), device=1,
                       nbytes=64)
    assert isinstance(oom, flt.DeviceOOMError) and not oom.transient
    assert oom.device == 1 and oom.nbytes == 64
    oom2 = flt.classify("kernel", RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert isinstance(oom2, flt.DeviceOOMError)
    tr = flt.classify("transfer", OSError("link reset"))
    assert isinstance(tr, flt.TransferError) and tr.transient
    kr = flt.classify("kernel", RuntimeError("launch failed"))
    assert isinstance(kr, flt.KernelError) and kr.transient
    # the port maps the allocator's OOM by type, whatever its message
    cuda_oom = flt.classify("transfer",
                            torch.cuda.OutOfMemoryError("no room"))
    assert isinstance(cuda_oom, flt.DeviceOOMError)


def test_classify_leaves_bugs_alone():
    # bugs in our own stack must keep their type and traceback
    assert flt.classify("kernel", TypeError("bad arg")) is None
    assert flt.classify("transfer", ValueError("shape")) is None
    # already-typed errors pass through unchanged
    e = flt.TransferError("x", device=2)
    assert flt.classify("transfer", e) is e


_NOT_THE_DEVICES = [
    compat.KernelBuildError("kernel build failed: gemm.cu (nvcc exit 2)"),
    compat.KernelLaunchError("gemm: launch failed with cudaError 719"),
    compat.KernelLaunchError("gemm: TMA descriptors could not be made"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
    RuntimeError("CUDA error: misaligned address"),
    RuntimeError("CUDA error: an illegal instruction was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
] + ([torch.AcceleratorError("CUDA error")]
     if hasattr(torch, "AcceleratorError") else [])


@pytest.mark.parametrize("exc", _NOT_THE_DEVICES,
                         ids=lambda e: type(e).__name__ + ":" + str(e)[:24])
def test_classify_refuses_port_and_sticky_errors(exc):
    """The port's departure: its own build and launch errors and CUDA's
    sticky errors are never absorbed, at either site; the reference
    would have taken each of them for a device fault."""
    for site in ("transfer", "kernel"):
        assert flt.classify(site, exc) is None
    if isinstance(exc, RuntimeError):
        assert jflt.classify("kernel", exc) is not None


@pytest.mark.parametrize("make,typed", [
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"),
     flt.DeviceOOMError),
    (lambda: RuntimeError("cudaMemcpyAsync failed"), flt.TransferError),
    (lambda: flt.KernelError("injected", injected=True), flt.KernelError),
    (lambda: compat.KernelBuildError("kernel build failed"),
     compat.KernelBuildError),
    (lambda: ValueError("shape"), ValueError),
], ids=["oom", "transfer", "typed", "build", "bug"])
def test_raise_typed_types_chains_and_frees_its_frames(make, typed):
    """``raise_typed`` raises what ``classify`` makes of the error: a
    wrapped error chained to the raw one, or the raw one itself.  The
    failing unit's operand is freed once the caller drops the error,
    without the cyclic collector: no frame keeps the error it raised."""
    import gc
    import weakref

    def unit(x):
        try:
            raise make()
        except Exception as exc:
            flt.raise_typed("transfer", exc, device=1, nbytes=x.nbytes)

    gc.collect()
    gc.disable()
    try:
        x = torch.zeros(16)
        ref = weakref.ref(x)
        with pytest.raises(typed) as got:
            unit(x)
        err = got.value
        raw = err.__cause__ or err
        assert type(raw) is type(make())
        if err is not raw:
            assert (err.device, err.nbytes) == (1, 64)
        del x, got, err, raw
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("exc", _NOT_THE_DEVICES[:4],
                         ids=lambda e: type(e).__name__)
def test_port_errors_propagate_out_of_a_session_call(exc, monkeypatch):
    """A build failure, a failed launch or a sticky error inside the
    kernel unit leaves the session call as it is: no retry, no fallback,
    no breaker failure."""
    def broken(*args, **kw):
        raise exc

    monkeypatch.setattr(kops, "matmul", broken)
    cfg = OffloadConfig(policy="dfu", threshold=10.0, retries=3,
                        dispatch_cache=False)
    with Session(cfg, device="cpu", record_trace=True,
                 intercept=False) as s:
        with pytest.raises(type(exc)) as got:
            blas.gemm(host_array(_mat(64)), host_array(_mat(64)))
        st = s.stats
        assert got.value is exc
        assert (st.faults, st.retries, st.fallbacks, st.quarantines) == \
            (0, 0, 0, 0)
        assert s.runtime.health.device(0).failures == 0
        assert s.trace.event_count("fault") == 0


# --------------------------------------------------------------------- #
# the injector                                                           #
# --------------------------------------------------------------------- #
def _injected_pattern(mod, spec, n=200, site="transfer", device=None):
    inj = mod.FaultInjector.from_spec(spec)
    out = []
    for _ in range(n):
        try:
            inj.check(site, device=device, nbytes=8)
            out.append(0)
        except mod.OffloadError:
            out.append(1)
    return out


def test_injector_is_deterministic():
    a = _injected_pattern(flt, "transfer:p=0.2,seed=11")
    b = _injected_pattern(flt, "transfer:p=0.2,seed=11")
    assert a == b and sum(a) > 0
    c = _injected_pattern(flt, "transfer:p=0.2,seed=12")
    assert a != c
    # the same seeded stream as the reference's: one spec, one pattern
    assert a == _injected_pattern(jflt, "transfer:p=0.2,seed=11")


def test_injector_nth_fires_periodically():
    hits = _injected_pattern(flt, "transfer:nth=5", n=20)
    assert hits == [0, 0, 0, 0, 1] * 4


def test_injector_device_filter():
    # device-filtered rule fires only on its device, never on device=None
    assert sum(_injected_pattern(flt, "transfer:p=1,device=1",
                                 device=0)) == 0
    assert sum(_injected_pattern(flt, "transfer:p=1,device=1",
                                 device=None)) == 0
    assert sum(_injected_pattern(flt, "transfer:p=1,device=1", device=1,
                                 n=5)) == 5


def test_injector_site_and_kind_mapping():
    with pytest.raises(flt.DeviceOOMError):
        flt.FaultInjector.from_spec("oom:p=1").check("transfer")
    with pytest.raises(flt.KernelError):
        flt.FaultInjector.from_spec("kernel:p=1").check("kernel")
    # kernel rules never fire at transfer sites and vice versa
    flt.FaultInjector.from_spec("kernel:p=1").check("transfer")
    flt.FaultInjector.from_spec("transfer:p=1").check("kernel")
    # latency injects a stall, not an error
    t0 = time.perf_counter()
    flt.FaultInjector.from_spec("latency:p=1,ms=5").check("transfer")
    assert time.perf_counter() - t0 >= 0.004


# --------------------------------------------------------------------- #
# retry policy + breaker state machine                                   #
# --------------------------------------------------------------------- #
def test_retry_backoff_is_exponential():
    rp = flt.RetryPolicy(attempts=3, backoff_ms=8.0)
    assert [rp.delay_s(a) for a in range(3)] == [0.008, 0.016, 0.032]


def test_breaker_state_machine_with_fake_clock():
    now = [0.0]
    events = []
    ht = flt.HealthTracker(
        2, threshold=3, cooldown_ms=100.0, clock=lambda: now[0],
        on_quarantine=lambda d: events.append(("q", d)),
        on_recover=lambda d: events.append(("r", d)))
    assert not ht.failure(1) and not ht.failure(1)
    ht.ok(1)
    assert ht.device(1).state == flt.CLOSED
    assert [ht.failure(1) for _ in range(3)] == [False, False, True]
    assert ht.device(1).state == flt.OPEN
    assert not ht.usable(1) and ht.usable(0)
    assert ht.usable_count() == 1 and ht.usable_devices() == [0]
    assert events == [("q", 1)]
    now[0] = 0.2
    assert ht.usable(1) and ht.device(1).state == flt.HALF_OPEN
    assert ht.failure(1)
    assert ht.device(1).state == flt.OPEN and events[-1] == ("q", 1)
    now[0] = 0.4
    assert ht.usable(1)
    ht.ok(1)
    assert ht.device(1).state == flt.CLOSED and events[-1] == ("r", 1)
    assert ht.usable_count() == 2


def test_breaker_disabled_never_trips():
    ht = flt.HealthTracker(1, threshold=0)
    for _ in range(50):
        ht.failure(0)
    assert ht.usable(0) and ht.device(0).quarantines == 0


# --------------------------------------------------------------------- #
# runtime integration: the port against the reference's live run         #
# --------------------------------------------------------------------- #
def _operands(n_calls=6, n=96, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, n)).astype(np.float32),
             rng.standard_normal((n, n)).astype(np.float32))
            for _ in range(n_calls)]


def _snap(st, routine):
    r = st.per_routine[routine]
    return dict(faults=st.faults, retries=st.retries,
                fallbacks=st.fallbacks, quarantines=st.quarantines,
                recoveries=st.recoveries, bytes_in=r.bytes_in,
                cache_hits=r.cache_hits, offloaded=r.offloaded,
                on_host=r.on_host)


def _port_run(kw, ops=None, trace_path=""):
    ops = _operands() if ops is None else ops
    cfg = OffloadConfig(**kw, trace_path=trace_path)
    with Session(cfg, device="cpu", record_trace=True,
                 intercept=False) as s:
        outs = [blas.gemm(host_array(a), host_array(b)).numpy().copy()
                for a, b in ops]
        snap, trace = _snap(s.stats, "sgemm"), s.trace
        health = s.runtime.health
        report = s.report()
    return outs, snap, trace, health, report


def _ref_run(kw, ops=None):
    ops = _operands() if ops is None else ops
    with JSession(JConfig(**kw), record_trace=True, intercept=False) as s:
        outs = [np.asarray(jblas.gemm(jhost(a), jhost(b))) for a, b in ops]
        return outs, _snap(s.runtime.stats, "sgemm")


def _host_products(ops):
    return [(torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
            for a, b in ops]


def test_retry_absorbs_transient_faults_exactly(ref_tiers):
    """A retried fault is a perfect no-op: every byte/hit/offload
    counter matches the unfaulted run, and results are bit-identical."""
    base = dict(policy="dfu", threshold=10.0)
    chaos = dict(base, faults="transfer:nth=2", retries=2, backoff_ms=0.0)
    o0, clean, *_ = _port_run(base)
    o1, chaotic, *_ = _port_run(chaos)
    assert chaotic["faults"] > 0
    assert chaotic["retries"] == chaotic["faults"]
    assert chaotic["fallbacks"] == 0
    for key in ("bytes_in", "cache_hits", "offloaded", "on_host"):
        assert chaotic[key] == clean[key], key
    for a, b in zip(o0, o1):
        assert np.array_equal(a, b)
    refs, ref_snap = _ref_run(chaos)
    assert chaotic == ref_snap
    for got, want in zip(o1, refs):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_kernel_fault_exhaustion_falls_back_bit_identically(ref_tiers):
    kw = dict(policy="dfu", threshold=10.0, faults="kernel:p=1,seed=5",
              retries=0, breaker=0)
    ops = _operands()
    outs, snap, *_ = _port_run(kw, ops)
    assert snap["fallbacks"] == 6 and snap["on_host"] == 6
    assert snap["offloaded"] == 0
    for got, ref in zip(outs, _host_products(ops)):
        assert np.array_equal(got, ref)     # the same closure, same values
    assert snap == _ref_run(kw, ops)[1]


def test_oom_is_permanent_no_retries(ref_tiers):
    kw = dict(policy="dfu", threshold=10.0, faults="oom:p=1", retries=3,
              breaker=0, backoff_ms=0.0)
    _, snap, *_ = _port_run(kw)
    assert snap["faults"] > 0 and snap["retries"] == 0
    assert snap["fallbacks"] == 6
    assert snap == _ref_run(kw)[1]


@pytest.mark.parametrize("spec,retries", [("kernel:nth=2", 1),
                                          ("transfer:p=1", 0),
                                          ("oom:p=1", 0)])
def test_faulted_calls_leave_no_reference_cycles(spec, retries):
    """A fault's traceback holds the guard's frame; a frame that kept the
    error would form a cycle holding the unit's operands (on the card,
    HBM) until the cyclic collector ran.  Retried and fallen-back calls
    free their operands as soon as the caller drops them."""
    import gc
    import weakref
    cfg = OffloadConfig(policy="dfu", threshold=10.0, faults=spec,
                        retries=retries, backoff_ms=0.0, breaker=0)
    gc.collect()
    gc.disable()
    try:
        with Session(cfg, device="cpu", record_trace=False,
                     intercept=False) as s:
            a, b = host_array(_mat(64)), host_array(_mat(64))
            blas.gemm(a, b)
            out = blas.gemm(a, b)
            assert s.stats.faults > 0
            refs = [weakref.ref(x) for x in (a, b, out)]
            del a, b, out
            assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_real_bugs_still_propagate():
    """A shape mismatch is a bug, not a device fault.  PyTorch raises it
    as a RuntimeError (JAX as a TypeError), so the guard takes it for a
    kernel fault, retries it and falls back; the host rerun runs the same
    closure unguarded and the bug surfaces there, with its own message,
    instead of being swallowed."""
    with Session(OffloadConfig(policy="dfu", threshold=10.0, retries=3,
                               backoff_ms=0.0),
                 device="cpu", record_trace=False, intercept=False) as s:
        with pytest.raises(RuntimeError, match="cannot be multiplied"):
            blas.gemm(host_array(_mat(8)), host_array(_mat(16)))
        st = s.stats
        assert (st.faults, st.retries, st.fallbacks) == (4, 3, 1)


def test_degraded_mode_serves_from_host(ref_tiers):
    """Breaker tripped on every device -> host-only degraded mode keeps
    serving with correct results (no exception escapes)."""
    kw = dict(policy="dfu", threshold=10.0,
              faults="transfer:p=1,seed=2", retries=0, breaker=2,
              breaker_cooldown_ms=60_000.0)
    ops = _operands()
    outs, snap, _, health, _ = _port_run(kw, ops)
    assert snap["quarantines"] == 1
    assert snap["fallbacks"] == 6
    assert not health.any_usable()
    for got, ref in zip(outs, _host_products(ops)):
        assert np.array_equal(got, ref)
    assert snap == _ref_run(kw, ops)[1]


def test_report_shows_health_only_under_faults():
    ops = _operands(n_calls=1)
    *_, report = _port_run(dict(policy="dfu", threshold=10.0), ops)
    assert "health:" not in report
    *_, report = _port_run(dict(policy="dfu", threshold=10.0,
                                faults="kernel:nth=1", retries=1,
                                backoff_ms=0.0), ops)
    assert "health:" in report and "dev0:" in report


# --------------------------------------------------------------------- #
# quarantine -> re-shard -> recover (three tiers)                        #
# --------------------------------------------------------------------- #
def _quarantine_walk(pkg):
    """The reference test's sequence on one package: returns the
    counters after each step and the results against the numpy
    products."""
    rng = np.random.default_rng(31)
    ops = [(rng.standard_normal((384, 384)).astype(np.float32),
            rng.standard_normal((384, 384)).astype(np.float32))
           for _ in range(4)]
    kw = dict(policy="dfu", threshold=10.0, devices=3,
              faults="transfer:p=1,device=1,seed=1", retries=0,
              breaker=2, breaker_cooldown_ms=50.0)
    if pkg == "port":
        sess = Session(OffloadConfig(**kw), device="cpu",
                       record_trace=False, intercept=False)
        gemm = lambda a, b: blas.gemm(host_array(a),   # noqa: E731
                                      host_array(b))
    else:
        sess = JSession(JConfig(**kw), record_trace=False, intercept=False)
        gemm = lambda a, b: jblas.gemm(jhost(a), jhost(b))   # noqa: E731
    steps = []
    with sess as s:
        rt = s.runtime
        # the breaker's clock, advanced by hand: the cooldown elapses
        # exactly where the walk says, however long each call takes
        now = [0.0]
        rt.health.clock = lambda: now[0]

        kept = []       # results stay alive, so do their output blocks

        def call(i):
            kept.append(gemm(*ops[i]))
            np.testing.assert_allclose(np.asarray(kept[-1]),
                                       ops[i][0] @ ops[i][1],
                                       rtol=2e-3, atol=2e-3)
            st = rt.stats
            steps.append((st.quarantines, st.fallbacks, st.recoveries,
                          rt.health.usable(1),
                          rt.block_stores[1].resident_bytes,
                          st.per_routine["sgemm"].sharded,
                          st.per_device.get(1) and st.per_device[1].tiles,
                          rt.health.device(1).state))

        call(0)
        call(1)
        call(2)
        s.reconfigure(faults="")
        now[0] = 0.06
        call(3)
    return steps


def test_quarantine_reshard_recover(ref_tiers):
    steps = _quarantine_walk("port")
    # two sharded calls hit dev1 tiles -> 2 consecutive unit failures ->
    # quarantine (each call itself falls back), dev1 invalidated
    assert steps[1][:5] == (1, 2, 0, False, 0)
    # the next call re-shards across the healthy pair: no new fallback,
    # dev1 idle
    q, fb, _, _, _, sharded, dev1_tiles, _ = steps[2]
    assert (q, fb, sharded, dev1_tiles) == (1, 2, 1, 0)
    assert steps[2][3] is False and steps[2][7] == flt.OPEN
    # past the cooldown the half-open probe succeeds and dev1 rejoins
    assert steps[3][2:4] == (1, True) and steps[3][7] == flt.CLOSED
    assert steps[3][6] >= 1
    assert steps == _quarantine_walk("reference")


def _breaker_walk(pkg):
    """The breaker walk of chip_smoke.py's runtime phase at CPU size."""
    rng = np.random.default_rng(41)
    a, b, c1, c2 = (rng.standard_normal((96, 96)).astype(np.float32)
                    for _ in range(4))
    kw = dict(policy="dfu", threshold=10.0, faults="kernel:nth=1",
              retries=0, breaker=3, breaker_cooldown_ms=200.0)
    if pkg == "port":
        sess = Session(OffloadConfig(**kw), device="cpu",
                       record_trace=False, intercept=False)
        host, gemm = host_array, blas.gemm
    else:
        sess = JSession(JConfig(**kw), record_trace=False, intercept=False)
        host, gemm = jhost, jblas.gemm
    ha, hb, hc1, hc2 = (host(x) for x in (a, b, c1, c2))
    steps = []
    with sess as s:
        rt = s.runtime
        now = [0.0]
        rt.health.clock = lambda: now[0]
        for i, x in enumerate((ha, ha, ha, hc1, hc2, ha)):
            if i == 3:
                s.reconfigure(faults="transfer:p=1")
            gemm(x, hb)
            st = rt.stats
            steps.append((st.faults, st.fallbacks, st.quarantines,
                          rt.health.device(0).consecutive,
                          rt.placements.resident_bytes,
                          rt.health.device(0).state))
        s.reconfigure(faults="")
        now[0] = 1.0
        gemm(ha, hb)
        st = rt.stats
        steps.append((st.faults, st.fallbacks, st.quarantines,
                      st.recoveries, rt.health.device(0).state))
    return steps


def test_breaker_walk_kernel_faults_reset_by_transfers(ref_tiers):
    """A successful unit resets the consecutive count: kernel faults
    after each call's successful operand placements never trip the
    breaker; transfer faults at a call's first unit do, and the
    quarantine invalidates the placements.  The walk chip_smoke.py runs
    on the card, against the reference's live run."""
    steps = _breaker_walk("port")
    n = 96 * 96 * 4
    assert steps[:6] == [(1, 1, 0, 1, 2 * n, "closed"),
                         (2, 2, 0, 1, 2 * n, "closed"),
                         (3, 3, 0, 1, 2 * n, "closed"),
                         (4, 4, 0, 2, 2 * n, "closed"),
                         (5, 5, 1, 3, 0, "open"),
                         (5, 6, 1, 3, 0, "open")]
    assert steps[6] == (5, 6, 1, 1, "closed")
    assert steps == _breaker_walk("reference")


# --------------------------------------------------------------------- #
# live == replay                                                         #
# --------------------------------------------------------------------- #
def test_faulted_live_run_matches_replay_counters(tmp_path):
    # kernel faults get absorbed by the retry; oom faults are permanent
    # and fall back — the trace must carry both accurately, through the
    # port's memtier and through the reference's on the dumped trace
    kw = dict(policy="dfu", threshold=10.0,
              faults="kernel:nth=3;oom:nth=5", retries=1, backoff_ms=0.0,
              breaker=0)
    _, snap, trace, *_ = _port_run(kw, _operands(n_calls=8))
    live = tuple(snap[k] for k in ("faults", "retries", "fallbacks",
                                   "quarantines", "recoveries"))
    assert snap["retries"] > 0 and snap["fallbacks"] > 0
    rep = MemTierSimulator.from_config(OffloadConfig(**kw)).run(trace)
    assert (rep.faults, rep.retries, rep.fallbacks, rep.quarantines,
            rep.recoveries) == live
    assert rep.host_calls >= snap["fallbacks"]
    path = str(tmp_path / "t.json")
    trace.dump(path)
    jrep = JSim.from_config(JConfig(**kw)).run(JTrace.load(path))
    assert (jrep.faults, jrep.retries, jrep.fallbacks, jrep.quarantines,
            jrep.recoveries) == live
    assert jrep.host_calls == rep.host_calls


def test_fault_events_roundtrip_through_dump(tmp_path):
    path = str(tmp_path / "t.json")
    kw = dict(policy="dfu", threshold=10.0, faults="kernel:nth=2",
              retries=0, breaker=0)
    _port_run(kw, _operands(n_calls=4), trace_path=path)
    loaded = Trace.load(path)
    assert loaded.event_count("fault") > 0
    assert loaded.event_count("fallback") == loaded.event_count("fault")
    rep = MemTierSimulator.from_config(OffloadConfig(**kw)).run(loaded)
    assert rep.fallbacks == loaded.event_count("fallback")
    assert JTrace.load(path).event_count("fault") == \
        loaded.event_count("fault")


def test_trace_dump_is_atomic(tmp_path):
    """A dump that cannot serialize leaves no partial file behind."""
    t = Trace()
    t.gemm("s", 8, 8, 8, t.new_buffer(256), t.new_buffer(256),
           t.new_buffer(256))
    target = tmp_path / "out.json"
    t.dump(str(target))
    good = target.read_bytes()
    t.calls.append(object())           # unserializable: dump must fail
    with pytest.raises(Exception):
        t.dump(str(target))
    assert target.read_bytes() == good
    assert list(tmp_path.iterdir()) == [target]


# --------------------------------------------------------------------- #
# exception-safe sync()                                                  #
# --------------------------------------------------------------------- #
def test_sync_drains_everything_and_reraises_first():
    class _Event:
        def __init__(self, log, fail=None):
            self.log, self.fail = log, fail

        def synchronize(self):
            self.log.append(self)
            if self.fail is not None:
                raise self.fail

    with Session(OffloadConfig(policy="dfu"), device="cpu",
                 record_trace=False, intercept=False) as s:
        rt = s.runtime
        log = []
        first = RuntimeError("first failure")
        evs = [_Event(log), _Event(log, first), _Event(log),
               _Event(log, RuntimeError("second failure")), _Event(log)]
        rt._pending.extend(evs)
        with pytest.raises(RuntimeError) as exc_info:
            rt.sync()
        assert exc_info.value is first
        assert log == evs                   # every event was awaited
        assert not rt._pending              # queue fully drained
        assert any("second failure" in n for n in first.__notes__)
        rt._pending.append(_Event(log))
        rt.sync()                           # clean sync still works


# --------------------------------------------------------------------- #
# property: any fault spec leaves results bit-identical                  #
# --------------------------------------------------------------------- #
def _check_bit_identity(spec, retries):
    """Under any injected fault pattern the results equal the unfaulted
    host-path run bit for bit."""
    a = RNG.standard_normal((64, 64)).astype(np.float32)
    b = RNG.standard_normal((64, 64)).astype(np.float32)
    with Session(OffloadConfig(policy="cpu"), device="cpu",
                 record_trace=False, intercept=False):
        want = blas.gemm(host_array(a), host_array(b)).numpy()
    cfg = OffloadConfig(policy="dfu", threshold=10.0, faults=spec,
                        retries=retries, backoff_ms=0.0, breaker=2,
                        breaker_cooldown_ms=60_000.0)
    with Session(cfg, device="cpu", record_trace=False, intercept=False):
        got = blas.gemm(host_array(a), host_array(b)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("spec,retries", [
    ("", 2),
    ("transfer:p=1,seed=0", 0),
    ("transfer:nth=1", 2),
    ("kernel:p=1,seed=9", 1),
    ("oom:p=1", 3),
    ("latency:p=1,ms=1", 0),
    ("transfer:p=0.62,seed=4;kernel:nth=2", 1),
])
def test_fault_specs_are_bit_identical_to_host(spec, retries):
    _check_bit_identity(spec, retries)


try:                                    # hypothesis widens the sweep
    from hypothesis import given, settings
    from hypothesis import strategies as st_
except ImportError:                     # pragma: no cover
    given = None

if given is not None:
    _SPECS = st_.one_of(
        st_.just(""),
        st_.builds(lambda k, p, s: f"{k}:p={p:.2f},seed={s}",
                   st_.sampled_from(["transfer", "kernel", "oom"]),
                   st_.floats(0.0, 1.0), st_.integers(0, 99)),
        st_.builds(lambda k, n: f"{k}:nth={n}",
                   st_.sampled_from(["transfer", "kernel"]),
                   st_.integers(1, 5)),
        st_.builds(
            lambda p, s, n: f"transfer:p={p:.2f},seed={s};kernel:nth={n}",
            st_.floats(0.0, 1.0), st_.integers(0, 99),
            st_.integers(1, 5)),
    )

    @settings(max_examples=12, deadline=None)
    @given(spec=_SPECS, retries=st_.integers(0, 2))
    def test_any_fault_spec_is_bit_identical_to_host(spec, retries):
        _check_bit_identity(spec, retries)

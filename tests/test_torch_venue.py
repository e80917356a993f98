"""The port's `pallas` dispatch venue and adaptive per-site racing, twins
of ``tests/test_kernel_venue.py``.

Default-off bit-identity (golden counters, venue-free trace dumps), venue
tags and counters equal to the reference's on one deterministic workload,
the capability matrix, the three-venue probe schedule and lock (with
injected samples and end to end), the two-venue schedule without
``kernel_path``, and split probing as a venue.  Both packages get the
same numpy inputs; the port runs on the CPU (simulated tiers), where its
kernel wrappers take their plain versions.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402
from repro.core.trace import Trace as JTrace  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, callsite, host_array  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.runtime import RoutineStats  # noqa: E402
from repro_torch.kernels import ops, syrk  # noqa: E402

RNG = np.random.default_rng(3)

#: counters both packages keep; wall times are not compared
COUNTERS = [f.name for f in dataclasses.fields(RoutineStats)
            if not f.name.endswith("seconds")]

#: the BlasCall keys a dump carries without venue or precision tags (the
#: schema before the venue stage was ported)
PLAIN_KEYS = {"routine", "m", "n", "k", "operands", "batch", "devices",
             "callsite_id", "seconds", "out_buf", "out_nbytes"}


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _kcfg(cls, **kw):
    kw.setdefault("policy", "dfu")
    kw.setdefault("threshold", 20.0)
    kw.setdefault("kernel_path", True)
    kw.setdefault("sync", True)
    return cls(**kw)


def _inputs():
    tri = np.tril(RNG.standard_normal((96, 96)) / 96)
    np.fill_diagonal(tri, 2.0)
    return dict(
        a=RNG.standard_normal((96, 96)).astype(np.float32),
        t=tri.astype(np.float32),
        c=(RNG.standard_normal((64, 48))
           + 1j * RNG.standard_normal((64, 48))).astype(np.complex64),
        d=RNG.standard_normal((64, 48)),
        s=RNG.standard_normal((8, 8)).astype(np.float32))


def _workload(bl, x):
    """Every venue rule once: sgemm x4 lean, ssyrk (kernel), strsm
    (kernel), cgemm (4M kernel), csyrk (no kernel), strmm (no kernel),
    dgemm (no venue kernel without a split scheme), dsyrk with alpha
    (kernel, generic epilogue), a gemm below the threshold (host)."""
    outs = [bl.gemm(x["a"], x["a"]) for _ in range(4)]
    outs += [bl.syrk(x["a"]), bl.trsm(x["t"], x["a"]),
             bl.gemm(x["c"], x["c"], trans_b="C"), bl.syrk(x["c"]),
             bl.trmm(x["t"], x["a"]), bl.gemm(x["d"], x["d"], trans_b="T"),
             bl.syrk(x["d"], alpha=2.0, uplo="U"), bl.gemm(x["s"], x["s"])]
    return outs


def _run_ref(x, cfg):
    with repro.session(cfg, intercept=False) as s:
        jx = {k: jcore.host_array(jnp.asarray(v)) for k, v in x.items()}
        outs = [np.asarray(o) for o in _workload(jcore.blas, jx)]
        s.sync()
        stats = {k: dataclasses.asdict(v)
                 for k, v in s.stats.per_routine.items()}
        return outs, stats, s.trace, s.report()


def _run_port(x, cfg):
    with repro_torch.session(cfg, device="cpu", intercept=False) as s:
        tx = {k: host_array(v) for k, v in x.items()}
        outs = [o.numpy() for o in _workload(blas, tx)]
        stats = {k: dataclasses.asdict(v)
                 for k, v in s.stats.per_routine.items()}
        return outs, stats, s.trace, s.report()


# --------------------------------------------------------------------- #
# default-off bit-identity                                               #
# --------------------------------------------------------------------- #
def test_kernels_off_golden_counters():
    """kernel_path off (the default) reproduces the golden counters of
    ``tests/test_kernel_venue.py`` on the capped eviction workload: the
    venue stage is a true no-op."""
    rng = np.random.default_rng(42)
    cfg = OffloadConfig(policy="dfu", threshold=10,
                        device_bytes=2 * 128 * 128 * 4)
    with repro_torch.session(cfg, device="cpu", record_trace=False,
                             intercept=False) as s:
        xs = [host_array(rng.standard_normal((128, 128)).astype("float32"))
              for _ in range(5)]
        # the outputs stay alive, as the reference's async window holds
        # its last 32 (a dead output's placement would free its bytes)
        outs = [blas.gemm(x, x) for _ in range(3) for x in xs]
        assert len(outs) == 15
        assert s.stats.evictions == 28
        assert s.stats.evicted_bytes == 1835008
        st = s.stats.per_routine["sgemm"]
        assert (st.offloaded, st.on_host) == (15, 0)
        assert (st.cache_hits, st.cache_misses) == (15, 15)
        assert st.kernel_calls == 0
        assert "pallas" not in s.report()


def test_kernels_off_trace_dump_is_venue_free(tmp_path):
    """A default-off dump carries no venue or precision keys: the same
    keys as a dump written before the venue stage was ported, and it
    loads in the reference's Trace."""
    path = tmp_path / "t.json"
    with repro_torch.session(OffloadConfig(policy="dfu", threshold=1.0),
                             device="cpu", intercept=False) as s:
        a = host_array(RNG.standard_normal((64, 64)).astype(np.float32))
        blas.gemm(a, a)
        blas.syrk(a)
        assert all(c.venue == "" and c.precision == ""
                   for c in s.trace.calls)
        s.trace.dump(str(path))
    for call in json.loads(path.read_text())["calls"]:
        assert set(call) == PLAIN_KEYS
    assert all(c.venue == "" for c in JTrace.load(str(path)).calls)


# --------------------------------------------------------------------- #
# forced kernel path: tags and counters equal the reference's            #
# --------------------------------------------------------------------- #
def test_venue_tags_counters_match_reference(tmp_path):
    x = _inputs()
    jouts, jstats, jtrace, jreport = _run_ref(x, _kcfg(JConfig))
    touts, tstats, ttrace, treport = _run_port(x, _kcfg(OffloadConfig))
    venues = [c.venue for c in ttrace.calls]
    assert venues == [c.venue for c in jtrace.calls]
    assert venues == (["pallas"] * 4 + ["pallas", "pallas", "pallas", "xla",
                                        "xla", "xla", "pallas", "host"])
    assert tstats.keys() == jstats.keys()
    for name in tstats:
        for field in COUNTERS:
            assert tstats[name][field] == jstats[name][field], (name, field)
    assert sum(r["kernel_calls"] for r in tstats.values()) == 8
    assert "pallas venue: 8 calls" in treport
    assert "pallas venue: 8 calls" in jreport
    for got, want in zip(touts, jouts):
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() / scale <= 1e-5
    # the venue tags survive a dump and the reference's loader
    ttrace.dump(str(tmp_path / "port.json"))
    loaded = JTrace.load(str(tmp_path / "port.json"))
    assert [c.venue for c in loaded.calls] == venues


def test_capability_matrix_is_the_references():
    """kernel_available gives the reference's answer for every base,
    dtype and scheme, so both packages take the same venue decisions."""
    dtypes = [("float32", torch.float32), ("float64", torch.float64),
              ("bfloat16", torch.bfloat16), ("complex64", torch.complex64),
              ("complex128", torch.complex128)]
    for base in ("gemm", "syrk", "trsm", "trmm", "symm", "syr2k", "gemv"):
        for jname, tdt in dtypes:
            for scheme in ("", "split2", "split3"):
                assert (ops.kernel_available(base, tdt, scheme)
                        == jops.kernel_available(base, jnp.dtype(jname),
                                                 scheme)), (base, jname,
                                                            scheme)
    assert ops.KERNEL_BASES == jops.KERNEL_BASES
    assert ops.SPLIT_KERNEL_BASES == jops.SPLIT_KERNEL_BASES


def test_syrk_venue_runs_the_syrk_module_and_full_product_elsewhere():
    """The `pallas` venue's lean syrk goes through the syrk kernel
    module (one triangle); the `xla` venue masks a full product; both
    give the same triangle."""
    a = host_array(RNG.standard_normal((200, 48)))
    seen = []
    real = syrk.syrk

    def spy(x, **kw):
        seen.append(kw)
        return real(x, **kw)
    for kernel_path in (True, False):
        with repro_torch.session(_kcfg(OffloadConfig,
                                       kernel_path=kernel_path),
                                 device="cpu", intercept=False) as s:
            syrk.syrk = spy
            try:
                got = blas.syrk(a, trans="T", uplo="U")
            finally:
                syrk.syrk = real
            venue = s.trace.calls[-1].venue
        assert venue == ("pallas" if kernel_path else "")
        np.testing.assert_allclose(got.numpy(),
                                   np.triu(a.numpy().T @ a.numpy()),
                                   rtol=1e-12, atol=1e-12)
    assert seen == [dict(uplo="U", trans="T")]


def test_generic_epilogue_numerics_on_pallas_venue():
    """alpha/beta/C/transpose epilogues through the kernel venue match
    the BLAS definition (the lean path covers only alpha=1, beta=0)."""
    with repro_torch.session(_kcfg(OffloadConfig, threshold=1.0),
                             device="cpu", intercept=False) as s:
        a = host_array(RNG.standard_normal((48, 32)).astype(np.float32))
        b = host_array(RNG.standard_normal((32, 40)).astype(np.float32))
        c = host_array(RNG.standard_normal((48, 40)).astype(np.float32))
        an, bn, cn = a.numpy(), b.numpy(), c.numpy()
        out = blas.gemm(a, b, c, alpha=0.5, beta=2.0)
        np.testing.assert_allclose(out.numpy(), 0.5 * (an @ bn) + 2.0 * cn,
                                   rtol=1e-4, atol=1e-4)
        out2 = blas.gemm(a, a, alpha=3.0, trans_b="T")
        np.testing.assert_allclose(out2.numpy(), 3.0 * (an @ an.T),
                                   rtol=1e-4, atol=1e-4)
        out3 = blas.syrk(a, alpha=2.0, uplo="U")
        np.testing.assert_allclose(out3.numpy(), np.triu(2.0 * an @ an.T),
                                   rtol=1e-4, atol=1e-4)
        t = np.tril(RNG.standard_normal((48, 48))) / 48 + 2 * np.eye(48)
        x = blas.trsm(host_array(t.astype(np.float32)), c, alpha=2.0)
        np.testing.assert_allclose(t @ x.numpy(), 2.0 * cn, rtol=1e-4,
                                   atol=1e-4)
        assert all(cl.venue == "pallas" for cl in s.trace.calls)


# --------------------------------------------------------------------- #
# adaptive warmup                                                        #
# --------------------------------------------------------------------- #
def _site(x, y):
    """One stable call site for the adaptive tests."""
    return blas.gemm(x, y)


def test_three_venue_probe_schedule_and_lock():
    """With kernel_path on, the warmup round-robins host/xla/pallas
    (equal samples each), records the probe venue in the trace, emits a
    venue event on the lock and locks the best-sample venue."""
    cfg = _kcfg(OffloadConfig, adaptive=True, adaptive_warmup=6,
                threshold=100.0)
    with repro_torch.session(cfg, device="cpu", intercept=False) as s:
        a = host_array(RNG.standard_normal((64, 64)).astype(np.float32))
        for _ in range(6):
            _site(a, a)
        (prof,) = list(s.runtime.callsites)
        assert (prof.host_timed, prof.device_timed,
                prof.kernel_timed) == (2, 2, 2)
        assert prof.locked is None
        assert [c.venue for c in s.trace.calls] == \
            ["host", "xla", "pallas"] * 2
        _site(a, a)                            # 7th call locks
        assert prof.locked is not None
        assert prof.locked_venue in callsite.VENUES
        assert "probes" in prof.locked_why
        assert s.trace.calls[-1].venue == prof.locked_venue
        assert s.trace.event_count("venue") == 1
        best = min((prof.host_best, "host"), (prof.device_best, "xla"),
                   (prof.kernel_best, "pallas"))[1]
        assert prof.locked_venue == best
        # a kernel_path change drops the lock and the pallas samples
        s.reconfigure(kernel_path=False)
        assert prof.locked is None and prof.kernel_timed == 0
        assert prof.host_timed == 2


def test_lock_prefers_pallas_on_best_sample():
    """Unit rule, with injected samples: the kernel venue wins the lock
    iff its best probe beats both classic venues."""
    p = callsite.CallSiteProfile("x")
    p.observe_probe(False, 2e-3)
    p.observe_probe(True, 1e-3, venue="xla")
    p.observe_probe(True, 5e-4, venue="pallas")
    p.observe_probe(True, 9e-4, venue="pallas")
    assert p.lock() is True
    assert p.locked_venue == "pallas"
    assert p.decision_label() == "pallas*"
    q = callsite.CallSiteProfile("y")
    q.observe_probe(False, 1e-4)
    q.observe_probe(True, 1e-3, venue="xla")
    q.observe_probe(True, 5e-4, venue="pallas")
    assert q.lock() is False
    assert q.locked_venue == "host"
    r = callsite.CallSiteProfile("z")          # 2-venue mode: no kernel
    r.observe_probe(False, 2e-3)
    r.observe_probe(True, 1e-3, venue="xla")
    assert r.lock() is True
    assert r.locked_venue == "xla"
    assert r.decision_label() == "offload*"


def test_two_venue_schedule_unchanged_without_kernel_path():
    """probe_venue(2) is the classic host/offload alternation; end to end
    without kernel_path the probes carry no venue tag."""
    p = callsite.CallSiteProfile("x")
    seen = []
    for _ in range(4):
        v = p.probe_venue(2)
        seen.append(v)
        assert (v != "host") == p.probe_path()
        p.observe_probe(v != "host", 1e-3)
    assert seen == ["host", "xla", "host", "xla"]
    cfg = _kcfg(OffloadConfig, kernel_path=False, adaptive=True,
                adaptive_warmup=4, threshold=100.0)
    with repro_torch.session(cfg, device="cpu", intercept=False) as s:
        a = host_array(RNG.standard_normal((64, 64)).astype(np.float32))
        for _ in range(5):
            _site(a, a)
        (prof,) = list(s.runtime.callsites)
        assert (prof.host_timed, prof.device_timed,
                prof.kernel_timed) == (2, 2, 0)
        assert [c.venue for c in s.trace.calls] == [""] * 5
        assert prof.locked is not None and prof.locked_venue != "pallas"


def test_split_probes_race_as_a_venue():
    """With a scheme and the kernel path, an fp64 gemm site (no venue
    kernel of its own) races host/xla/split; the split probes run their
    passes on the `pallas` venue and are tagged with the scheme."""
    cfg = _kcfg(OffloadConfig, adaptive=True, adaptive_warmup=6,
                threshold=100.0, precision="split2")
    with repro_torch.session(cfg, device="cpu", intercept=False) as s:
        a = torch.as_tensor(RNG.standard_normal((64, 64)) / 64)
        for _ in range(7):
            _site(a, a)
        (prof,) = list(s.runtime.callsites)
        assert (prof.host_timed, prof.device_timed, prof.kernel_timed,
                prof.split_timed) == (2, 2, 0, 2)
        calls = s.trace.calls
        assert [c.precision for c in calls[:6]] == ["", "", "split2"] * 2
        assert [c.venue for c in calls[:6]] == ["host", "xla", "pallas"] * 2
        assert prof.split_scheme == "split2"
        assert prof.split_venue == "pallas"
        assert prof.locked is not None
        if prof.locked_precision:
            assert prof.decision_label().endswith("~split2")
            assert calls[-1].precision == "split2"

"""The port's split-precision fp64 emulation against the reference.

``slices``, ``error_bound`` and ``choose`` equal the reference's; split
matmul/syrk/trsm stay within ``error_bound`` of numpy fp64, with the plain
fp32 pass and with the gemm kernel's pass (its plain version on the CPU);
on operands built so that every pass is exact, split3 reads at float64
rounding level and a split3 with any pass dropped reads far over that
limit; the hypothesis bound property; escalation on catastrophic cancellation
and on an ill-conditioned triangle; split tags and counters equal to the
reference's on one deterministic workload; the split pseudo-venue in the
adaptive probe/lock.  The reference's sampled-residual check fails on
host-memory inputs on this JAX release (``dot_general`` sees mixed memory
spaces), so parity runs feed both packages device-born arrays, and the
checks the reference's own tests assert are held to their oracle values.
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
from repro.core import precision as jprec  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, callsite, host_array  # noqa: E402
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.runtime import RoutineStats  # noqa: E402
from repro_torch.kernels import ops, split_gemm  # noqa: E402

RNG = np.random.default_rng(11)

#: counters both packages keep; wall times are not compared
COUNTERS = [f.name for f in dataclasses.fields(RoutineStats)
            if not f.name.endswith("seconds")]


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _f64(shape, scale=1.0):
    return RNG.standard_normal(shape) * scale


def _tri64(n):
    a = np.tril(RNG.standard_normal((n, n)) / n)
    np.fill_diagonal(a, 2.0)
    return a


def _pcfg(cls=OffloadConfig, **kw):
    kw.setdefault("policy", "dfu")
    kw.setdefault("threshold", 1.0)
    kw.setdefault("precision", "split2")
    kw.setdefault("sync", True)
    return cls(**kw)


def _cancel_pair(n=48, k=24):
    """A @ B == 0 exactly: the |A|@|B| scale is honest but the forward
    error is unbounded — catastrophic cancellation."""
    u = RNG.standard_normal((n, k))
    w = RNG.standard_normal((k, n))
    return np.concatenate([u, u], axis=1), np.concatenate([w, -w], axis=0)


def _scaled_err(out, a, b):
    """max |out - A B| relative to the |A| |B| inner-product scale."""
    denom = np.abs(a) @ np.abs(b) + 1e-300
    return np.max(np.abs(out - a @ b) / denom)


# --------------------------------------------------------------------- #
# the decomposition and its bounds equal the reference's                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scheme", prec.SCHEMES)
def test_slices_equal_reference(scheme):
    x = _f64((37, 53), 10.0) * np.exp(RNG.uniform(-20, 20, (37, 53)))
    want = jprec.slices(jnp.asarray(x), scheme)
    got = prec.slices(torch.as_tensor(x).mT, scheme)  # any layout in
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).T)
    assert sum(s.double() for s in got).sub(torch.as_tensor(x).mT).abs() \
        .max() <= np.abs(x).max() * 2.0 ** -46      # fp32 hi + lo: 48 bits


def test_bounds_and_choice_equal_reference():
    for scheme in prec.SCHEMES:
        for k in (0, 1, 64, 255, 256, 4096, 93536):
            for base in ("gemm", "syrk", "trsm"):
                assert prec.error_bound(scheme, k, base) == \
                    jprec.error_bound(scheme, k, base)
    for scheme in ("split2", "split3", "auto", "native", ""):
        for k in (64, 512, 4096, 93536):
            for rtol in (1e-3, 1e-4, 2e-5, 1e-9):
                for base in ("gemm", "trsm"):
                    assert prec.choose(scheme, base, k, rtol) == \
                        jprec.choose(scheme, base, k, rtol)
    # the PARSEC projection under auto at the default rtol: split2's
    # (K+12)*2^-24 ~ 5.6e-3 misses 1e-4, split3's 280*2^-24 ~ 1.67e-5 fits
    assert prec.choose("auto", "gemm", 93536, 1e-4) == "split3"
    assert prec.error_bound("split3", 93536) == 280 * 2.0 ** -24
    assert prec.supported("gemm", torch.float64)
    assert not prec.supported("gemm", torch.float32)
    assert not prec.supported("gemm", torch.complex128)
    assert not prec.supported("trmm", torch.float64)
    assert prec._PASSES == jprec._PASSES
    assert prec.SPLIT3_CHUNK == jprec.SPLIT3_CHUNK


# --------------------------------------------------------------------- #
# numerics against numpy fp64                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scheme", prec.SCHEMES)
@pytest.mark.parametrize("venue", ["xla", "pallas"])
def test_split_bound_holds_across_shapes_and_scales(scheme, venue):
    """Measured error relative to |A|@|B| never exceeds error_bound, with
    the plain fp32 pass (`xla`) and the gemm kernel's pass (`pallas`)."""
    for (m, k, n) in ((17, 33, 9), (64, 64, 64), (32, 600, 16)):
        for scale in (1e-6, 1.0, 1e6):
            a, b = _f64((m, k), scale), _f64((k, n), scale)
            ta, tb = torch.as_tensor(a), torch.as_tensor(b)
            out = (split_gemm.matmul(ta, tb, scheme) if venue == "pallas"
                   else prec.matmul(ta, tb, scheme))
            assert _scaled_err(out.numpy(), a, b) <= \
                prec.error_bound(scheme, k), (m, k, n, scale)


def test_split_bound_property_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hypothesis.settings(max_examples=20, deadline=None)
    @hypothesis.given(seed=st.integers(0, 2**31 - 1),
                      m=st.integers(1, 48), k=st.integers(1, 300),
                      n=st.integers(1, 48),
                      logscale=st.integers(-6, 6),
                      scheme=st.sampled_from(prec.SCHEMES))
    def check(seed, m, k, n, logscale, scheme):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((m, k)) * 10.0 ** logscale
        b = rng.standard_normal((k, n)) * 10.0 ** logscale
        out = prec.matmul(torch.as_tensor(a), torch.as_tensor(b), scheme)
        assert _scaled_err(out.numpy(), a, b) <= prec.error_bound(scheme, k)

    check()


@pytest.mark.parametrize("scheme", prec.SCHEMES)
def test_split_syrk_and_trsm_within_bound(scheme):
    a = _f64((40, 300))
    for trans in (False, True):
        x = a.T if trans else a
        want_l, want_r = (x.T, x) if trans else (x, x.T)
        for fn in (prec.syrk, split_gemm.syrk):
            out = fn(torch.as_tensor(x), scheme, trans=trans).numpy()
            assert _scaled_err(out, want_l, want_r) <= \
                prec.error_bound(scheme, 300)
    t, b = _tri64(96), _f64((96, 32))
    ref = np.linalg.solve(t, b)
    for left in (True, False):
        for trans_a in (False, True):
            rhs = b if left else b.T
            tm = t.T if trans_a else t
            want = ref if left and not trans_a else (
                np.linalg.solve(tm, rhs) if left
                else np.linalg.solve(tm.T, rhs.T).T)
            for fn in (prec.trsm, split_gemm.trsm):
                got = fn(torch.as_tensor(t), torch.as_tensor(rhs), scheme,
                         left_side=left, lower=True,
                         trans_a=trans_a).numpy()
                assert np.max(np.abs(got - want)) <= \
                    prec.error_bound(scheme, 96, "trsm") * \
                    np.max(np.abs(want))


#: limit on the column-relative error of split3 on exact-pass operands.
#: Both venues and the reference read ~1.2e-15 here (a few float64
#: roundings of the pass sum); every dropped pass reads 1.5e-8 or more.
EXACT_PASS_TOL = 1e-12


def _exact_pass_pair(m, k, n, seed=5):
    """fp64 A, B whose split3 slices and slice products are exact, with
    the slices and the exact product.  Each element is s (h + l + t),
    h in {1, 1.5}, l in {1, 1.5} 2^-25, t in {1, 1.5} 2^-51: slices()
    returns s h, s l and the bf16 tail s t exactly, and every float32
    slice product over a 256-column chunk is exact.  A's second half of
    columns repeats the first half's hi part, and B's second half of rows
    negates it in the first half of B's columns: there hi*hi cancels to 0
    and the lo and tail passes carry the result, so every pass shows."""
    rng = np.random.default_rng(seed)

    def parts(shape):
        def pick(scale):
            return (1.0 + 0.5 * rng.integers(0, 2, shape)) * scale
        return (rng.choice([-1.0, 1.0], shape), pick(1.0), pick(2.0 ** -25),
                pick(2.0 ** -51))

    sa, ha, la, ta = parts((m, k))
    sb, hb, lb, tb = parts((k, n))
    h, c = k // 2, n // 2
    sa[:, h:2 * h], ha[:, h:2 * h] = sa[:, :h], ha[:, :h]
    sb[h:2 * h, :c], hb[h:2 * h, :c] = -sb[:h, :c], hb[:h, :c]
    pa = [sa * x for x in (ha, la, ta)]
    pb = [sb * x for x in (hb, lb, tb)]
    exact = np.zeros((m, n))
    for i, j in sorted(np.ndindex(3, 3), key=lambda p: -sum(p)):
        exact = exact + pa[i] @ pb[j]          # each product exact in fp64
    return sum(pa), sum(pb), pa, exact


def _colrel(got, want):
    """max over columns of max|got - want| / max|want|."""
    return np.max(np.max(np.abs(got - want), axis=0)
                  / np.max(np.abs(want), axis=0))


@pytest.mark.parametrize("k", [256, 600])
def test_split3_exact_pass_operands_read_at_rounding_level(k):
    """split3 on operands whose passes are exact: the plain pass, the gemm
    kernel's pass and the reference all read at float64 rounding level
    against the exact product (native fp64 does not: it rounds the hi*hi
    partial sums that cancel)."""
    a, b, pa, exact = _exact_pass_pair(24, k, 18)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for got, want in zip(prec.slices(ta, "split3"), pa):
        np.testing.assert_array_equal(got.double().numpy(), want)
    plain = prec.matmul(ta, tb, "split3").numpy()
    kern = split_gemm.matmul(ta, tb, "split3").numpy()
    jref = np.asarray(jprec.matmul(jnp.asarray(a), jnp.asarray(b), "split3"))
    for got in (plain, kern, jref):
        assert _colrel(got, exact) <= EXACT_PASS_TOL
    np.testing.assert_array_equal(kern, plain)
    assert _colrel(a @ b, exact) > 1e3 * EXACT_PASS_TOL


@pytest.mark.parametrize("dropped", jprec._PASSES["split3"])
def test_split3_dropped_pass_reads_over_limit(dropped, monkeypatch):
    """The exact-pass limit catches a split3 with any one pass left out."""
    a, b, _, exact = _exact_pass_pair(24, 600, 18)
    monkeypatch.setitem(prec._PASSES, "split3", tuple(
        p for p in prec._PASSES["split3"] if p != dropped))
    got = split_gemm.matmul(torch.as_tensor(a), torch.as_tensor(b), "split3")
    assert _colrel(got.numpy(), exact) > 1e3 * EXACT_PASS_TOL


def test_plain_pass_refuses_reduced_float32_products():
    a = torch.ones((4, 4))
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="true float32"):
            prec.matmul(a.double(), a.double(), "split2")
    finally:
        torch.set_float32_matmul_precision(old)


def test_fp64_gemm_kernel_capability_requires_split():
    assert not ops.kernel_available("gemm", torch.float64)
    assert ops.kernel_available("gemm", torch.float64, precision="split2")
    assert ops.kernel_available("gemm", torch.float64, precision="split3")
    assert ops.kernel_available("gemm", torch.float32)
    a, b = _f64((48, 64)), _f64((64, 32))
    # the split product on the venue runs the fused split kernel's entry
    assert blas._split_product("pallas") is split_gemm.matmul
    out = blas._split_matmul("split2", "pallas")(
        torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert _scaled_err(out, a, b) <= prec.error_bound("split2", 64)
    # without a scheme an fp64 product is the native one
    np.testing.assert_allclose(
        ops.kernel_matmul(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        a @ b, rtol=1e-12)


# --------------------------------------------------------------------- #
# the runtime: tags and counters equal the reference's                   #
# --------------------------------------------------------------------- #
def _split_workload(bl, arr, x):
    """Device-born inputs (see the module docstring)."""
    a, b, t, f = arr(x["a"]), arr(x["b"]), arr(x["t"]), arr(x["f"])
    outs = [bl.gemm(a, b) for _ in range(3)]
    outs += [bl.syrk(a), bl.trsm(t, b), bl.gemm(a, b, trans_a="T"),
             bl.gemm(arr(x["u"]), arr(x["w"])),             # escalates
             bl.gemm(f, f)]                                 # float32
    return outs


@pytest.mark.parametrize("kernel_path", [False, True])
def test_split_tags_counters_match_reference(kernel_path):
    u, w = _cancel_pair()
    x = dict(a=_f64((96, 96)) / 96, b=_f64((96, 96)), t=_tri64(96), u=u,
             w=w, f=_f64((64, 64)).astype(np.float32))
    jc = _pcfg(JConfig, kernel_path=kernel_path)
    with repro.session(jc, intercept=False) as s:
        jouts = [np.asarray(o) for o in
                 _split_workload(jcore.blas, jnp.asarray, x)]
        s.sync()
        jstats = {k: dataclasses.asdict(v)
                  for k, v in s.stats.per_routine.items()}
        jcalls = [(c.precision, c.venue) for c in s.trace.calls]
        jesc = s.trace.event_count("escalate")
    with repro_torch.session(_pcfg(kernel_path=kernel_path), device="cpu",
                             intercept=False) as s:
        touts = [o.numpy() for o in
                 _split_workload(blas, torch.as_tensor, x)]
        tstats = {k: dataclasses.asdict(v)
                  for k, v in s.stats.per_routine.items()}
        tcalls = [(c.precision, c.venue) for c in s.trace.calls]
        tesc = s.trace.event_count("escalate")
        report = s.report()
    venue = "pallas" if kernel_path else ""
    assert tcalls == jcalls
    assert tcalls == [("split2", venue)] * 7 + [("", venue)]
    assert tesc == jesc == 1
    assert tstats.keys() == jstats.keys()
    for name in tstats:
        for field in COUNTERS:
            assert tstats[name][field] == jstats[name][field], (name, field)
    assert tstats["dgemm"]["escalations"] == 1
    assert "split precision: 7 calls" in report
    rtol = _pcfg().precision_rtol
    for got, want in zip(touts[:6], jouts[:6]):
        assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))
    assert np.max(np.abs(touts[6])) < 1e-9     # the native rerun


def test_escalation_on_catastrophic_cancellation():
    """Held to the reference test's oracle values: the call escalates,
    the attempt still counts as split, the site never locks split, and
    the native fp64 rerun cancels to rounding level."""
    a, b = _cancel_pair()
    with repro_torch.session(_pcfg(), device="cpu", intercept=False) as s:
        out = blas.gemm(host_array(a), host_array(b)).numpy()
        st = s.stats.per_routine["dgemm"]
        assert st.escalations == 1 and st.split_calls == 1
        assert s.trace.event_count("escalate") == 1
        assert s.trace.calls[-1].precision == "split2"
        (site,) = list(s.runtime.callsites)
        assert site.split_bad
    assert np.max(np.abs(out)) < 1e-9


def test_trsm_split_well_conditioned_accepts():
    t, b = _tri64(96), _f64((96, 32))
    with repro_torch.session(_pcfg(), device="cpu", intercept=False) as s:
        x = blas.trsm(host_array(t), host_array(b)).numpy()
        assert s.stats.per_routine["dtrsm"].escalations == 0
        assert s.trace.calls[-1].precision == "split2"
    ref = np.linalg.solve(np.tril(t), b)
    assert np.max(np.abs(x - ref)) <= 1e-4 * np.max(np.abs(ref))


def test_trsm_split_ill_conditioned_escalates():
    """A 1e16 diagonal range defeats the fp32 solve + refinement; the
    residual check catches it and the native solve's answer returns."""
    n = 64
    t = np.tril(RNG.standard_normal((n, n)))
    np.fill_diagonal(t, 10.0 ** np.linspace(-16, 0, n))
    b = _f64((n, 8))
    with repro_torch.session(_pcfg(), device="cpu", intercept=False) as s:
        x = blas.trsm(host_array(t), host_array(b))
        assert s.stats.per_routine["dtrsm"].escalations == 1
        assert s.trace.event_count("escalate") == 1
    native = ops.trsm(torch.as_tensor(t), torch.as_tensor(b))
    np.testing.assert_array_equal(x.numpy(), native.numpy())


def test_precision_off_golden_counters_and_dump(tmp_path):
    """precision off: no split counters, no report section, and a dump
    with no precision key."""
    rng = np.random.default_rng(42)
    cfg = OffloadConfig(policy="dfu", threshold=10,
                        device_bytes=2 * 128 * 128 * 4)
    with repro_torch.session(cfg, device="cpu", intercept=False) as s:
        xs = [host_array(rng.standard_normal((128, 128)))
              for _ in range(5)]
        outs = [blas.gemm(x, x) for _ in range(3) for x in xs]
        st = s.stats.per_routine["dgemm"]
        assert (st.offloaded, st.split_calls, st.escalations) == (15, 0, 0)
        assert "split precision" not in s.report()
        s.trace.dump(str(tmp_path / "t.json"))
    assert len(outs) == 15
    for call in json.loads((tmp_path / "t.json").read_text())["calls"]:
        assert "precision" not in call and "venue" not in call


# --------------------------------------------------------------------- #
# the split pseudo-venue in the adaptive probe/lock                      #
# --------------------------------------------------------------------- #
def test_split_probe_schedule_rotation():
    p = callsite.CallSiteProfile("x")
    seen = []
    for _ in range(6):
        v = p.probe_venue(2, split=True)
        seen.append(v)
        if v == "split":
            p.observe_probe(True, 1e-3, venue="xla", precision="split2")
        else:
            p.observe_probe(v != "host", 1e-3)
    assert seen == ["host", "xla", "split"] * 2
    assert p.split_timed == 2 and p.split_scheme == "split2"


def test_lock_prefers_split_on_best_sample():
    p = callsite.CallSiteProfile("x")
    p.observe_probe(False, 2e-3)
    p.observe_probe(True, 1e-3, venue="xla")
    p.observe_probe(True, 5e-4, venue="xla", precision="split2")
    assert p.lock() is True
    assert p.locked_precision == "split2"
    assert p.decision_label() == "offload*~split2"
    q = callsite.CallSiteProfile("y")        # an escalated probe blocks
    q.observe_probe(False, 2e-3)
    q.observe_probe(True, 1e-3, venue="xla")
    q.observe_probe(True, 5e-4, venue="xla", precision="split2")
    q.split_bad = True
    assert q.lock() is True
    assert q.locked_venue == "xla" and q.locked_precision == ""
    r = callsite.CallSiteProfile("z")        # slower split never locks
    r.observe_probe(False, 2e-3)
    r.observe_probe(True, 1e-3, venue="xla")
    r.observe_probe(True, 3e-3, venue="xla", precision="split2")
    assert r.lock() is True
    assert r.locked_precision == ""


def _adaptive_site(x, y):
    return blas.gemm(x, y)


def test_adaptive_probes_split_as_a_venue():
    """Held to the reference test's oracle: host/xla/split rotation with
    equal samples, split probes tagged, the 7th call locks."""
    cfg = _pcfg(adaptive=True, adaptive_warmup=6, threshold=100.0)
    with repro_torch.session(cfg, device="cpu", intercept=False) as s:
        a = host_array(_f64((64, 64)) / 64)
        for _ in range(6):
            _adaptive_site(a, a)
        (prof,) = list(s.runtime.callsites)
        assert (prof.host_timed, prof.device_timed,
                prof.split_timed) == (2, 2, 2)
        assert prof.locked is None
        assert [c.precision for c in s.trace.calls] == ["", "", "split2"] * 2
        _adaptive_site(a, a)
        assert prof.locked is not None
        if prof.locked_precision:
            assert prof.decision_label().endswith("~split2")


def test_reconfigure_precision_resets_split_probes():
    cfg = _pcfg(adaptive=True, adaptive_warmup=4, threshold=100.0)
    with repro_torch.session(cfg, device="cpu", intercept=False) as s:
        a = host_array(_f64((64, 64)) / 64)
        for _ in range(5):
            _adaptive_site(a, a)
        (prof,) = list(s.runtime.callsites)
        assert prof.split_timed > 0 and prof.locked is not None
        s.reconfigure(precision="split3")
        assert prof.locked is None
        assert prof.locked_precision == ""
        assert prof.split_timed == 0
        assert prof.split_scheme == ""
        assert prof.host_timed > 0             # other venues' samples stay

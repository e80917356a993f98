"""The port's LAPACK solver tier against the reference's: the intercepted
torch.linalg surface under live reference sessions, solver spans and
pinning, default-off behaviour, and LSMS through the tier.  The blocked
drivers alone are in tests/test_torch_solvers_drivers.py."""
import json

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.scipy.linalg as jsl  # noqa: E402

import repro  # noqa: E402
from repro.apps import lsms as jlsms  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.apps import dft, lsms  # noqa: E402
from repro_torch.core import (blas, host_array, lapack,  # noqa: E402
                              memspace)
from repro_torch.core import runtime as rtm  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.solvers import drivers  # noqa: E402
from repro_torch.solvers import intercept as slv  # noqa: E402

def _rng(seed):
    return np.random.default_rng(seed)


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return np.asarray(x, dtype=dtype)


def _diag_dominant(rng, n, dtype):
    return np.asarray(_rand(rng, (n, n), dtype) / n + np.eye(n), dtype=dtype)


def _hpd(rng, n, dtype):
    g = _rand(rng, (n, n), dtype) / n
    return np.asarray(g @ g.conj().T + np.eye(n), dtype=dtype)


def _hermitian(rng, n, dtype):
    g = _rand(rng, (n, n), dtype)
    return np.asarray((g + g.conj().T) / 2, dtype=dtype)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# --------------------------------------------------------------------- #
# the intercepted surface against a live reference session               #
# --------------------------------------------------------------------- #
#: the eigensolves' order and the float64 ones' block size: the
#: reference's syev runs eagerly and compiles every column's shapes
#: (~0.5 s a column on the CPU), so the workloads keep it small, at or
#: above the threshold of 32
EIG_N, EIG_NB = 36, 24


def _surface_inputs(name):
    """The reference tests' workloads (tests/test_solvers.py:170-275),
    each as the numpy inputs and ``lapack_nb``; the eigensolves at
    ``EIG_N``."""
    rng = _rng(6)
    if name == "gesv":
        return 48, dict(a=_diag_dominant(rng, 150, "complex128"),
                        b=_rand(rng, (150, 6), "complex128"))
    if name == "scipy":
        n = 72
        return EIG_NB, dict(spd=_hpd(rng, n, "float64"),
                            b=_rand(rng, (n, 4), "float64"),
                            herm=_hermitian(rng, EIG_N, "float64"),
                            tri=np.tril(_rand(rng, (n, n), "float64"))
                            + n * np.eye(n))
    if name == "lu":
        return 32, dict(a=_diag_dominant(rng, 64, "float64"),
                        b=_rand(rng, (64, 3), "float64"),
                        herm=_hermitian(rng, EIG_N, "complex128"))
    # the span workload of test_solvers.py:234-244 at nb 24, so that its
    # eigvalsh reuses the reference's compilations of "scipy"'s
    return EIG_NB, dict(a=_diag_dominant(rng, 120, "float64"),
                        b=_rand(rng, (120, 5), "float64"),
                        spd=_hpd(rng, 96, "float64"),
                        herm=_hermitian(rng, EIG_N, "float64"))


def _jax_surface(name, x):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    if name == "gesv":
        return [jnp.linalg.solve(j["a"], j["b"])]
    if name == "scipy":
        c = jsl.cho_factor(j["spd"], lower=True)
        return [jsl.cho_solve(c, j["b"]),
                jsl.solve_triangular(j["tri"], j["b"], lower=True),
                jsl.eigh(j["herm"], eigvals_only=True)]
    if name == "lu":
        lu_piv = jsl.lu_factor(j["a"])
        w, v = jsl.eigh(j["herm"])
        return [jsl.lu_solve(lu_piv, j["b"]), w, v]
    return [jnp.linalg.solve(j["a"], j["b"]), jnp.linalg.cholesky(j["spd"]),
            jsl.eigh(j["herm"], eigvals_only=True)]


def _torch_surface(name, x):
    t = {k: _t(v) for k, v in x.items()}
    if name == "gesv":
        return [torch.linalg.solve(t["a"], t["b"])]
    if name == "scipy":
        c = torch.linalg.cholesky(t["spd"])
        return [torch.cholesky_solve(t["b"], c),
                torch.linalg.solve_triangular(t["tri"], t["b"], upper=False),
                torch.linalg.eigvalsh(t["herm"])]
    if name == "lu":
        lu, piv = torch.linalg.lu_factor(t["a"])
        w, v = torch.linalg.eigh(t["herm"])
        return [torch.linalg.lu_solve(lu, piv, t["b"]), w, v]
    return [torch.linalg.solve(t["a"], t["b"]),
            torch.linalg.cholesky(t["spd"]),
            torch.linalg.eigvalsh(t["herm"])]


def _summary(s):
    st, trace = s.runtime.stats, s.runtime.trace
    return dict(
        seq=[(c.routine, c.m, c.n, c.k, c.solver_id) for c in trace],
        routines={k: (v.calls, v.offloaded, v.on_host)
                  for k, v in st.per_routine.items()},
        solvers={k: (v.spans, v.calls, v.panel_calls)
                 for k, v in st.solvers.items()},
        events=(trace.event_count("solver_begin"),
                trace.event_count("solver_end")))


SURFACES = ("gesv", "scipy", "lu", "spans")


@pytest.fixture(scope="module")
def surfaces(x64):
    """Each workload once in a reference session (device-born inputs:
    the reference's panel needs them on JAX 0.9) and once in a port
    session on the CPU, with lapack=True and threshold 32."""
    out = {}
    for name in SURFACES:
        nb, x = _surface_inputs(name)
        with repro.session(JConfig(lapack=True, threshold=32.0,
                                   lapack_nb=nb)) as s:
            jres = [np.asarray(r) for r in _jax_surface(name, x)]
            jsum = _summary(s)
        with repro_torch.session(OffloadConfig(lapack=True, threshold=32.0,
                                               lapack_nb=nb),
                                 device="cpu") as s:
            tres = [r.numpy() for r in _torch_surface(name, x)]
            tsum = _summary(s)
            report = s.report()
        out[name] = (x, jres, jsum, tres, tsum, report)
    return out


@pytest.mark.parametrize("name", SURFACES)
def test_intercepted_surface_matches_reference(surfaces, name):
    """The trace's (routine, m, n, k, solver_id) sequence, the
    per-routine (calls, offloaded, on_host), the per-solver (spans,
    calls, panel_calls) and the solver_begin/solver_end counts equal the
    reference session's.  ``uninstrumented_calls`` is not compared: the
    reference's counts its own pipeline's jit traces (its jnp.matmul
    under jit, and potrf's diagonal block reaching the patched
    jnp.linalg.cholesky as a tracer), which have no counterpart here."""
    _, _, jsum, _, tsum, report = surfaces[name]
    assert tsum["seq"] == jsum["seq"]
    assert tsum["routines"] == jsum["routines"]
    assert tsum["solvers"] == jsum["solvers"]
    assert tsum["events"] == jsum["events"]
    assert tsum["events"][0] == tsum["events"][1] > 0
    assert "solvers (LAPACK tier)" in report


def test_intercepted_gesv_counts_the_reference_stream(surfaces):
    """The reference session's stream for a 150 x 150 complex128 solve
    at nb 48 (four panels, 12 calls), pinned literally."""
    _, _, _, _, tsum, _ = surfaces["gesv"]
    assert tsum["solvers"] == {"gesv": (1, 12, 4)}
    assert tsum["routines"] == {"zgetf2": (4, 0, 4), "ztrsm": (5, 4, 1),
                                "zgemm": (3, 2, 1)}
    assert tsum["seq"][:3] == [("zgetf2", 150, 48, 0, "gesv#0"),
                               ("ztrsm", 48, 102, 0, "gesv#0"),
                               ("zgemm", 102, 102, 48, "gesv#0")]


@pytest.mark.parametrize("name", SURFACES)
def test_intercepted_surface_matches_oracles(surfaces, name):
    """Each result against the reference session's and scipy's."""
    x, jres, _, tres, _, _ = surfaces[name]
    for got, want in zip(tres, jres):
        if name == "lu" and got.shape == (EIG_N, EIG_N):
            # eigenvectors: compare up to each column's phase
            got = got * (want.conj() * got).sum(0).conj() / np.abs(
                (want.conj() * got).sum(0))
        np.testing.assert_allclose(got, want, atol=1e-8)
    if name == "scipy":
        np.testing.assert_allclose(tres[0], np.linalg.solve(x["spd"],
                                                            x["b"]),
                                   atol=1e-9)
        np.testing.assert_allclose(tres[1], sla.solve_triangular(
            x["tri"], x["b"], lower=True), atol=1e-9)
        np.testing.assert_allclose(tres[2],
                                   sla.eigh(x["herm"], eigvals_only=True),
                                   atol=1e-8)
    elif name == "gesv":
        np.testing.assert_allclose(tres[0], np.linalg.solve(x["a"], x["b"]),
                                   atol=1e-9)


def test_lu_factor_returns_the_absolute_permutation():
    """The patched lu_factor gives 0-based absolute pivots with
    A[piv] == L @ U, not LAPACK's 1-based ipiv; the pair round-trips."""
    a = _diag_dominant(_rng(7), 64, "float64")
    with repro_torch.session(OffloadConfig(lapack=True, threshold=32.0,
                                           lapack_nb=16), device="cpu"):
        out = torch.linalg.lu_factor(_t(a))
        lu, piv = out
        assert out.LU is lu and out.pivots is piv
        x = torch.linalg.lu_solve(lu, piv, _t(np.eye(64)))
    assert sorted(piv.tolist()) == list(range(64))
    low = np.tril(lu.numpy(), -1) + np.eye(64)
    np.testing.assert_allclose(a[piv.numpy()], low @ np.triu(lu.numpy()),
                               atol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.linalg.inv(a), atol=1e-10)


# --------------------------------------------------------------------- #
# behaviour: gating, patching, spans, pins                               #
# --------------------------------------------------------------------- #
def test_subthreshold_solve_falls_through_native():
    rng = _rng(8)
    a, b = _diag_dominant(rng, 48, "float64"), _rand(rng, (48, 3), "float64")
    with repro_torch.session(OffloadConfig(lapack=True, threshold=1000.0),
                             device="cpu") as s:
        x = torch.linalg.solve(host_array(a), host_array(b))
        assert not s.stats.solvers
        assert s.trace.event_count("solver_begin") == 0
        assert s.stats.uninstrumented_calls == 1
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), atol=1e-12)


SYMBOLS = ((torch.linalg, "cholesky"), (torch.linalg, "solve"),
           (torch.linalg, "lu_factor"), (torch.linalg, "lu_solve"),
           (torch, "cholesky_solve"), (torch.linalg, "solve_triangular"),
           (torch.linalg, "eigh"), (torch.linalg, "eigvalsh"))


def _symbols():
    return tuple(getattr(mod, name) for mod, name in SYMBOLS)


def test_lapack_session_patches_and_restores_symbols():
    orig = _symbols()
    cfg = OffloadConfig(lapack=True, threshold=64.0)
    with repro_torch.session(cfg, device="cpu"):
        patched = _symbols()
        assert all(p is not o for p, o in zip(patched, orig))
        with repro_torch.session(cfg, device="cpu"):
            assert _symbols() == patched        # refcounted: one patch
        assert _symbols() == patched
        assert slv.native("eigh") is orig[6]
    assert _symbols() == orig
    assert slv.native("cholesky") is orig[0]


def test_lapack_unset_touches_no_symbols():
    orig = _symbols()
    with repro_torch.session(OffloadConfig(threshold=64.0), device="cpu"):
        assert _symbols() == orig
    with repro_torch.session(OffloadConfig(lapack=True), device="cpu",
                             intercept=False):
        assert _symbols() == orig


def test_reconfigure_flips_solver_patch():
    orig = torch.linalg.lu_factor
    with repro_torch.session(OffloadConfig(threshold=64.0),
                             device="cpu") as s:
        assert torch.linalg.lu_factor is orig
        s.reconfigure(lapack=True, lapack_nb=16)
        assert torch.linalg.lu_factor is not orig
        assert s.runtime.config.lapack_nb == 16
        s.reconfigure(lapack=False)
        assert torch.linalg.lu_factor is orig
    assert torch.linalg.lu_factor is orig


def test_resolve_nb_prefers_explicit_then_session():
    assert drivers._resolve_nb(0) == lapack.DEFAULT_NB == 128
    with repro_torch.session(OffloadConfig(lapack_nb=40), device="cpu"):
        assert drivers._resolve_nb(0) == 40
        assert drivers._resolve_nb(8) == 8


def test_span_pins_factor_under_cap_pressure():
    n, el = 96, 8
    rt = rtm.install("dfu", threshold=10, device_bytes=3 * n * n * el,
                     record_trace=False, device="cpu")
    try:
        rng = _rng(9)
        factor = host_array(_diag_dominant(rng, n, "float64"))
        span = rt.solver_begin("getrf", factor)
        assert span.pinned
        key = memspace.buffer_key(factor)
        ent = rt.placements.entry(key)
        assert ent is not None and ent.pinned
        assert memspace.tier_of(span.placed) == memspace.DEVICE
        others = [host_array(_rand(rng, (n, n), "float64"))
                  for _ in range(6)]
        for x in others:
            blas.gemm(x, x)
        assert rt.stats.evictions > 0
        ent = rt.placements.entry(key)
        assert ent is not None and ent.pinned
        rt.solver_end(span)
        ent = rt.placements.entry(key)
        assert ent is not None and not ent.pinned
        rt.solver_end(span)                     # idempotent
        assert rt.stats.solvers["getrf"].spans == 1
    finally:
        rtm.uninstall()


def test_host_factor_crosses_the_link_once_per_span():
    """A host_array factor is pinned once and the driver computes on the
    pinned device copy: the span's movement is the factor's bytes and
    every inner BLAS call finds its operands on the device tier."""
    rng = _rng(10)
    a = _diag_dominant(rng, 96, "float64")
    with repro_torch.session(OffloadConfig(lapack=True, threshold=32.0,
                                           lapack_nb=32),
                             device="cpu") as s:
        lu, piv = torch.linalg.lu_factor(host_array(a))
        st = s.stats
        assert sum(r.bytes_in for r in st.per_routine.values()) == 0
        assert s.trace.event_count("place") >= 1
    assert st.solvers["getrf"].moved_bytes == 0
    low = np.tril(lu.numpy(), -1) + np.eye(96)
    np.testing.assert_allclose(a[piv.numpy()], low @ np.triu(lu.numpy()),
                               atol=1e-12)


def test_cpu_policy_span_does_not_pin():
    rt = rtm.install(config=OffloadConfig(policy="cpu"), record_trace=False,
                     device="cpu")
    try:
        factor = host_array(_diag_dominant(_rng(11), 32, "float64"))
        span = rt.solver_begin("getrf", factor)
        assert not span.pinned and span.placed is factor
        assert len(rt.placements) == 0
        rt.solver_end(span)
    finally:
        rtm.uninstall()


def test_note_panel_is_noop_outside_spans():
    rt = rtm.install("dfu", threshold=10, record_trace=True, device="cpu")
    try:
        rt.note_panel("d", 32, 8, torch.ones(32, 8, dtype=torch.float64))
        assert len(rt.trace) == 0
        assert "dgetf2" not in rt.stats.per_routine
        assert not rt.stats.solvers
    finally:
        rtm.uninstall()


def test_lapack_off_golden_counters():
    """With lapack off, the capped eviction workload keeps the golden
    counters of tests/test_solvers.py:321-344 and the report has no
    solver section."""
    rng = np.random.default_rng(42)
    rt = rtm.install("dfu", threshold=10, device_bytes=2 * 128 * 128 * 4,
                     record_trace=False, device="cpu")
    try:
        xs = [host_array(rng.standard_normal((128, 128)), torch.float32)
              for _ in range(5)]
        # the outputs stay alive, as the reference's async window holds
        # its last 32 (a dead output's placement would free its bytes)
        outs = [blas.gemm(x, x) for _ in range(3) for x in xs]
        assert len(outs) == 15
        rt.sync()
        assert rt.stats.evictions == 28
        assert rt.stats.evicted_bytes == 1835008
        st = rt.stats.per_routine["sgemm"]
        assert (st.offloaded, st.on_host) == (15, 0)
        assert (st.cache_hits, st.cache_misses) == (15, 15)
        assert not rt.stats.solvers
        assert "solvers (LAPACK tier)" not in rt.stats.report()
    finally:
        rtm.uninstall()


def test_lapack_off_trace_dump_has_no_solver_keys(tmp_path):
    path = tmp_path / "t.json"
    with repro_torch.session(OffloadConfig(threshold=1.0, sync=True),
                             device="cpu") as s:
        a = host_array(_rand(_rng(12), (64, 64), "float32"))
        blas.gemm(a, a)
        torch.linalg.solve(a, a)            # not patched: no span
        s.trace.dump(str(path))
    raw = json.loads(path.read_text())
    assert all("solver_id" not in c for c in raw["calls"])
    assert not any(e["kind"].startswith("solver")
                   for e in raw.get("events", ()))


def test_complex_trsm_and_large_block_potrf_finish_in_a_lapack_session():
    """The port's own library calls of patched symbols go to the
    originals: complex trsm's solve_triangular (kernels/ref.py) while
    the runtime dispatches, and potrf's diagonal block (the native
    cholesky) with a block at or above the threshold."""
    rng = _rng(13)
    tri = np.tril(_rand(rng, (64, 64), "complex128")) + 64 * np.eye(64)
    b = _rand(rng, (64, 5), "complex128")
    spd = _hpd(rng, 96, "float64")
    with repro_torch.session(OffloadConfig(lapack=True, threshold=32.0),
                             device="cpu") as s:
        x = blas.trsm(_t(tri), _t(b))
        f = drivers.potrf(_t(spd), nb=64)
        y = torch.linalg.solve_triangular(_t(tri), _t(b), upper=False)
        assert set(s.stats.solvers) == {"potrf"}
        assert s.stats.per_routine["ztrsm"].calls == 2
        assert s.stats.uninstrumented_calls == 0
    np.testing.assert_allclose(x.numpy(), sla.solve_triangular(
        tri, b, lower=True), atol=1e-12)
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-14)
    np.testing.assert_allclose(f.numpy() @ f.numpy().T, spd, atol=1e-12)


def test_dft_eigh_stays_native_under_lapack():
    """apps/dft.py's Rayleigh-Ritz eigh is the native one, as the
    reference's jnp.linalg.eigh is not patched: no span opens even where
    the tier would take the matrix."""
    kw = dict(ngrid=160, nstates=48, scf=1, cheb_order=3)
    plain = dft.run_mini(device="cpu", **kw)
    with repro_torch.session(OffloadConfig(lapack=True, threshold=16.0),
                             device="cpu") as s:
        out = dft.run_mini(device="cpu", **kw)
        assert not s.stats.solvers
        assert s.trace.event_count("solver_begin") == 0
    assert out == plain


# --------------------------------------------------------------------- #
# LSMS through the tier                                                  #
# --------------------------------------------------------------------- #
def test_run_mini_through_the_tier_matches_native_and_reference():
    """run_mini's torch.linalg.lu_factor/lu_solve are the patched tier
    under lapack=True: 2 spans per solve, residual < 1e-10, and the
    energy within rtol 1e-9 of the port's native run and of the
    reference's native run_mini (four float64 LUs of M ~ I agree to
    ~1e-15; 1e-9 absorbs the libraries' summation orders)."""
    kw = dict(atoms=2, energies=2, scf=1, n=96)
    # the reference's run_mini needs a session for its host-first-touched
    # G on JAX 0.9 (tests/test_torch_lsms.py); its LU stays native there
    with repro.session(JConfig(policy="dfu", threshold=100.0)):
        want = jlsms.run_mini(nb=32, **kw)
    native = lsms.run_mini(device="cpu", **kw)
    with repro_torch.session(OffloadConfig(lapack=True, threshold=48.0,
                                           lapack_nb=32),
                             device="cpu") as s:
        out = lsms.run_mini(device="cpu", **kw)
        assert {"getrf", "getrs"} == set(s.stats.solvers)
        assert s.trace.event_count("solver_begin") == 8
        assert s.trace.event_count("solver_end") == 8
        assert s.stats.solvers["getrf"].panel_calls == 4 * 3
    assert out["n_solves"] == native["n_solves"] == want["n_solves"] == 4
    assert out["max_resid"] < 1e-10
    np.testing.assert_allclose(out["energy"], native["energy"], rtol=1e-9)
    np.testing.assert_allclose(out["energy"], want["energy"], rtol=1e-9)

"""The rest of interception (torch.mv, torch.dot, torch.bmm) and the legacy
install()/uninstall()/offload() shims, against the reference's on the
quickstart and dispatch-fast-path workloads."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import blas as jblas  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, host_array  # noqa: E402
from repro_torch.core import intercept as icp  # noqa: E402
from repro_torch.core import runtime as rtm  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.runtime import RoutineStats  # noqa: E402

#: every counter of the port's RoutineStats; wall time is not compared
COUNTERS = [f.name for f in dataclasses.fields(RoutineStats)
            if f.name != "seconds"]


def _counters(stats) -> dict:
    return {name: {k: dataclasses.asdict(r)[k] for k in COUNTERS}
            for name, r in stats.per_routine.items()}


def _f32(rng, shape):
    return rng.standard_normal(shape).astype("float32")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("SCILIB_POLICY", "SCILIB_THRESHOLD", "SCILIB_SYNC",
                "SCILIB_DEVICE_BYTES", "SCILIB_DISPATCH_CACHE"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# --------------------------------------------------------------------- #
# the quickstart workload through torch.mv / dot / mm / @                #
# --------------------------------------------------------------------- #
def test_quickstart_counts_like_reference(clean_env):
    """examples/quickstart.py's application under the legacy offload()
    shim: matmul, @, einsum, a small mm, a gemv by torch.mv (jnp.dot of
    a matrix and a vector) and a dot of two vectors (counted as
    uninstrumented by both).  The vector is device-born in both
    packages (ROADMAP Queue 3: a host column fails in JAX 0.9)."""
    rng = np.random.default_rng(0)
    a_np, b_np = _f32(rng, (768, 768)), _f32(rng, (768, 768))
    x_np = b_np[:, 0].copy()
    with jcore.offload("dfu", threshold=500.0) as rt:
        a, b = jcore.host_array(a_np), jcore.host_array(b_np)
        x = jnp.asarray(x_np)
        c = jnp.matmul(a, b)
        for _ in range(5):
            c = jnp.matmul(a, c)
        d = jnp.einsum("ij,kj->ik", c, b)
        jnp.dot(a[:64, :64], b[:64, :64])
        y = jnp.dot(a, x)
        before = rt.stats.uninstrumented_calls
        jnp.dot(x, x)
        jdelta = rt.stats.uninstrumented_calls - before
        rt.sync()
        want = _counters(rt.stats)
    jd, jy = np.asarray(d), np.asarray(y)
    with icp.offload("dfu", threshold=500.0, device="cpu") as rt:
        a, b = host_array(a_np), host_array(b_np)
        x = torch.as_tensor(x_np)
        c = torch.matmul(a, b)
        for _ in range(5):
            c = a @ c
        d = torch.einsum("ij,kj->ik", c, b)
        torch.mm(a[:64, :64], b[:64, :64])
        y = torch.mv(a, x)
        before = rt.stats.uninstrumented_calls
        dot = torch.dot(x, x)
        tdelta = rt.stats.uninstrumented_calls - before
        rt.sync()
        got = _counters(rt.stats)
    assert got == want
    assert set(got) == {"sgemm", "sgemv"}
    assert got["sgemv"]["calls"] == 1
    assert tdelta == jdelta == 1
    # float32 products of 768-wide chains reach 1e10 and cancel: the
    # error scale is the largest entry's
    np.testing.assert_allclose(d.numpy(), jd, rtol=0,
                               atol=1e-4 * np.abs(jd).max())
    np.testing.assert_allclose(y.numpy(), jy, rtol=2e-3, atol=2e-3)
    assert float(dot) == pytest.approx(float(x_np @ x_np), rel=1e-5)


# --------------------------------------------------------------------- #
# tests/test_dispatch_fastpath.py's workloads                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ("cpu", "memcopy", "counter", "dfu",
                                    "pinned"))
def test_every_policy_counts_like_reference(policy, clean_env):
    """test_single_kind_backend_runs_all_policies, through @."""
    rng = np.random.default_rng(1)
    a_np, b_np = _f32(rng, (300, 300)), _f32(rng, (300, 300))
    with jcore.offload(policy, threshold=100) as rt:
        out_j = np.asarray(jnp.matmul(jcore.host_array(a_np),
                                      jcore.host_array(b_np)))
        want = _counters(rt.stats)
    with icp.offload(policy, threshold=100, device="cpu") as rt:
        out_t = host_array(a_np) @ host_array(b_np)
        got = _counters(rt.stats)
    assert got == want
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-4, atol=1e-3)


def _cache_workload(mm, make, rng):
    a, b = make(_f32(rng, (256, 256))), make(_f32(rng, (256, 256)))
    for _ in range(4):
        mm(a, b)
    mm(make(_f32(rng, (128, 256))), b)


def _batched_workload(mm, make, rng):
    mm(make(_f32(rng, (3, 48, 32))), make(_f32(rng, (3, 32, 24))))


def _gemv_workload(mm, make, rng):
    a = make(_f32(rng, (512, 512)))
    for _ in range(2):
        mm(a, _f32(rng, (512,)))


WORKLOADS = {
    # (threshold, reference call, port call, workload); the symbols are
    # looked up at call time, inside the session that patches them
    "dispatch_cache": (100, lambda a, b: jnp.matmul(a, b),
                       lambda a, b: torch.mm(a, b), _cache_workload),
    "bmm": (10, lambda a, b: jnp.matmul(a, b),
            lambda a, b: torch.bmm(a, b), _batched_workload),
    "mv": (100, lambda a, x: jnp.dot(a, jnp.asarray(x)),
           lambda a, x: torch.mv(a, torch.as_tensor(x)), _gemv_workload),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_fastpath_workloads_count_like_reference(name, clean_env):
    """The dispatch cache's hits and misses, a batched product by
    torch.bmm (jnp.matmul on 3-D operands), and gemv by torch.mv, with
    host-first-touched operands: every counter equal."""
    threshold, jmm, tmm, work = WORKLOADS[name]
    with jcore.offload("dfu", threshold=threshold) as rt:
        work(jmm, jcore.host_array, np.random.default_rng(2))
        want = _counters(rt.stats)
    with icp.offload("dfu", threshold=threshold, device="cpu") as rt:
        work(tmm, host_array, np.random.default_rng(2))
        got = _counters(rt.stats)
    assert got == want
    assert got


def test_lru_eviction_at_byte_cap_like_reference(clean_env):
    """test_lru_eviction_at_byte_cap through the runtime-level shim.
    The last product is kept alive: the reference's runtime holds recent
    outputs for sync() while the port holds CUDA events, so a discarded
    output leaves the placements earlier here."""
    nbytes = 256 * 256 * 4
    out = []
    for pkg in ("ref", "port"):
        rng = np.random.default_rng(3)
        if pkg == "ref":
            rt = jrt.install("dfu", threshold=10, record_trace=False,
                             device_bytes=2 * nbytes)
            mk, gemm, done = jcore.host_array, jblas.gemm, jrt.uninstall
        else:
            rt = rtm.install("dfu", threshold=10, record_trace=False,
                             device_bytes=2 * nbytes, device="cpu")
            mk, gemm, done = host_array, blas.gemm, rtm.uninstall
        try:
            xs = [mk(_f32(rng, (256, 256))) for _ in range(3)]
            outs = [gemm(x, x) for x in xs]
            last = gemm(xs[0], xs[0])
            out.append((rt.stats.evictions, rt.stats.evicted_bytes,
                        rt.resident_bytes(), _counters(rt.stats)))
            del outs, last
        finally:
            done()
    assert out[0] == out[1]
    assert out[1][0] >= 1


# --------------------------------------------------------------------- #
# the shims                                                              #
# --------------------------------------------------------------------- #
def _shim_sequence(pkg):
    """install (intercepting), install at runtime level (no patch), then
    uninstall twice and once more with nothing open; returns what each
    step observed."""
    if pkg == "ref":
        icp_, rt_, mod, name = jcore, jrt, jnp, "matmul"
        kw = {}
    else:
        icp_, rt_, mod, name = icp, rtm, torch, "matmul"
        kw = {"device": "cpu"}
    orig = getattr(mod, name)
    seen = []
    r1 = icp_.install("dfu", threshold=100.0, **kw)
    seen.append((rt_.active() is r1, getattr(mod, name) is not orig,
                 r1.config.policy, r1.threshold))
    r2 = rt_.install("memcopy", threshold=50.0, **kw)
    seen.append((rt_.active() is r2, r2.config.policy, r2.threshold))
    st2 = icp_.uninstall()
    seen.append((st2 is r2.stats, rt_.active() is r1,
                 getattr(mod, name) is not orig))
    st1 = rt_.uninstall()
    seen.append((st1 is r1.stats, rt_.active() is None,
                 getattr(mod, name) is orig))
    seen.append(icp_.uninstall())
    return seen


def test_install_uninstall_nest_like_reference(clean_env):
    """Repeated install()s nest on one legacy stack shared by the
    intercept- and runtime-level shims; each uninstall() closes the most
    recent and returns its statistics; the intercept-level one patches
    the symbols for as long as it is open."""
    want = _shim_sequence("ref")
    got = _shim_sequence("port")
    assert got == want
    assert got[0] == (True, True, "dfu", 100.0)
    assert got[-1] is None


def test_offload_context_manager_restores_everything(clean_env):
    orig = (torch.matmul, torch.mv, torch.dot, torch.bmm)
    with icp.offload("memcopy", threshold=10.0, device="cpu") as rt:
        assert rtm.active() is rt
        assert repro_torch.active_session().runtime is rt
        assert (torch.matmul, torch.mv, torch.dot, torch.bmm) != orig
        torch.bmm(torch.ones(2, 16, 16), torch.ones(2, 16, 16))
    assert rtm.active() is None
    assert (torch.matmul, torch.mv, torch.dot, torch.bmm) == orig
    assert rt.stats.per_routine["sgemm"].calls == 1
    assert repro_torch.install is icp.install
    assert repro_torch.offload is icp.offload


def test_legacy_env_precedence_like_reference(clean_env):
    """SCILIB_POLICY/SCILIB_THRESHOLD override install()'s arguments;
    explicit sync/device_bytes override theirs; an explicit config
    bypasses the environment."""
    clean_env.setenv("SCILIB_POLICY", "memcopy")
    clean_env.setenv("SCILIB_THRESHOLD", "250")
    clean_env.setenv("SCILIB_SYNC", "1")
    for kw in (dict(policy="dfu", threshold=10.0),
               dict(sync=False, device_bytes=1 << 20), {}):
        got = OffloadConfig.legacy(**kw).to_dict()
        assert got == JConfig.legacy(**kw).to_dict()
    rt = rtm.install("dfu", config=OffloadConfig(policy="pinned"),
                     device="cpu")
    try:
        assert rt.config.policy == "pinned"
    finally:
        rtm.uninstall()


def test_new_trampolines_fall_through_what_they_do_not_model():
    """torch.mv with out=, torch.bmm of mismatched batches (the original
    raises its own error), torch.dot of two vectors: each counted as
    uninstrumented; none routed."""
    with repro_torch.session(OffloadConfig(threshold=1.0),
                             device="cpu") as s:
        a, x = torch.ones(8, 8), torch.ones(8)
        out = torch.empty(8)
        torch.mv(a, x, out=out)
        with pytest.raises(RuntimeError):
            torch.bmm(torch.ones(2, 4, 4), torch.ones(3, 4, 4))
        torch.dot(x, x)
        torch.mv(a.to(torch.int64), x.to(torch.int64))
        assert s.stats.uninstrumented_calls == 4
        assert not s.stats.per_routine
    assert out.tolist() == [8.0] * 8

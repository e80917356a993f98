"""The port's BLAS surface against the reference's, routine by routine.

Each case runs the same numpy inputs through ``repro.core.blas`` inside a
reference session and through ``repro_torch.core.blas`` inside a port
session on the CPU (simulated tiers), and compares the results and every
per-routine counter.  Also: a host tensor written in place after it
migrated is re-migrated, not served stale; and one intercepted call
counts exactly once.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, host_array  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.runtime import RoutineStats  # noqa: E402

#: tolerances relative to max|reference| and why: float64/complex128 sum
#: in float64 in both packages, in different orders (~K*eps64); float32
#: in float32 (~K*eps32 at K <= 64)
TOL = {"float64": 1e-12, "complex128": 1e-12, "float32": 1e-5}

#: RoutineStats fields both packages count; wall time is not compared
COUNTERS = [f.name for f in dataclasses.fields(RoutineStats)
            if f.name not in ("seconds", "flops")]


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _data(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape)
        if "complex" in dtype:
            x = x + 1j * rng.standard_normal(shape)
        # triangles/symmetric inputs stay well conditioned
        if len(shape) == 2 and shape[0] == shape[1]:
            x = x / shape[0] + 2.0 * np.eye(shape[0])
        out.append(x.astype(dtype))
    return out


def _run_both(routine, arrays, kw, policy="dfu", threshold=10.0, host=()):
    """Run ``routine`` in both packages; inputs at the indices in ``host``
    are host-first-touched (host_array), the rest device-born."""
    jc = JConfig(policy=policy, threshold=threshold)
    with repro.session(jc, intercept=False) as s:
        jargs = [jcore.host_array(jnp.asarray(x)) if i in host
                 else jnp.asarray(x) for i, x in enumerate(arrays)]
        jout = getattr(jcore.blas, routine)(*jargs, **kw)
        s.sync()
        jstats = {k: dataclasses.asdict(v)
                  for k, v in s.stats.per_routine.items()}
    tc = OffloadConfig(policy=policy, threshold=threshold)
    with repro_torch.session(tc, device="cpu", intercept=False) as s:
        targs = [host_array(x) if i in host else torch.as_tensor(x)
                 for i, x in enumerate(arrays)]
        tout = getattr(blas, routine)(*targs, **kw)
        s.sync()
        tstats = {k: dataclasses.asdict(v)
                  for k, v in s.stats.per_routine.items()}
    want = np.asarray(jout)
    got = tout.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / scale <= TOL[str(got.dtype)]
    assert tstats.keys() == jstats.keys()
    for name in tstats:
        for field in COUNTERS:
            assert tstats[name][field] == jstats[name][field], (name, field)
    return tstats


CASES = [
    ("gemm", (48, 40), (40, 36), None, {}, "float64"),
    ("gemm", (40, 48), (40, 36), (48, 36),
     dict(alpha=1.5, beta=-0.5, trans_a="T"), "float64"),
    ("gemm", (48, 40), (36, 40), None, dict(trans_b="C", alpha=0.5 - 1j),
     "complex128"),
    ("gemm", (3, 20, 24), (3, 24, 16), None, {}, "float32"),
    ("gemv", (48, 40), (40,), None, {}, "float64"),
    ("gemv", (48, 40), (48,), None, dict(trans="T"), "float64"),
    ("symm", (40, 40), (40, 24), (40, 24), dict(side="L", uplo="U",
                                                alpha=2.0, beta=1.0),
     "float64"),
    ("symm", (24, 24), (40, 24), None, dict(side="R"), "float64"),
    ("hemm", (40, 40), (40, 24), None, dict(uplo="L"), "complex128"),
    ("syrk", (40, 24), (40, 40), None, dict(uplo="U", alpha=0.5, beta=2.0),
     "float64"),
    ("syrk", (24, 40), None, None, dict(trans="T"), "float64"),
    ("herk", (40, 24), None, None, dict(uplo="L"), "complex128"),
    ("syr2k", (40, 24), (40, 24), (40, 40), dict(uplo="L", beta=0.5),
     "float64"),
    ("her2k", (40, 24), (40, 24), None, dict(uplo="U", alpha=1 + 1j),
     "complex128"),
    ("trmm", (40, 40), (40, 24), None, dict(side="L", uplo="U",
                                            trans="T", diag="U"),
     "float64"),
    ("trmm", (24, 24), (40, 24), None, dict(side="R", alpha=2.0),
     "complex128"),
    ("trsm", (40, 40), (40, 24), None, dict(side="L", uplo="L",
                                            trans="N", alpha=2.0),
     "float64"),
    ("trsm", (24, 24), (40, 24), None, dict(side="R", uplo="U",
                                            trans="T", diag="U"),
     "float64"),
    ("trsm", (40, 40), (40, 24), None, dict(uplo="U", trans="C"),
     "complex128"),
    ("trsm", (200, 200), (200, 16), None, {}, "float64"),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_routine_matches_reference(case):
    routine, sa, sb, sc, kw, dtype = case
    shapes = [s for s in (sa, sb, sc) if s is not None]
    arrays = _data(len(shapes) * 7 + len(kw), shapes, dtype)
    stats = _run_both(routine, arrays, kw, host=(0,))
    assert sum(r["calls"] for r in stats.values()) == 1


@pytest.mark.parametrize("policy", ["dfu", "memcopy", "counter", "pinned",
                                    "cpu"])
def test_policies_count_like_reference(policy):
    a, b, c = _data(3, [(48, 48), (48, 48), (48, 48)], "float64")
    stats = _run_both("gemm", [a, b, c], dict(beta=1.0), policy=policy,
                      host=(0, 1))
    st = stats["dgemm"]
    assert st["offloaded"] == (0 if policy == "cpu" else 1)


def test_below_threshold_runs_host_path_like_reference():
    a, b = _data(4, [(30, 30), (30, 20)], "float64")
    stats = _run_both("gemm", [a, b], {}, threshold=500.0, host=(0,))
    assert stats["dgemm"]["on_host"] == 1
    assert stats["dgemm"]["transient_bytes"] == 30 * 30 * 8


def test_in_place_write_after_migration_is_not_served_stale():
    """A host tensor written in place after DFU moved it: the next call
    migrates it again (its version counter moved) and computes with the
    new values.  The reference's arrays are immutable, so its equivalent
    is a new host array, which it also moves again."""
    a, b = _data(5, [(64, 64), (64, 64)], "float64")
    with repro_torch.session(OffloadConfig(threshold=10.0),
                             device="cpu") as s:
        ta, tb = host_array(a), host_array(b)
        first = blas.gemm(ta, tb)
        again = blas.gemm(ta, tb)
        moved_once = s.stats.per_routine["dgemm"].bytes_in
        ta.add_(1.0)
        after = blas.gemm(ta, tb)
        st = s.stats.per_routine["dgemm"]
    np.testing.assert_allclose(first.numpy(), a @ b, rtol=1e-12)
    np.testing.assert_allclose(again.numpy(), a @ b, rtol=1e-12)
    np.testing.assert_allclose(after.numpy(), (a + 1.0) @ b, rtol=1e-12)
    assert moved_once == 2 * 64 * 64 * 8
    assert st.bytes_in == moved_once + 64 * 64 * 8
    with repro.session(JConfig(threshold=10.0), intercept=False) as s:
        ja, jb = jcore.host_array(jnp.asarray(a)), jcore.host_array(
            jnp.asarray(b))
        jcore.blas.gemm(ja, jb)
        jcore.blas.gemm(ja, jb)
        jcore.blas.gemm(jcore.host_array(jnp.asarray(a + 1.0)), jb)
        assert s.stats.per_routine["dgemm"].bytes_in == st.bytes_in


def test_one_intercepted_call_counts_once():
    """The pipeline's own products (the gemv's, the plain versions', the
    kernels' updates) never re-enter the interceptor."""
    rng = np.random.default_rng(6)
    a = torch.as_tensor(rng.standard_normal((64, 64)))
    x = torch.as_tensor(rng.standard_normal(64))
    t = torch.as_tensor(np.tril(rng.standard_normal((300, 300))) / 300
                        + 2.0 * np.eye(300))
    r = torch.as_tensor(rng.standard_normal((300, 8)))
    orig = torch.matmul
    with repro_torch.session(OffloadConfig(threshold=10.0),
                             device="cpu") as s:
        assert torch.matmul is not orig
        y = torch.matmul(a, a)
        v = a @ x
        w = torch.einsum("ij,kj->ik", a, a)
        u = torch.tensordot(a, a, dims=([0], [0]))
        mm = torch.mm(a, a)
        sol = blas.trsm(t, r)              # recursion runs gemm updates
        st = s.stats
        counts = {k: v.calls for k, v in st.per_routine.items()}
        assert st.uninstrumented_calls == 0
    assert counts == {"dgemm": 4, "dgemv": 1, "dtrsm": 1}
    assert torch.matmul is orig and "__matmul__" not in vars(torch.Tensor)
    an = a.numpy()
    for got, want in ((y, an @ an), (v, an @ x.numpy()), (w, an @ an.T),
                      (u, an.T @ an), (mm, an @ an)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(t.numpy() @ sol.numpy(), r.numpy(),
                               atol=1e-12)


def test_unblasable_calls_fall_through_and_count_uninstrumented():
    i = torch.ones((3, 3), dtype=torch.int64)
    f = torch.ones((3, 3))
    with repro_torch.session(device="cpu") as s:
        assert torch.equal(i @ i, torch.full((3, 3), 3))
        torch.einsum("ii->i", f)
        assert s.stats.uninstrumented_calls == 2
        assert s.stats.per_routine == {}

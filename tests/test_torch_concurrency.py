"""Thread-safe concurrent multi-tenant sessions of the port.

The properties of ``tests/test_concurrency.py``, held by the port on
``device="cpu"`` with the golden values that file asserts, and against
the reference live where a workload runs here (on its single-kind
simulated tiers, ``ref_tiers``):

* sessions are context-local, and ``scope()`` adopts an open session in
  a worker thread and restores the worker's own on exit;
* the residency store and the :class:`SharedDevicePool` under
  contention: exact byte ledgers, register/attach/unregister,
  quota-first then quota-proportional eviction, the pinned-tenant
  exemption, the config-driven default pool;
* pool totals equal the tenant sums under a 32-thread storm;
* no decision-cache bleed between concurrent sessions; many workers in
  one session lose no counter; concurrent sessions equal a single-thread
  oracle, and a single-thread session equals the reference's;
* the injector's counter walk and the breaker's trips are atomic;
  chaos x concurrency equals a serialized replay;
* trace events carry the session id, and unnamed dumps keep the
  pre-tenant format.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import blas as jblas  # noqa: E402
from repro.core import memspace as jms  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402
from repro.core.policy import host_array as jhost  # noqa: E402
from repro.core.session import Session as JSession  # noqa: E402

from repro_torch.core import blas, memspace  # noqa: E402
from repro_torch.core import faults as flt  # noqa: E402
from repro_torch.core import residency as res  # noqa: E402
from repro_torch.core import runtime as rtm  # noqa: E402
from repro_torch.core import session as ses  # noqa: E402
from repro_torch.core.callsite import (CallSiteProfile,  # noqa: E402
                                       CallSiteRegistry)
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.policy import host_array  # noqa: E402
from repro_torch.core.residency import (ResidencyStore,  # noqa: E402
                                        SharedDevicePool)
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.trace import Trace  # noqa: E402
from repro_torch.memtier import MemTierSimulator  # noqa: E402

N = 64                       # matrix edge used throughout
NBYTES = N * N * 4


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


def _open(cfg, **kw):
    return ses.session(cfg, device="cpu", intercept=False, **kw)


# --------------------------------------------------------------------- #
# the harness                                                            #
# --------------------------------------------------------------------- #
def run_threads(n, fn, *, barrier=True, timeout=120.0):
    """Run ``fn(idx)`` on ``n`` threads; re-raise the first exception.
    With ``barrier=True`` every worker waits at a start barrier so the
    bodies overlap; a raising worker aborts the barrier."""
    start = threading.Barrier(n) if barrier else None
    errors = []
    err_lock = threading.Lock()

    def body(idx):
        try:
            if start is not None:
                start.wait()
            fn(idx)
        except BaseException as exc:   # noqa: BLE001 - harness boundary
            with err_lock:
                errors.append(exc)
            if start is not None:
                start.abort()

    threads = [threading.Thread(target=body, args=(i,),
                                name=f"worker-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"{t.name} did not finish"
    if errors:
        raise errors[0]


def _np_mats(seed, count=3, n=N):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)).astype("float32")
            for _ in range(count)]


def _np_tri(seed, n=N):
    rng = np.random.default_rng(seed)
    return np.tril(rng.standard_normal((n, n)) + n).astype("float32")


def _mats(seed, count=3, n=N):
    return [host_array(m) for m in _np_mats(seed, count, n)]


def _mixed_workload(seed, reps=3, bl=blas, host=host_array):
    """gemm -> syrk -> trsm over per-worker deterministic operands."""
    a, b, c = (host(m) for m in _np_mats(seed))
    t = host(_np_tri(seed + 1000))
    outs = []
    for _ in range(reps):
        g = bl.gemm(a, b)
        s = bl.syrk(c)
        x = bl.trsm(t, g)
        outs.extend((g, s, x))
    return outs


def test_run_threads_propagates_first_exception():
    def boom(idx):
        if idx == 3:
            raise ValueError("worker 3 failed")

    with pytest.raises(ValueError, match="worker 3"):
        run_threads(8, boom)


def test_run_threads_barrier_overlaps_all_workers():
    ran = [0] * 8
    gate = threading.Barrier(8)      # passes only if all overlap

    def body(idx):
        gate.wait(timeout=30)
        ran[idx] = 1

    run_threads(8, body)
    assert ran == [1] * 8


# --------------------------------------------------------------------- #
# context-local sessions and scope()                                     #
# --------------------------------------------------------------------- #
def test_sessions_are_context_local():
    opened, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with _open(OffloadConfig(), record_trace=False) as s:
            seen["worker_active"] = ses.active_session() is s
            seen["worker_space"] = memspace.active() is s.runtime.memspace
            opened.set()
            done.wait(30)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert opened.wait(30)
        assert ses.active_session() is None
        assert rtm.active() is None
    finally:
        done.set()
        t.join(30)
    assert seen["worker_active"] and seen["worker_space"]


def test_session_nesting_race_regression():
    """A opens, B opens, A closes: each thread's nesting stays its own."""
    a_opened, b_opened, a_closed = (threading.Event(), threading.Event(),
                                    threading.Event())
    state = {}

    def thread_a():
        s = _open(OffloadConfig(), record_trace=False)
        a_opened.set()
        assert b_opened.wait(30)
        s.close()
        state["a_after_close"] = ses.active_session()
        state["a_runtime_after_close"] = rtm.active()
        a_closed.set()

    def thread_b():
        assert a_opened.wait(30)
        with _open(OffloadConfig(), record_trace=False) as s:
            b_opened.set()
            assert a_closed.wait(30)
            state["b_still_active"] = ses.active_session() is s
            state["b_runtime_ok"] = rtm.active() is s.runtime

    ta = threading.Thread(target=thread_a)
    tb = threading.Thread(target=thread_b)
    ta.start(), tb.start()
    ta.join(30), tb.join(30)
    assert state["a_after_close"] is None
    assert state["a_runtime_after_close"] is None
    assert state["b_still_active"] and state["b_runtime_ok"]


def test_scope_adopts_open_session_in_worker_thread():
    """``with s.scope():`` adopts an open session in a worker; its
    runtime serializes the calls, and the worker is restored after."""
    with _open(OffloadConfig(policy="dfu", threshold=10.0),
               record_trace=False) as s:

        def worker(idx):
            assert ses.active_session() is None      # not inherited
            with s.scope():
                assert ses.active_session() is s
                assert rtm.active() is s.runtime
                a, b, _ = _mats(idx, n=32)
                blas.gemm(a, b)
            assert ses.active_session() is None      # restored
            assert rtm.active() is None

        run_threads(8, worker)
        s.sync()
        total = sum(r.calls for r in s.stats.per_routine.values())
        assert total == 8                            # none lost


def test_scope_restores_workers_own_session():
    with _open(OffloadConfig(threshold=123.0), record_trace=False) as shared:

        def worker(idx):
            with _open(OffloadConfig(threshold=77.0),
                       record_trace=False) as own:
                with shared.scope():
                    assert ses.active_session() is shared
                    assert rtm.active().threshold == 123.0
                assert ses.active_session() is own
                assert rtm.active() is own.runtime

        run_threads(4, worker)


def test_scope_refuses_a_closed_session():
    s = _open(OffloadConfig(), record_trace=False)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        with s.scope():
            pass


def test_legacy_install_stack_is_context_local():
    from repro_torch.core import intercept as icp

    def worker(idx):
        rt = rtm.install("dfu", threshold=10, record_trace=False,
                         device="cpu")
        try:
            assert rtm.active() is rt
        finally:
            rtm.uninstall()
        assert rtm.active() is None

    run_threads(4, worker)
    assert rtm.active() is None
    assert icp._PATCHED == 0


# --------------------------------------------------------------------- #
# ResidencyStore under contention                                        #
# --------------------------------------------------------------------- #
def test_concurrent_puts_account_bytes_exactly():
    s = ResidencyStore("t")
    per, nth = 50, 8

    def worker(idx):
        for i in range(per):
            s.put((idx, i), f"p{idx}.{i}", 10)

    run_threads(nth, worker)
    assert len(s) == per * nth
    assert s.resident_bytes == per * nth * 10
    assert s.resident_bytes == sum(s.entry(k).nbytes for k in s.keys())


def test_concurrent_mixed_ops_no_lost_updates():
    s = ResidencyStore("t")

    def worker(idx):
        for i in range(40):
            s.put((idx, i), i, 7)
            assert s.get((idx, i)) == i
            if i % 3 == 0:
                s.drop((idx, i))

    run_threads(8, worker)
    assert s.resident_bytes == 7 * len(s)
    assert len(s) == 8 * (40 - 14)       # 14 drops per worker


def test_concurrent_eviction_under_cap_pressure():
    s = ResidencyStore("t", cap=200, policy="lru")

    def worker(idx):
        for i in range(60):
            s.put((idx, i), i, 20)

    run_threads(8, worker)
    assert s.resident_bytes <= 200
    assert s.resident_bytes == sum(s.entry(k).nbytes for k in s.keys())
    assert s.evictions == 8 * 60 - len(s)


def test_pins_never_evicted_under_concurrent_pressure():
    s = ResidencyStore("t", cap=200, policy="lru")
    s.put("pinned", "P", 50, pinned=True)

    def worker(idx):
        for i in range(50):
            s.put((idx, i), i, 30)

    run_threads(8, worker)
    assert "pinned" in s
    assert s.get("pinned") == "P"
    assert s.pinned_bytes() == 50


def test_concurrent_evict_one_terminates_and_accounts():
    s = ResidencyStore("t")
    for i in range(64):
        s.put(i, i, 10)
    freed = []
    lock = threading.Lock()

    def worker(idx):
        for _ in range(16):
            got = s.evict_one()
            with lock:
                freed.append(got)

    run_threads(4, worker)
    assert len(s) == 0 and s.resident_bytes == 0
    assert sum(freed) == 64 * 10
    assert s.evictions == 64


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                              # pragma: no cover
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    thread_ops = st.lists(
        st.tuples(st.integers(0, 3),
                  st.sampled_from(["place", "evict", "pin", "refetch"]),
                  st.integers(0, 5), st.integers(1, 40)),
        min_size=4, max_size=48)

    @given(ops=thread_ops)
    @settings(max_examples=25, deadline=None)
    def test_threaded_store_ops_preserve_invariants(ops):
        cap = 100
        s = ResidencyStore("t", cap=cap, policy="lru")
        s.put("pin-a", "PA", 30, pinned=True)
        per_worker = [[op for op in ops if op[0] == w] for w in range(4)]

        def worker(idx):
            for _, kind, key, nbytes in per_worker[idx]:
                if kind in ("place", "refetch"):
                    s.put((idx, key), key, min(nbytes, 40))
                elif kind == "evict":
                    s.evict_one()
                else:
                    s.put((idx, key), key, min(nbytes, 40))
                    s.pin((idx, key))
                    s.unpin((idx, key))

        run_threads(4, worker)
        assert s.resident_bytes == sum(s.entry(k).nbytes for k in s.keys())
        assert s.resident_bytes <= cap
        assert "pin-a" in s and s.get("pin-a") == "PA"


# --------------------------------------------------------------------- #
# SharedDevicePool                                                       #
# --------------------------------------------------------------------- #
def test_pool_register_unique_ids_under_contention():
    pool = SharedDevicePool(1 << 20)
    got = []
    lock = threading.Lock()

    def worker(idx):
        sid = pool.register()
        with lock:
            got.append(sid)

    run_threads(32, worker)
    assert len(set(got)) == 32
    assert set(pool.members()) == set(got)


def test_pool_duplicate_name_rejected():
    pool = SharedDevicePool(1 << 20)
    pool.register("a")
    with pytest.raises(ValueError, match="already registered"):
        pool.register("a")


def test_pool_quota_evicts_over_quota_tenant_first():
    pool = SharedDevicePool(10_000)
    sa, sb = ResidencyStore("a-store"), ResidencyStore("b-store")
    pool.register("a", quota=100)
    pool.register("b", quota=5_000)
    pool.attach("a", sa)
    pool.attach("b", sb)
    for i in range(5):
        sb.put(("b", i), i, 60)
    for i in range(5):
        sa.put(("a", i), i, 60)      # 300B > quota 100 -> evicted down
    assert pool.usage("a") <= 100
    assert pool.usage("b") == 300
    assert sb.evictions == 0 and sa.evictions >= 4


def test_pool_fair_eviction_is_quota_proportional():
    pool = SharedDevicePool(500)
    sa, sb = ResidencyStore("a-store"), ResidencyStore("b-store")
    pool.register("a", quota=400)
    pool.register("b", quota=400)
    pool.attach("a", sa)
    pool.attach("b", sb)
    for i in range(4):
        sa.put(("a", i), i, 100)
    sb.put(("b", 0), 0, 100)
    sb.put(("b", 1), 1, 100)
    assert pool.usage() <= 500
    assert sa.evictions >= 1 and sb.evictions == 0


def test_pool_pinned_tenant_is_exempted_not_spun():
    pool = SharedDevicePool(100)
    sa = ResidencyStore("a-store")
    pool.register("a", quota=50)
    pool.attach("a", sa)
    sa.put("p1", 1, 80, pinned=True)
    sa.put("p2", 2, 80, pinned=True)
    assert pool.usage("a") == 160
    assert pool.rebalance() == 0
    assert "p1" in sa and "p2" in sa


def test_pool_unregister_detaches_stores():
    pool = SharedDevicePool(1 << 20)
    s = ResidencyStore("a-store")
    pool.register("a")
    pool.attach("a", s)
    s.put("k", 1, 100)
    assert pool.usage("a") == 100
    pool.unregister("a")
    assert s.pool is None and s.owner == ""
    assert pool.usage() == 0
    s.put("k2", 2, 100)
    assert pool.usage() == 0
    assert pool.places == 1


def test_default_pool_config_driven_sessions_share_it():
    res.reset_default_pool()
    try:
        cfg = OffloadConfig(policy="dfu", threshold=10.0,
                            pool_bytes=1 << 20, pool_quota=1 << 19)
        with Session(cfg, device="cpu", record_trace=False,
                     intercept=False, name="t1") as s1:
            with Session(cfg, device="cpu", record_trace=False,
                         intercept=False, name="t2") as s2:
                pool = res.default_pool()
                assert s1.runtime.pool is pool
                assert s2.runtime.pool is pool
                assert pool.total_bytes == 1 << 20
                assert pool.quota_of("t1") == 1 << 19
                assert set(pool.members()) == {"t1", "t2"}
        assert pool.members() == ()
    finally:
        res.reset_default_pool()


def test_pool_ledger_equals_tenant_resident_bytes_and_cap():
    """Three threads, each a named session on one pool smaller than
    their operands, run 12 gemms over 4 host-born operand pairs of their
    own (the tenancy phase of chip_smoke.py, at CPU size).  Sampled
    between calls — under every tenant's runtime lock, so no call is in
    flight — the ledger equals the sum of the tenants' resident bytes and
    fits the pool; tenants evict each other; each tenant's results are
    its single-threaded run's, bit for bit."""
    pool = SharedDevicePool(8 * NBYTES, name="ledger")
    cfg = OffloadConfig(policy="dfu", threshold=10.0)
    nth = 3
    sessions = [_open(cfg, record_trace=False, name=f"t{i}", pool=pool)
                for i in range(nth)]
    owners = {}
    cross = [0]
    lock = threading.Lock()
    samples = []

    def watch(i, store):
        hook = store.on_evict

        def on_evict(*args):
            if threading.current_thread() is not owners.get(i):
                with lock:
                    cross[0] += 1
            hook(*args)
        store.on_evict = on_evict

    for i, s in enumerate(sessions):
        watch(i, s.runtime.placements)

    def sample():
        locks = [s.runtime._lock for s in sessions]
        for lk in locks:
            lk.acquire()
        try:
            resident = sum(st.resident_bytes for m in
                           pool._members.values() for st in m.stores)
            samples.append((pool.usage(), resident))
        finally:
            for lk in reversed(locks):
                lk.release()

    def sequence(idx):
        ops = [_mats(1000 * idx + p, count=2) for p in range(4)]
        return [blas.gemm(*ops[k % 4]).clone() for k in range(12)]

    outs = {}
    # tenants arrive in turn: each once the one before placed its operands
    arrived = [threading.Event() for _ in range(nth)]

    def worker(idx):
        owners[idx] = threading.current_thread()
        ops = [_mats(1000 * idx + p, count=2) for p in range(4)]
        if idx:
            assert arrived[idx - 1].wait(60)
        mine = []
        with sessions[idx].scope():
            for k in range(12):
                mine.append(blas.gemm(*ops[k % 4]).clone())
                sample()
                if k == 3:
                    arrived[idx].set()
        outs[idx] = mine

    try:
        run_threads(nth, worker, barrier=False)
        assert all(used == resident and used <= pool.total_bytes
                   for used, resident in samples), samples
        rows = pool.tenant_stats()
        assert sum(r["evictions"] for r in rows.values()) > 0
        assert cross[0] > 0
        assert "tenant(s)" in pool.report()
    finally:
        for s in sessions:
            s.close()
    assert pool.members() == ()
    for idx in range(nth):
        with _open(cfg, record_trace=False) as s:
            serial = sequence(idx)
        for got, want in zip(outs[idx], serial):
            assert torch.equal(got, want)


def test_pool_totals_equal_tenant_sums_under_32_thread_storm():
    """32 sessions hammer one pool with mixed gemm/syrk/trsm under real
    cap pressure; at quiescence the pool totals equal the per-tenant
    sums, and the usage ledger equals the stores' resident bytes."""
    nth = 32
    pool = SharedDevicePool(6 * NBYTES, name="storm")
    cfg = OffloadConfig(policy="dfu", threshold=10.0)
    quiesce = threading.Barrier(nth)
    snap = {}

    def worker(idx):
        with _open(cfg, record_trace=False, name=f"w{idx}",
                   pool=pool) as s:
            outs = _mixed_workload(idx, reps=2)
            s.sync()
            quiesce.wait(60)         # everyone done, nobody closed
            if idx == 0:
                snap["tenants"] = pool.tenant_stats()
                snap["totals"] = (pool.places, pool.placed_bytes,
                                  pool.evictions, pool.evicted_bytes,
                                  pool.refetches)
                snap["usage"] = pool.usage()
                snap["resident"] = sum(
                    st.resident_bytes for m in pool._members.values()
                    for st in m.stores)
            quiesce.wait(60)         # hold tenants until the snapshot
            del outs

    run_threads(nth, worker)
    rows = snap["tenants"].values()
    assert len(rows) == nth
    sums = (sum(r["places"] for r in rows),
            sum(r["placed_bytes"] for r in rows),
            sum(r["evictions"] for r in rows),
            sum(r["evicted_bytes"] for r in rows),
            sum(r["refetches"] for r in rows))
    assert sums == snap["totals"]
    assert snap["totals"][0] > 0
    assert sum(r["usage"] for r in rows) == snap["usage"] == \
        snap["resident"]


def test_pool_pins_survive_cross_tenant_pressure():
    pool = SharedDevicePool(4 * NBYTES, name="pinpool")
    cfg = OffloadConfig(policy="dfu", threshold=10.0)
    pinned_sess = _open(cfg, record_trace=False, name="pinner", pool=pool)
    try:
        a, b, _ = _mats(999)
        blas.gemm(a, b)
        pinned_sess.pin(a)
        key = memspace.buffer_key(a)
        assert pinned_sess.runtime.placements.entry(key).pinned

        def worker(idx):
            with _open(cfg, record_trace=False, name=f"evictor-{idx}",
                       pool=pool):
                _mixed_workload(idx, reps=3)

        run_threads(8, worker)
        assert key in pinned_sess.runtime.placements
        assert pinned_sess.runtime.placements.entry(key).pinned
    finally:
        pinned_sess.close()


# --------------------------------------------------------------------- #
# runtime + dispatch under concurrency                                   #
# --------------------------------------------------------------------- #
def test_no_cross_session_decision_cache_bleed():
    lo = OffloadConfig(policy="dfu", threshold=10.0)     # offloads N=64
    hi = OffloadConfig(policy="dfu", threshold=1e6)      # stays host
    results = {}

    def worker(idx):
        with _open(lo if idx % 2 == 0 else hi, record_trace=False) as s:
            a, b, _ = _mats(idx)
            for _ in range(4):
                blas.gemm(a, b)
            s.sync()
            st = s.stats.per_routine["sgemm"]
            results[idx] = (st.offloaded, st.on_host)

    run_threads(8, worker)
    for idx, (off, host) in results.items():
        assert (off, host) == ((4, 0) if idx % 2 == 0 else (0, 4)), idx


def test_shared_session_counters_lose_nothing():
    nth, per = 8, 6
    with _open(OffloadConfig(policy="dfu", threshold=10.0),
               record_trace=False) as s:

        def worker(idx):
            with s.scope():
                a, b, _ = _mats(idx)
                for _ in range(per):
                    blas.gemm(a, b)

        run_threads(nth, worker)
        s.sync()
        st = s.stats.per_routine["sgemm"]
        assert st.calls == nth * per
        assert st.offloaded + st.on_host == nth * per


def _counters(stats):
    return {name: (r.calls, r.offloaded, r.on_host, r.cache_hits,
                   r.cache_misses, r.bytes_in)
            for name, r in sorted(stats.per_routine.items())}


def test_concurrent_sessions_match_single_thread_oracle(ref_tiers):
    """N threads in independent sessions produce exactly the counters
    and results of the same workloads run one by one; and one worker's
    counters are the reference's on the same operands."""
    nth = 8
    cfg = OffloadConfig(policy="dfu", threshold=10.0)

    def run_one(idx):
        with _open(cfg, record_trace=False) as s:
            outs = _mixed_workload(idx, reps=2)
            s.sync()
            return _counters(s.stats), [o.numpy().copy() for o in outs]

    oracle = {idx: run_one(idx) for idx in range(nth)}
    threaded = {}
    lock = threading.Lock()

    def worker(idx):
        got = run_one(idx)
        with lock:
            threaded[idx] = got

    run_threads(nth, worker)
    for idx in range(nth):
        assert threaded[idx][0] == oracle[idx][0], idx
        for got, ref in zip(threaded[idx][1], oracle[idx][1]):
            np.testing.assert_array_equal(got, ref)
    with JSession(JConfig(policy="dfu", threshold=10.0),
                  record_trace=False, intercept=False) as s:
        outs = _mixed_workload(3, reps=2, bl=jblas, host=jhost)
        assert _counters(s.runtime.stats) == oracle[3][0]
    for got, ref in zip(oracle[3][1], outs):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3,
                                   atol=1e-3)


def test_single_threaded_behavior_unchanged():
    """The golden counters of the capped workload (evictions, bytes,
    decisions) hold after the locking refactor."""
    rng = np.random.default_rng(42)
    rt = rtm.install("dfu", threshold=10, device_bytes=2 * 128 * 128 * 4,
                     record_trace=False, device="cpu")
    try:
        xs = [host_array(rng.standard_normal((128, 128))
                         .astype("float32")) for _ in range(5)]
        outs = []
        for _ in range(3):
            for x in xs:
                outs.append(blas.gemm(x, x))
        rt.sync()
        assert rt.stats.evictions == 28
        assert rt.stats.evicted_bytes == 1835008
        st = rt.stats.per_routine["sgemm"]
        assert (st.offloaded, st.on_host) == (15, 0)
        assert (st.cache_hits, st.cache_misses) == (15, 15)
    finally:
        rtm.uninstall()


# --------------------------------------------------------------------- #
# call-site profiles under concurrency                                   #
# --------------------------------------------------------------------- #
def test_callsite_profile_observations_not_lost():
    prof = CallSiteProfile("gemm@x.py:f:1")
    per, nth = 200, 8

    def worker(idx):
        for i in range(per):
            prof.observe(64.0, 1e6, 1e-4, offload=(i % 2 == 0))
            prof.observe_residency(hit=(i % 3 == 0))

    run_threads(nth, worker)
    assert prof.calls == per * nth
    assert prof.offloaded + prof.on_host == per * nth
    assert prof.lookups == per * nth
    assert prof.n_avg_count == per * nth


def test_callsite_registry_one_profile_per_site_under_race():
    reg = CallSiteRegistry()
    got = []
    lock = threading.Lock()

    def worker(idx):
        p = reg.profile("site-x")
        with lock:
            got.append(p)
        p.observe(10.0, 1.0, 1e-6, offload=False)

    run_threads(16, worker)
    assert len(reg) == 1
    assert all(p is got[0] for p in got)
    assert got[0].calls == 16


# --------------------------------------------------------------------- #
# faults + breaker under concurrency                                     #
# --------------------------------------------------------------------- #
def test_fault_injector_counter_walk_is_atomic():
    inj = flt.FaultInjector.from_spec("kernel:nth=5")
    per, nth = 100, 8
    fired = []
    lock = threading.Lock()

    def worker(idx):
        mine = 0
        for _ in range(per):
            try:
                inj.check("kernel")
            except flt.KernelError:
                mine += 1
        with lock:
            fired.append(mine)

    run_threads(nth, worker)
    assert sum(fired) == (per * nth) // 5
    assert inj.injected["kernel"] == (per * nth) // 5


def test_health_tracker_no_lost_failures():
    h = flt.HealthTracker(1, threshold=0)
    per, nth = 200, 8

    def worker(idx):
        for _ in range(per):
            h.failure(0)

    run_threads(nth, worker)
    assert h.device(0).failures == per * nth


def test_breaker_trips_once_per_quarantine_under_contention():
    trips, recovers = [], []
    h = flt.HealthTracker(1, threshold=3, cooldown_ms=1e9,
                          on_quarantine=trips.append,
                          on_recover=recovers.append)

    def worker(idx):
        for _ in range(10):
            h.failure(0)

    run_threads(8, worker)
    assert h.device(0).quarantines == 1
    assert len(trips) == 1
    assert not h.usable(0)
    h.ok(0)
    assert h.usable(0) and len(recovers) == 1


def test_chaos_and_concurrency_live_matches_serialized_replay():
    """8 threads run under an injected fault spec; each session's live
    fault counters equal a serialized replay of its own trace."""
    nth = 8
    cfg = OffloadConfig(policy="dfu", threshold=10.0,
                        faults="transfer:p=0.05,seed=7", retries=1,
                        backoff_ms=0.0, breaker=0)
    live = {}
    lock = threading.Lock()

    def worker(idx):
        with _open(cfg, record_trace=True, name=f"chaos-{idx}") as s:
            mats = _mats(idx, count=24, n=32)
            for i in range(0, 24, 2):
                blas.gemm(mats[i], mats[i + 1])
            s.sync()
            st = s.stats
            with lock:
                live[f"chaos-{idx}"] = (
                    s.runtime.trace,
                    (st.faults, st.retries, st.fallbacks, st.quarantines,
                     st.recoveries))

    run_threads(nth, worker)
    assert len(live) == nth
    assert sum(counts[0] for _, counts in live.values()) > 0
    for name, (trace, counts) in live.items():
        rep = MemTierSimulator.from_config(cfg, session=name).run(trace)
        assert (rep.faults, rep.retries, rep.fallbacks, rep.quarantines,
                rep.recoveries) == counts, name
        assert rep.session == name


# --------------------------------------------------------------------- #
# session-stamped traces                                                 #
# --------------------------------------------------------------------- #
def test_trace_events_carry_session_id():
    cfg = OffloadConfig(policy="dfu", threshold=10.0)
    with _open(cfg, record_trace=True, name="tenant-a") as s:
        a, b, _ = _mats(5)
        blas.gemm(a, b)
        s.sync()
        trace = s.runtime.trace
        assert trace.event_count("place") > 0
        assert all(e.session == "tenant-a" for e in trace.events)
        assert trace.event_count("place", session="tenant-a") == \
            trace.event_count("place")
        assert trace.event_count("place", session="other") == 0


def test_unnamed_session_trace_dump_is_pre_tenant_identical(tmp_path):
    path = str(tmp_path / "t.json")
    cfg = OffloadConfig(policy="dfu", threshold=10.0, trace_path=path)
    with _open(cfg, record_trace=True):
        a, b, _ = _mats(6)
        blas.gemm(a, b)
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["events"]
    assert all("session" not in e for e in doc["events"])
    t2 = Trace.load(path)
    assert all(e.session == "" for e in t2.events)

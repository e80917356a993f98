"""The port's multi-device tile scheduler against the JAX reference's.

The same numpy operands go through ``repro_torch`` (``device="cpu"``,
``OffloadConfig(devices=n)``: simulated tiers) and ``repro`` (the same
config, on its single-kind simulated tiers — this JAX's CPU backend has
several memory kinds, where the reference refuses host-born operands in
one op).  Each test of ``tests/test_multidevice.py`` is ported with the
golden values it asserts, and checked against the reference live:

* tier enumeration and ``put_block``'s device-index tag;
* gemm, syrk/herk, syr2k/her2k (with and without C), trsm, symm and trmm
  tiles against the port's single-tier path and the reference's tiles;
* the trace's ``(routine, m, n, k, devices)`` and the per-tier
  ``(tiles, moved_bytes, affinity_hits, evictions)`` against a live
  reference session;
* round-robin on first use, affinity on reuse, the tie-break on a chained
  grid, memcopy staging, per-tier cap evictions and none without a cap;
* calls too small, batched or singleton-batched, and under ``counter``,
  stay unsharded; the per-device report;
* tiles on the ``pallas`` venue (the gemm kernel's entry, syrk as the
  masked full product on it, trsm on the trsm kernel's) and under
  ``precision="split3"``;
* the port's dump replayed by both packages' memtier simulators.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import blas as jblas  # noqa: E402
from repro.core import memspace as jms  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402
from repro.core.policy import host_array as jhost  # noqa: E402
from repro.core.session import Session as JSession  # noqa: E402
from repro.core.trace import Trace as JTrace  # noqa: E402
from repro.memtier.simulator import MemTierSimulator as JSim  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, memspace  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402
from repro_torch.core.policy import host_array  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.trace import Trace  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.memtier import MemTierSimulator  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)


def _mat(seed, n, dtype="float32", m=None):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    x = rng.standard_normal((m, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((m, n))
    return x.astype(dtype)


@contextlib.contextmanager
def _ref_simulated():
    """The reference on its simulated tiers for the ``with`` block."""
    probe = jms.probe

    def simulated(device=None, n_devices=None):
        sp = probe(device, n_devices)
        return jms.MemSpace(host_kind=sp.device_kind,
                            device_kind=sp.device_kind, simulated=True,
                            backend=sp.backend, n_devices=sp.n_devices)

    jms.probe = simulated
    jms.reset()
    try:
        yield
    finally:
        jms.probe = probe
        jms.reset()


def _counters(stats, trace):
    """What both packages must agree on: per-routine sharding and
    movement, the per-tier tuple, and the trace's call stream."""
    per_routine = {name: (r.calls, r.offloaded, r.on_host, r.sharded,
                          r.tiles, r.bytes_in, r.bytes_out, r.cache_hits,
                          r.cache_misses)
                   for name, r in sorted(stats.per_routine.items())}
    per_device = {d: (v.tiles, v.moved_bytes, v.affinity_hits, v.evictions)
                  for d, v in sorted(stats.per_device.items())}
    calls = ([(c.routine, c.m, c.n, c.k, tuple(c.devices))
              for c in trace.calls] if trace is not None else None)
    return per_routine, per_device, calls


def _run(pkg, cfg_kw, body):
    """``body(blas, host_array)`` inside one session of ``pkg``; returns
    its result as numpy plus the counters."""
    if pkg == "port":
        with Session(OffloadConfig(**cfg_kw), device="cpu",
                     intercept=False) as s:
            out = body(blas, host_array)
            got = (np.asarray(out.numpy()) if out is not None else None,
                   _counters(s.stats, s.trace), s.runtime)
        return got
    with _ref_simulated():
        with JSession(JConfig(**cfg_kw), intercept=False) as s:
            out = body(jblas, jhost)
            return (np.asarray(out) if out is not None else None,
                    _counters(s.runtime.stats, s.runtime.trace), s.runtime)


_REF_CACHE = {}


def _ref(case, cfg_kw, body):
    """The reference's run of one case, computed once per module."""
    if case not in _REF_CACHE:
        out, counters, _ = _run("reference", cfg_kw, body)
        _REF_CACHE[case] = (out, counters)
    return _REF_CACHE[case]


def _tiles_vs_single(case, body, n_dev=4, threshold=50.0, policy="dfu"):
    """The port on one tier and on ``n_dev`` tiers, and the reference on
    ``n_dev`` tiers: results and counters."""
    one, _, _ = _run("port", dict(policy=policy, threshold=threshold),
                     body)
    got, counters, rt = _run("port", dict(policy=policy,
                                          threshold=threshold,
                                          devices=n_dev), body)
    ref_out, ref_counters = _ref(case, dict(policy=policy,
                                            threshold=threshold,
                                            devices=n_dev), body)
    np.testing.assert_allclose(got, one, **TOL)
    np.testing.assert_allclose(got, ref_out, **TOL)
    assert counters == ref_counters
    return counters, rt


# --------------------------------------------------------------------- #
# tier enumeration                                                       #
# --------------------------------------------------------------------- #
def test_devices_enumerates_simulated_tiers(monkeypatch):
    with Session(OffloadConfig(devices=4), device="cpu",
                 intercept=False) as s:
        assert memspace.active().n_devices == memspace.n_devices() == 4
        assert s.runtime.n_devices == 4
        assert len(s.runtime.block_stores) == 4
    with Session(OffloadConfig(), device="cpu", intercept=False) as s:
        assert s.runtime.n_devices == 1
    monkeypatch.setenv("SCILIB_DEVICES", "3")
    assert OffloadConfig.from_env().resolved_devices() == 3


def test_put_block_tags_device_index():
    with Session(OffloadConfig(devices=3), device="cpu", intercept=False):
        x = host_array(_mat(0, 64))
        y = memspace.put_block(x, 2)
        assert memspace.tier_of(y) == memspace.DEVICE
        assert memspace.device_of(y) == 2
        assert memspace.device_of(x) is None      # host-resident source
        assert memspace.put_block(y, 2) is y      # same home is identity
        z = memspace.put_block(y, 1)              # another tier: a copy
        assert z is not y and memspace.device_of(z) == 1
        # an untagged device-born tensor has no tier index on one card
        d = torch.ones(4, 4)
        assert memspace.device_of(d) is None
        assert memspace.put_block(d, 0) is not d


def test_close_releases_placements_and_blocks():
    """Closing a session drops its placements and tile blocks at once:
    on the card their copies are freed then, not when the runtime's
    reference cycles are collected."""
    a, small = host_array(_mat(36, 384)), host_array(_mat(37, 96))
    s = Session(OffloadConfig(policy="dfu", threshold=50.0, devices=4),
                device="cpu", intercept=False).open()
    blas.gemm(a, a)                  # sharded: tile blocks per tier
    blas.gemm(small, small)          # under tile_min: a placement
    rt = s.runtime
    assert sum(rt.device_resident_bytes(d) for d in range(4)) > 0
    assert rt.placements.resident_bytes > 0
    s.close()
    assert rt.placements.resident_bytes == 0 and len(rt.placements) == 0
    assert all(rt.device_resident_bytes(d) == 0 for d in range(4))
    assert rt.stats.per_routine["sgemm"].sharded == 1


# --------------------------------------------------------------------- #
# tile decomposition correctness vs the single-tier path                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "complex64"])
@pytest.mark.parametrize("trans_a,trans_b", [("N", "N"), ("T", "N"),
                                             ("N", "T")])
def test_gemm_tiles_match_single_device(dtype, trans_a, trans_b):
    a, b, c = (_mat(s, 384, dtype) for s in (1, 2, 3))

    def body(bl, host):
        return bl.gemm(host(a), host(b), host(c), alpha=1.5, beta=0.5,
                       trans_a=trans_a, trans_b=trans_b)

    counters, _ = _tiles_vs_single(("gemm", dtype, trans_a, trans_b), body)
    per_routine, per_device, _ = counters
    pre = "s" if dtype == "float32" else "c"
    _, _, _, sharded, tiles, *_ = per_routine[pre + "gemm"]
    assert sharded == 1 and tiles >= 4
    assert len(per_device) == 4
    assert all(t >= 1 and moved > 0 for t, moved, _, _ in
               per_device.values())


@pytest.mark.parametrize("dtype,conj", [("float32", False),
                                        ("complex64", False),
                                        ("complex64", True)])
@pytest.mark.parametrize("uplo,trans", [("L", "N"), ("U", "T")])
def test_syrk_tiles_match_single_device(dtype, conj, uplo, trans):
    a, c = _mat(4, 360, dtype), _mat(5, 360, dtype)

    def body(bl, host):
        routine = bl.herk if conj else bl.syrk
        return routine(host(a), host(c), uplo=uplo, trans=trans,
                       alpha=1.25, beta=0.75)

    counters, _ = _tiles_vs_single(("syrk", dtype, conj, uplo, trans), body)
    pre = "s" if dtype == "float32" else "c"
    _, _, _, sharded, tiles, *_ = counters[0][pre + ("herk" if conj
                                                     else "syrk")]
    assert sharded == 1 and tiles >= 4      # g=3: 6 stored-tri tiles


@pytest.mark.parametrize("dtype,conj", [("float32", False),
                                        ("complex64", False),
                                        ("complex64", True)])
@pytest.mark.parametrize("uplo,trans", [("L", "N"), ("U", "T")])
def test_syr2k_tiles_match_single_device(dtype, conj, uplo, trans):
    a, b, c = (_mat(s, 360, dtype) for s in (6, 7, 8))

    def body(bl, host):
        routine = bl.her2k if conj else bl.syr2k
        return routine(host(a), host(b), host(c), uplo=uplo, trans=trans,
                       alpha=1.25, beta=0.75)

    counters, _ = _tiles_vs_single(("syr2k", dtype, conj, uplo, trans),
                                   body)
    pre = "s" if dtype == "float32" else "c"
    _, _, _, sharded, tiles, *_ = counters[0][pre + ("her2k" if conj
                                                     else "syr2k")]
    assert sharded == 1 and tiles >= 4
    assert len(counters[1]) == 4


def test_syr2k_no_c_tiles_match_single_device():
    a, b = _mat(9, 360), _mat(10, 360)

    def body(bl, host):
        return bl.syr2k(host(a), host(b), uplo="L", alpha=0.5)

    counters, _ = _tiles_vs_single(("syr2k-noc",), body)
    assert counters[0]["ssyr2k"][3] == 1


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
@pytest.mark.parametrize("side", ["L", "R"])
def test_trsm_tiles_match_single_device(dtype, side):
    n = 384
    lower = np.tril(_mat(11, n, dtype)) + n * np.eye(n, dtype=dtype)
    b = _mat(12, n, dtype)

    def body(bl, host):
        return bl.trsm(host(lower), host(b), side=side, uplo="L",
                       alpha=2.0)

    counters, _ = _tiles_vs_single(("trsm", dtype, side), body)
    pre = "s" if dtype == "float32" else "c"
    _, _, _, sharded, tiles, *_ = counters[0][pre + "trsm"]
    assert sharded == 1 and tiles == 4      # 4 independent panels


@pytest.mark.parametrize("routine", ["symm", "trmm"])
def test_symm_trmm_tiles_match_single_device(routine):
    a, b = _mat(13, 384), _mat(14, 384)

    def body(bl, host):
        if routine == "symm":
            return bl.symm(host(a), host(b), side="L", uplo="U", alpha=1.5)
        return bl.trmm(host(np.tril(a)), host(b), side="R", uplo="L",
                       alpha=0.5)

    counters, _ = _tiles_vs_single((routine,), body)
    assert counters[0]["s" + routine][3] == 1


def _unsharded(case, body, n_dev, threshold, policy="dfu"):
    got, counters, _ = _run("port", dict(policy=policy, threshold=threshold,
                                         devices=n_dev), body)
    ref_out, ref_counters = _ref(case, dict(policy=policy,
                                            threshold=threshold,
                                            devices=n_dev), body)
    np.testing.assert_allclose(got, ref_out, **TOL)
    assert counters == ref_counters
    return got, counters


def test_small_matrix_falls_back_to_single_device():
    """Below tile_min per tile edge the plan builder declines and the
    call takes the unsharded offload path."""
    a = _mat(15, 96)
    got, counters = _unsharded(
        ("small",), lambda bl, host: bl.gemm(host(a), host(a)), 4, 10.0)
    calls, offloaded, _, sharded, *_ = counters[0]["sgemm"]
    assert (offloaded, sharded) == (1, 0)
    np.testing.assert_allclose(got, a @ a, **TOL)


@pytest.mark.parametrize("lead", [3, 1], ids=["batched", "singleton"])
def test_batched_calls_not_sharded(lead):
    """A leading batch axis — even a singleton one — uses the batched
    kernels: 2-D tile coordinates must not address it."""
    x = np.random.default_rng(16).standard_normal(
        (lead, 256, 256)).astype("float32")
    got, counters = _unsharded(
        ("batched", lead), lambda bl, host: bl.gemm(host(x), host(x)),
        4 if lead > 1 else 2, 10.0)
    _, offloaded, _, sharded, *_ = counters[0]["sgemm"]
    assert (offloaded, sharded) == (1, 0)
    np.testing.assert_allclose(got, x @ x, **TOL)


def test_counter_policy_never_sharded():
    """R1-R4 are per-operand host-vs-device rules: sharding would turn
    the access-counter model into DFU, so it stays single-device."""
    a = _mat(17, 512)
    _, counters = _unsharded(
        ("counter",), lambda bl, host: bl.gemm(host(a), host(a), host(a)),
        4, 50.0, policy="counter")
    _, offloaded, _, sharded, *_ = counters[0]["sgemm"]
    assert (offloaded, sharded) == (1, 0)
    assert counters[1] == {}


# --------------------------------------------------------------------- #
# round-robin with affinity                                              #
# --------------------------------------------------------------------- #
def _same_as_reference(case, cfg_kw, body):
    _, counters, rt = _run("port", cfg_kw, body)
    assert counters == _ref(case, cfg_kw, body)[1]
    return counters, rt


def test_first_call_spreads_round_robin():
    a = _mat(18, 512)
    counters, _ = _same_as_reference(
        ("rr",), dict(policy="dfu", threshold=50.0, devices=4),
        lambda bl, host: bl.gemm(host(a), host(a)))
    assert sorted(counters[1]) == [0, 1, 2, 3]
    assert [v[0] for v in counters[1].values()] == [1, 1, 1, 1]
    assert counters[2][0][4] == (0, 1, 2, 3)


def test_affinity_reuses_resident_blocks():
    a, b = _mat(19, 512), _mat(20, 512)
    moved = []

    def body(bl, host):
        ha, hb = host(a), host(b)
        bl.gemm(ha, hb)
        moved.append(sum(v.moved_bytes for v in
                         bl.rt.active().stats.per_device.values()))
        return bl.gemm(ha, hb)

    counters, _ = _same_as_reference(
        ("affinity",), dict(policy="dfu", threshold=50.0, devices=4), body)
    # every block of every tile was resident on the tile's tier: zero
    # new movement, and the schedule is stable
    assert moved[0] == moved[1] and moved[0] > 0
    assert all(v[2] >= 2 for v in counters[1].values())
    assert counters[2][0][4] == counters[2][1][4]


def test_tie_break_spreads_chained_grid():
    """Chained 2-D grids replicate A row blocks across tiers; the
    scheduled-load tie-breaker keeps all tiers busy."""
    a = _mat(21, 512) / 512

    def body(bl, host):
        ha = host(a)
        c = ha
        for _ in range(4):
            c = bl.gemm(ha, c)
        return c

    counters, _ = _same_as_reference(
        ("chain",), dict(policy="dfu", threshold=50.0, devices=4), body)
    tiles = [v[0] for v in counters[1].values()]
    assert len(tiles) == 4
    assert all(t >= 2 for t in tiles), tiles   # 16 tiles, nobody idle


def test_memcopy_stages_every_call_round_robin():
    """Non-persistent staging: no affinity, movement every call."""
    a, b = _mat(22, 512), _mat(23, 512)

    def body(bl, host):
        ha, hb = host(a), host(b)
        bl.gemm(ha, hb)
        return bl.gemm(ha, hb)

    counters, _ = _same_as_reference(
        ("memcopy",), dict(policy="memcopy", threshold=50.0, devices=4),
        body)
    _, _, _, _, _, bytes_in, bytes_out, *_ = counters[0]["sgemm"]
    assert bytes_in == 2 * 4 * (2 * 256 * 512 * 4)
    assert all(v[2] == 0 for v in counters[1].values())
    assert bytes_out > 0             # gathered outputs bounce to host


# --------------------------------------------------------------------- #
# per-tier byte caps                                                     #
# --------------------------------------------------------------------- #
def test_per_device_byte_cap_evicts_lru_blocks():
    cap = int(1.8e6)
    a = _mat(24, 512) / 512

    def body(bl, host):
        ha = host(a)
        chain = [ha]    # every link stays alive, so do its blocks
        for _ in range(8):
            chain.append(bl.gemm(ha, chain[-1]))
        c = chain[-1]
        rt = bl.rt.active()
        assert all(rt.device_resident_bytes(d) <= cap
                   for d in range(rt.n_devices))
        return c

    counters, _ = _same_as_reference(
        ("cap",), dict(policy="dfu", threshold=50.0, devices=2,
                       device_bytes=cap), body)
    assert any(v[3] > 0 for v in counters[1].values())


def test_no_cap_no_device_evictions():
    a = _mat(25, 512)
    counters, _ = _same_as_reference(
        ("nocap",), dict(policy="dfu", threshold=50.0, devices=2),
        lambda bl, host: bl.gemm(host(a), host(a)))
    assert all(v[3] == 0 for v in counters[1].values())


# --------------------------------------------------------------------- #
# report / single-tier invariance / trace                                #
# --------------------------------------------------------------------- #
def test_report_shows_per_device_counters():
    a = _mat(26, 512)
    with Session(OffloadConfig(policy="dfu", threshold=50.0, devices=4),
                 device="cpu", intercept=False) as s:
        blas.gemm(host_array(a), host_array(a))
        rep = s.report()
    for frag in ("device", "dev0", "dev3", "GB moved", "affinity"):
        assert frag in rep, rep


def test_single_device_path_has_no_shard_state():
    a = _mat(27, 512)
    with Session(OffloadConfig(policy="dfu", threshold=50.0),
                 device="cpu", intercept=False) as s:
        blas.gemm(host_array(a), host_array(a))
        st = s.stats.per_routine["sgemm"]
        assert s.runtime.n_devices == 1
        assert st.sharded == 0 and st.tiles == 0
        assert s.stats.per_device == {}
        assert s.trace.calls[0].devices == ()


def test_trace_devices_roundtrip_and_replay(tmp_path):
    """The port's dump loads in both packages with its tile schedule,
    and both memtier simulators replay it to the same report."""
    a = _mat(28, 512)
    cfg = OffloadConfig(policy="dfu", threshold=50.0, devices=4)
    with Session(cfg, device="cpu", intercept=False) as s:
        ha = host_array(a)
        for _ in range(3):
            blas.gemm(ha, ha)
        live = s.trace.calls[0].devices
        offloaded = s.stats.per_routine["sgemm"].offloaded
        tiles = {d: v.tiles for d, v in s.stats.per_device.items()}
        path = str(tmp_path / "trace.json")
        s.trace.dump(path)
    loaded, jloaded = Trace.load(path), JTrace.load(path)
    assert loaded.calls[0].devices == live == tuple(
        jloaded.calls[0].devices)
    assert len(live) == 4
    counted = {}
    for call in loaded.calls:
        for d in call.devices:
            counted[d] = counted.get(d, 0) + 1
    assert counted == tiles
    rep = MemTierSimulator.from_config(cfg).run(loaded)
    jrep = JSim.from_config(JConfig(policy="dfu", threshold=50.0,
                                    devices=4)).run(jloaded)
    assert rep.n_devices == jrep.n_devices == 4
    assert rep.offloaded_calls == jrep.offloaded_calls == offloaded
    assert rep.per_device_h2d == jrep.per_device_h2d
    assert rep.bytes_host_to_dev == jrep.bytes_host_to_dev


def _big_trace(trace_cls):
    t = trace_cls()
    a = t.new_buffer(4000 * 4000 * 8, "A")
    b = t.new_buffer(4000 * 4000 * 8, "B")
    c = t.new_buffer(4000 * 4000 * 8, "C")
    for _ in range(3):
        t.gemm("d", 4000, 4000, 4000, a, b, c)
    return t


def test_simulator_multidevice_dfu_scales():
    one = MemTierSimulator(policy="dfu", threshold=500).run(
        _big_trace(Trace))
    four = MemTierSimulator(policy="dfu", threshold=500,
                            n_devices=4).run(_big_trace(Trace))
    assert four.n_devices == 4
    assert four.blas_device_s < one.blas_device_s
    assert four.total_s < one.total_s
    assert four.bytes_host_to_dev == one.bytes_host_to_dev
    assert sum(four.per_device_h2d.values()) == four.bytes_host_to_dev
    assert len(four.per_device_h2d) >= 2
    jfour = JSim(policy="dfu", threshold=500, n_devices=4).run(
        _big_trace(JTrace))
    assert jfour.per_device_h2d == four.per_device_h2d
    assert jfour.total_s == four.total_s


def test_simulator_single_device_unchanged_by_field():
    """``tests/test_multidevice.py:402``: one device keeps no per-device
    table, in both packages."""
    rep = MemTierSimulator(policy="dfu", threshold=500).run(
        _big_trace(Trace))
    assert rep.n_devices == 1 and rep.per_device_h2d == {}
    jrep = JSim(policy="dfu", threshold=500).run(_big_trace(JTrace))
    assert jrep.n_devices == 1 and jrep.per_device_h2d == {}
    assert jrep.total_s == rep.total_s


def _overflow(trace_cls):
    t = trace_cls()
    bufs = [t.new_buffer(60 << 20, f"B{i}") for i in range(3)]
    for i in range(3):
        t.gemm("d", 3000, 3000, 3000, bufs[i], bufs[i], bufs[(i + 1) % 3])
    return t


def test_simulator_multidevice_honors_evict_lru():
    """``tests/test_multidevice.py:408``: a working set beyond one
    device's 96 MB of HBM; without ``evict_lru`` the overflow buffer
    stays remote, with it LRU residents bounce to the host; the port's
    simulator moves the reference's bytes either way."""
    from repro.memtier.spec import GH200 as JGH200
    from repro_torch.memtier import GH200
    reps = {}
    for name, sim, spec, trace_cls in (
            ("port", MemTierSimulator, GH200, Trace),
            ("ref", JSim, JGH200, JTrace)):
        tiny = spec.with_(device_capacity=96 << 20)
        reps[name] = [sim(tiny, policy="dfu", threshold=100, n_devices=2,
                          evict_lru=evict).run(_overflow(trace_cls))
                      for evict in (False, True)]
    for keep, evict in reps.values():
        assert keep.bytes_dev_to_host == 0
        assert evict.bytes_dev_to_host > 0
        assert evict.bytes_host_to_dev > keep.bytes_host_to_dev
    for port, ref in zip(reps["port"], reps["ref"]):
        assert (port.bytes_host_to_dev, port.bytes_dev_to_host,
                port.per_device_h2d) == (ref.bytes_host_to_dev,
                                         ref.bytes_dev_to_host,
                                         ref.per_device_h2d)


# --------------------------------------------------------------------- #
# the pallas venue and split precision on tiles                          #
# --------------------------------------------------------------------- #
@pytest.fixture
def spy(monkeypatch):
    """Counts the kernel entry points the tiles call."""
    calls = {"kernel_matmul": 0, "kernel_trsm": 0}

    def counting(name):
        orig = getattr(kops, name)

        def wrapped(*args, **kw):
            calls[name] += 1
            return orig(*args, **kw)
        monkeypatch.setattr(kops, name, wrapped)

    counting("kernel_matmul")
    counting("kernel_trsm")

    def refused(*args, **kw):
        raise AssertionError("syrk tiles must not run the syrk kernel")
    monkeypatch.setattr(kops, "kernel_syrk", refused)
    return calls


def test_sharded_tiles_route_through_pallas_venue(spy):
    """Tiles run on the call's venue: gemm tiles on the gemm kernel's
    entry, syrk tiles as the masked full product on it (never the syrk
    kernel), trsm panels on the trsm kernel's; same numerics, the venue
    tag recorded, the tiles spread over the tiers."""
    kw = dict(policy="dfu", threshold=10.0, kernel_path=True, devices=4,
              tile_min=32)
    a, b = _mat(29, 256), _mat(30, 256)
    lower = np.tril(_mat(31, 256)) + 256 * np.eye(256, dtype="float32")

    def body(bl, host):
        ha, hb = host(a), host(b)
        g = bl.gemm(ha, hb)
        s = bl.syrk(ha, uplo="U")
        x = bl.trsm(host(lower), hb)
        return bl.gemm(g, bl.gemm(s, x))

    got, counters, _ = _run("port", kw, body)
    ref_out, ref_counters = _ref(("pallas",), kw, body)
    np.testing.assert_allclose(got, ref_out, rtol=1e-3, atol=1e-3)
    assert counters == ref_counters
    calls = counters[2]
    assert all(len(set(c[4])) > 1 for c in calls)
    # 4 gemm calls x 4 tiles, 6 syrk triangle tiles, on the gemm kernel
    assert spy["kernel_matmul"] == 3 * 4 + 6
    assert spy["kernel_trsm"] == 4
    with Session(OffloadConfig(**kw), device="cpu", intercept=False) as s:
        blas.gemm(host_array(a), host_array(b))
        assert s.trace.calls[-1].venue == "pallas"


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_split3_tiles_on_the_pallas_venue(x64):
    """``precision="split3"`` on the pallas venue: the tiles run the
    fused split product, the call is tagged split3 and stays within the
    scheme's bound against native fp64."""
    kw = dict(policy="dfu", threshold=10.0, kernel_path=True, devices=4,
              tile_min=32, precision="split3")
    a, b = _mat(32, 256, "float64"), _mat(33, 256, "float64")

    def body(bl, host):
        return bl.gemm(host(a), host(b))

    got, counters, rt = _run("port", kw, body)
    ref_out, ref_counters = _ref(("split3",), kw, body)
    assert counters == ref_counters
    # within the scheme's a-priori normwise bound, as the runtime's
    # residual check holds it (core/precision.py:error_bound)
    from repro_torch.core import precision as prc
    want = a @ b
    bound = prc.error_bound("split3", 256) * np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= bound
    assert np.max(np.abs(ref_out - want)) <= bound
    st = rt.stats.per_routine["dgemm"]
    assert (st.sharded, st.tiles, st.split_calls, st.kernel_calls) == \
        (1, 4, 1, 1)
    with Session(OffloadConfig(**kw), device="cpu", intercept=False) as s:
        blas.gemm(host_array(a), host_array(b))
        call = s.trace.calls[-1]
        assert (call.venue, call.precision) == ("pallas", "split3")


def test_tile_faults_retry_on_their_tier():
    """Kernel faults injected into tile units retry on the same tier:
    the same tiles, the same results, the same counters as the
    reference's faulted run."""
    kw = dict(policy="dfu", threshold=50.0, devices=4,
              faults="kernel:nth=3;transfer:nth=5", retries=2,
              backoff_ms=0.0)
    a, b = _mat(34, 384), _mat(35, 384)

    def body(bl, host):
        bl.gemm(host(a), host(b))
        return bl.gemm(host(a), host(b))

    got, counters, rt = _run("port", kw, body)
    clean, clean_counters, _ = _run("port", dict(policy="dfu",
                                                 threshold=50.0,
                                                 devices=4), body)
    assert np.array_equal(got, clean)
    assert counters == clean_counters
    assert rt.stats.retries == rt.stats.faults > 0
    assert rt.stats.fallbacks == 0
    ref_out, ref_counters = _ref(("tile-faults",), kw, body)
    assert counters == ref_counters
    np.testing.assert_allclose(got, ref_out, **TOL)


def test_repro_torch_exports_the_runtime_names():
    from repro_torch.core import residency
    assert repro_torch.SharedDevicePool is residency.SharedDevicePool
    try:
        assert repro_torch.default_pool() is repro_torch.default_pool()
    finally:
        residency.reset_default_pool()
    assert callable(repro_torch.faults.classify)
    from repro_torch import core
    assert core.faults is repro_torch.faults

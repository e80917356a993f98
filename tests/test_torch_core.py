"""The port's backend-free core against the JAX reference: config and its
env names, threshold rule, trace schema, residency engine, call sites,
and every config field reaching a live session."""
import dataclasses
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core import residency as jres  # noqa: E402
from repro.core import threshold as jthr  # noqa: E402
from repro.core.trace import Trace as JTrace  # noqa: E402
from repro.memtier import MemTierSimulator  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, host_array  # noqa: E402
from repro_torch.core import config as tcfg  # noqa: E402
from repro_torch.core import residency as tres  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import threshold as tthr  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402


@pytest.fixture
def clean_env(monkeypatch):
    for var in list(os.environ):
        if var.startswith("SCILIB_"):
            monkeypatch.delenv(var)
    return monkeypatch


#: one sample value per field: (env string, parsed field value); the same
#: samples as tests/test_config_session.py
MATRIX = {
    "policy": ("memcopy", "memcopy"),
    "threshold": ("123.5", 123.5),
    "sync": ("1", True),
    "adaptive": ("1", True),
    "adaptive_warmup": ("4", 4),
    "callsite": ("0", False),
    "dispatch_cache": ("0", False),
    "devices": ("3", 3),
    "device_bytes": ("1048576", 1048576),
    "tile_min": ("32", 32),
    "evict": ("lfu", "lfu"),
    "pin": ("never-evict", True),
    "trace_path": ("/tmp/trace.json", "/tmp/trace.json"),
    "debug": ("2", 2),
    "faults": ("transfer:p=0.5,seed=3", "transfer:p=0.5,seed=3"),
    "retries": ("4", 4),
    "backoff_ms": ("2.5", 2.5),
    "breaker": ("5", 5),
    "breaker_cooldown_ms": ("250", 250.0),
    "pool_bytes": ("4194304", 4194304),
    "pool_quota": ("1048576", 1048576),
    "kernel_path": ("1", True),
    "kernel_block": ("256", 256),
    "precision": ("split2", "split2"),
    "precision_rtol": ("1e-5", 1e-5),
    "lapack": ("1", True),
    "lapack_nb": ("96", 96),
}


def test_config_fields_and_env_names_match_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(OffloadConfig)]
    jfields = [(f.name, f.default)
               for f in dataclasses.fields(jcfg.OffloadConfig)]
    assert fields == jfields
    assert tcfg.ENV_FIELDS == jcfg.ENV_FIELDS
    assert tcfg.KNOWN_ENV_VARS == jcfg.KNOWN_ENV_VARS
    assert set(MATRIX) == {name for name, _ in fields}
    assert tcfg.PRESETS == jcfg.PRESETS


@pytest.mark.parametrize("field", sorted(MATRIX))
def test_env_field_parses_like_reference(field, clean_env, tmp_path):
    """Every SCILIB_* name parses to the same value in both packages, and
    a file saved by either loads in the other."""
    raw, want = MATRIX[field]
    clean_env.setenv(tcfg.ENV_FIELDS[field], raw)
    cfg = OffloadConfig.from_env()
    jc = jcfg.OffloadConfig.from_env()
    assert getattr(cfg, field) == want == getattr(jc, field)
    assert cfg.to_dict() == jc.to_dict()
    assert cfg.env() == jc.env()
    cfg.save(str(tmp_path / "port.json"))
    jc.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert jcfg.OffloadConfig.load(str(tmp_path / "port.json")) == jc
    assert OffloadConfig.load(str(tmp_path / "ref.json")) == cfg


@pytest.mark.parametrize("raw", ["transfer", "bogus:p=0.1", "kernel:p=2",
                                 "oom:nth=0", "latency:ms=-1",
                                 "transfer:p=0.1,zap=1", "kernel:nth"])
def test_malformed_fault_spec_rejected_like_reference(raw):
    with pytest.raises(ValueError):
        jcfg.OffloadConfig(faults=raw)
    with pytest.raises(ValueError):
        OffloadConfig(faults=raw)


def test_malformed_env_values_fall_back_like_reference(clean_env):
    for var, raw in (("SCILIB_THRESHOLD", "-3"), ("SCILIB_EVICT", "typo"),
                     ("SCILIB_FAULTS", "nope:p=1")):
        clean_env.setenv(var, raw)
    with pytest.warns(UserWarning):
        cfg = OffloadConfig.from_env()
    with pytest.warns(UserWarning):
        jc = jcfg.OffloadConfig.from_env()
    assert cfg.to_dict() == jc.to_dict() == OffloadConfig().to_dict()


def test_threshold_rule_matches_reference():
    rng = np.random.default_rng(3)
    for routine in ("sgemm", "dtrsm", "zsyrk", "cher2k", "dsymm", "sgemv"):
        for _ in range(20):
            m, n, k, batch = (int(v) for v in rng.integers(1, 900, 4))
            assert (tthr.should_offload(routine, m, n, k, batch=batch)
                    == jthr.should_offload(routine, m, n, k, batch=batch))
    navs = rng.uniform(10, 2000, 30)
    assert tthr.threshold_grid(navs) == jthr.threshold_grid(navs)
    assert tthr.detect_device_key("gpu", "NVIDIA H100 80GB HBM3") == "gpu"
    assert tthr.DEVICE_DEFAULTS == jthr.DEVICE_DEFAULTS


@pytest.mark.parametrize("policy", ["lru", "lfu", "refetch"])
def test_residency_store_evicts_like_reference(policy):
    """The same put/get/pin script through both stores: the same victims,
    counters and events."""
    rng = np.random.default_rng(5)
    events = {"port": [], "ref": []}
    stores = {
        "port": tres.ResidencyStore("s", cap=1000, policy=policy,
                                    emit=lambda *e: events["port"].append(e)),
        "ref": jres.ResidencyStore("s", cap=1000, policy=policy,
                                   emit=lambda *e: events["ref"].append(e)),
    }
    for step in range(300):
        op, key = int(rng.integers(0, 6)), int(rng.integers(0, 12))
        size = int(rng.integers(50, 400))
        for s in stores.values():
            if op == 0:
                s.get(key)
            elif op == 3 and step % 7 == 0:
                s.pin(key)
            elif op == 4:
                s.reserve(size, evict=step % 2 == 0)
            elif op == 5 and step % 25 == 0:
                s.evict_one() if step % 50 else s.evict_all()
            else:
                s.put(key, key, size)
    p, r = stores["port"], stores["ref"]
    assert list(p.keys()) == list(r.keys())
    for attr in ("resident_bytes", "places", "hits", "evictions",
                 "evicted_bytes", "refetches", "refetched_bytes"):
        assert getattr(p, attr) == getattr(r, attr), attr
    assert events["port"] == events["ref"]


def _capped_workload(pkg, n=128, mats=5, reps=3, cap_mats=2):
    """tests/test_residency.py's capped DFU workload, in either package."""
    rng = np.random.default_rng(42)
    arrays = [rng.standard_normal((n, n)).astype("float32")
              for _ in range(mats)]
    if pkg == "ref":
        cfg = jcfg.OffloadConfig(policy="dfu", threshold=10,
                                 device_bytes=cap_mats * n * n * 4)
        s = repro.session(cfg, intercept=False)
        xs = [jcore.host_array(x) for x in arrays]
        gemm = jcore.blas.gemm
    else:
        cfg = OffloadConfig(policy="dfu", threshold=10,
                            device_bytes=cap_mats * n * n * 4)
        s = repro_torch.session(cfg, device="cpu", intercept=False)
        xs = [host_array(x) for x in arrays]
        gemm = blas.gemm
    with s:
        outs = [gemm(x, x) for _ in range(reps) for x in xs]
        s.sync()
        rt = s.runtime
        stats = (rt.stats.evictions, rt.stats.evicted_bytes,
                 rt.stats.refetches, rt.stats.per_routine["sgemm"].bytes_in,
                 rt.stats.per_routine["sgemm"].cache_hits,
                 rt.stats.per_routine["sgemm"].cache_misses)
        return stats, rt.trace, outs


def test_capped_run_evicts_like_reference_and_replays(tmp_path):
    """The golden capped workload: the port's live eviction and refetch
    counts equal the reference's (28 evictions, 10 refetches), and its
    dumped trace replays through the reference simulator to the same."""
    got, trace, _ = _capped_workload("port")
    want, _, _ = _capped_workload("ref")
    assert got == want == (28, 1835008, 10, 983040, 15, 15)
    path = str(tmp_path / "capped.json")
    trace.dump(path)
    loaded = JTrace.load(path)
    assert loaded.event_count("evict") == 28
    rep = MemTierSimulator(policy="dfu", threshold=10,
                           device_bytes=2 * 128 * 128 * 4,
                           evict="lru").run(loaded)
    assert (rep.evictions, rep.refetches) == (28, 10)


def test_port_trace_loads_in_reference(tmp_path):
    rng = np.random.default_rng(1)
    with repro_torch.session(OffloadConfig(threshold=50.0),
                             device="cpu") as s:
        a = host_array(rng.standard_normal((80, 80)))
        b = host_array(rng.standard_normal((80, 60)))
        c = torch.matmul(a, b)
        blas.trsm(a.tril() + 80 * torch.eye(80, dtype=a.dtype), c)
        blas.syrk(a, uplo="U", trans="T")
        path = str(tmp_path / "t.json")
        s.trace.dump(path)
        calls = json.dumps([call.to_json() for call in s.trace])
        flops = s.trace.total_flops
    loaded = JTrace.load(path)
    assert [c.routine for c in loaded] == ["dgemm", "dtrsm", "dsyrk"]
    assert json.dumps([c.to_json() for c in loaded]) == calls
    assert loaded.total_flops == flops


def test_callsite_fingerprint_skips_port_frames():
    a = torch.ones((4, 4))
    with repro_torch.session(device="cpu") as s:
        torch.matmul(a, a)
        a @ a
        sites = sorted(p.site for p in s.runtime.callsites)
    assert len(sites) == 2
    assert all(site.startswith("sgemm@test_torch_core.py:"
                               "test_callsite_fingerprint_skips_port_frames:")
               for site in sites)


@pytest.mark.parametrize("field,value", [
    ("devices", 2), ("adaptive", True), ("kernel_path", True),
    ("kernel_block", 128), ("precision", "split2"), ("lapack", True),
    ("lapack_nb", 64), ("faults", "transfer:p=0.1"),
    ("pool_bytes", 1 << 20), ("pool_quota", 1 << 20)])
def test_unported_fields_raise_naming_the_roadmap_item(field, value):
    """Every field the port once refused now opens a session and reaches
    the live runtime; all but ``devices`` also reconfigure live, while a
    live ``devices`` change raises the reference's ``ValueError`` (the
    tier topology is fixed at open)."""
    tres.reset_default_pool()
    cfg = OffloadConfig(**{field: value})
    live = {
        "devices": lambda s: s.runtime.n_devices,
        "faults": lambda s: s.runtime.faults.rules,
        "pool_bytes": lambda s: s.runtime.pool.total_bytes,
        "pool_quota": lambda s: s.runtime.pool.quota_of(s.name),
        "lapack": lambda s: s.runtime.config.lapack,
        "lapack_nb": lambda s: s.runtime.config.lapack_nb,
    }.get(field, lambda s: getattr(s.runtime, field))
    want = (repro_torch.faults.parse_spec(value) if field == "faults"
            else value)
    try:
        with repro_torch.session(cfg, device="cpu") as s:
            assert live(s) == want
        with repro_torch.session(device="cpu") as s:
            if field == "devices":
                with pytest.raises(ValueError, match="devices cannot "
                                   "change on a live runtime"):
                    s.reconfigure(devices=value)
                assert s.config.devices is None and s.runtime.n_devices == 1
                return
            if field.startswith("pool"):
                # the pool is joined at open: a live change is kept in
                # the config and takes effect in the next session
                s.reconfigure(**{field: value})
                assert getattr(s.config, field) == value
                return
            s.reconfigure(**{field: value})
            assert live(s) == want
    finally:
        tres.reset_default_pool()


def test_fault_knobs_without_faults_are_accepted():
    cfg = OffloadConfig(retries=5, backoff_ms=3.0, breaker=0,
                        breaker_cooldown_ms=10.0, devices=1)
    with repro_torch.session(cfg, device="cpu") as s:
        assert s.config.retries == 5
        assert s.runtime.retry.attempts == 5
        assert s.runtime.health.threshold == 0
        assert s.runtime.faults is None
    pool = tres.SharedDevicePool(1 << 20)
    with repro_torch.session(device="cpu", pool=pool, name="t") as s:
        assert s.runtime.pool is pool and pool.members() == ("t",)
    assert pool.members() == ()
    assert not hasattr(trt, "UNPORTED_FIELDS")

"""The reference's public helpers in the port, held to the reference.

Each family of names below is public in ``src/repro/core/`` and has its
counterpart in ``src/repro_torch/core/`` with the reference's semantics;
each test calls both packages' helper under the same monkeypatched
``SCILIB_*`` environment, or after the same sequence of intercepted
calls, and compares the results:

* the environment wrappers, read through ``OffloadConfig.from_env``:
  ``residency.evict_policy_from_env`` and ``pin_all_from_env``,
  ``threshold.threshold_from_env``, ``memspace.device_bytes_from_env``;
* the memory kinds: ``MemSpace.kind_of`` on the card's tiers and on the
  simulated ones, ``policy.memory_kind_of``;
* ``RuntimeStats.reuse_ratio`` and ``dispatch_hit_ratio``;
* the resets and lookups: ``blas.clear_caches``, ``memspace.reset``,
  ``CallSiteRegistry.get``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro  # noqa: E402
from repro.core import blas as jblas  # noqa: E402
from repro.core import callsite as jcs  # noqa: E402
from repro.core import memspace as jms  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import residency as jres  # noqa: E402
from repro.core import threshold as jthr  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import blas, callsite, memspace, policy  # noqa: E402
from repro_torch.core import residency, threshold  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402

KNOBS = ("SCILIB_EVICT", "SCILIB_PIN", "SCILIB_THRESHOLD",
         "SCILIB_DEVICE_BYTES", "SCILIB_POLICY", "SCILIB_SYNC",
         "SCILIB_DEVICES", "SCILIB_DISPATCH_CACHE", "SCILIB_KERNELS",
         "SCILIB_PRECISION")


@pytest.fixture
def clean_env(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture
def ref_tiers(monkeypatch):
    """The reference on its simulated tiers (one memory kind, tiers as
    tags), as the port runs on the CPU."""
    probe = jms.probe

    def simulated(device=None, n_devices=None):
        sp = probe(device, n_devices)
        return jms.MemSpace(host_kind=sp.device_kind,
                            device_kind=sp.device_kind, simulated=True,
                            backend=sp.backend, n_devices=sp.n_devices)

    monkeypatch.setattr(jms, "probe", simulated)
    jms.reset()
    memspace.reset()
    yield
    jms.reset()
    memspace.reset()


# --------------------------------------------------------------------- #
# the environment wrappers                                               #
# --------------------------------------------------------------------- #
ENV_CASES = [
    ("evict", {}, ("lru",)), ("evict", {"SCILIB_EVICT": "refetch"}, ()),
    ("evict", {"SCILIB_EVICT": "typo"}, ()),
    ("evict", {"SCILIB_EVICT": "lfu"}, ("refetch",)),
    ("evict", {}, ("refetch",)),
    ("pin", {}, ()), ("pin", {"SCILIB_PIN": "never-evict"}, ()),
    ("pin", {"SCILIB_PIN": "no"}, ()),
    ("threshold", {}, ()), ("threshold", {}, (64.0,)),
    ("threshold", {"SCILIB_THRESHOLD": "10"}, ()),
    ("threshold", {"SCILIB_THRESHOLD": "-3"}, (7.0,)),
    ("threshold", {"SCILIB_THRESHOLD": "garbage"}, ()),
    ("device_bytes", {}, ()),
    ("device_bytes", {"SCILIB_DEVICE_BYTES": "1048576"}, ()),
    ("device_bytes", {"SCILIB_DEVICE_BYTES": "4096"}, ()),
    ("device_bytes", {"SCILIB_DEVICE_BYTES": "lots"}, ()),
]
WRAPPERS = {
    "evict": (residency.evict_policy_from_env, jres.evict_policy_from_env),
    "pin": (residency.pin_all_from_env, jres.pin_all_from_env),
    "threshold": (threshold.threshold_from_env, jthr.threshold_from_env),
    "device_bytes": (memspace.device_bytes_from_env,
                     jms.device_bytes_from_env),
}


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name,env,args", ENV_CASES)
def test_env_wrappers_match_reference(clean_env, name, env, args):
    """Each ``*_from_env`` wrapper reads the knob through the config
    boundary, malformed and unknown values falling back as the
    reference's do."""
    for var, value in env.items():
        clean_env.setenv(var, value)
    mine, ref = WRAPPERS[name]
    got, want = mine(*args), ref(*args)
    assert got == want and type(got) is type(want)


def test_residency_exports_the_wrappers():
    for name in ("evict_policy_from_env", "pin_all_from_env"):
        assert name in residency.__all__ and name in jres.__all__


# --------------------------------------------------------------------- #
# the memory kinds                                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("simulated", [False, True])
@pytest.mark.parametrize("tier", [memspace.HOST, memspace.DEVICE])
def test_kind_of_matches_reference(simulated, tier):
    """The card's tiers are pinned host memory and the device's own,
    as the reference names a backend with both kinds; the simulated
    tiers share one memory kind, as the reference's do on a backend with
    one.  The reference's spaces are those of its probe here (its CPU
    backend has both kinds) and of its tests' one-kind patch."""
    live = jms.probe()
    if simulated:
        ref = jms.MemSpace(host_kind=live.device_kind,
                           device_kind=live.device_kind, simulated=True,
                           backend=live.backend)
        mine = memspace.MemSpace(device=torch.device("cpu"), simulated=True)
    else:
        ref = live
        mine = memspace.MemSpace(device=torch.device("cuda", 0),
                                 simulated=False)
    assert not ref.simulated or simulated
    assert mine.kind_of(tier) == ref.kind_of(tier)


def test_memory_kind_of_matches_reference(clean_env, ref_tiers):
    """``memory_kind_of`` is the logical tier of a buffer in both
    packages: host first-touched, device-born, and a placement's copy."""
    x = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    got = [policy.memory_kind_of(policy.host_array(x)),
           policy.memory_kind_of(torch.zeros(3)),
           policy.memory_kind_of(memspace.put(policy.host_array(x),
                                              memspace.DEVICE))]
    want = [jpol.memory_kind_of(jpol.host_array(x)),
            jpol.memory_kind_of(jnp.zeros(3)),
            jpol.memory_kind_of(jms.put(jpol.host_array(x), jms.DEVICE))]
    assert got == want == [memspace.HOST, memspace.DEVICE, memspace.DEVICE]


# --------------------------------------------------------------------- #
# the runtime's ratios                                                   #
# --------------------------------------------------------------------- #
def _calls(mm, host, a_np, b_np):
    """A DFU workload's calls: a reused operand, a repeated call site,
    one call under the threshold."""
    a, b = host(a_np), host(b_np)
    c = mm(a, b)
    for _ in range(4):
        c = mm(a, c)
    mm(a[:32, :32], b[:32, :32])
    mm(b, a)


@pytest.mark.parametrize("policy_name,threshold_value",
                         [("dfu", 100.0), ("memcopy", 100.0),
                          ("dfu", 1e9)])
def test_runtime_ratios_match_reference(clean_env, ref_tiers, policy_name,
                                        threshold_value):
    """``reuse_ratio`` (cache hits over misses) and
    ``dispatch_hit_ratio`` (memoized dispatch decisions over all) after
    the same intercepted calls in both packages."""
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((256, 256)).astype(np.float32)
    b_np = rng.standard_normal((256, 256)).astype(np.float32)
    with repro_torch.session(OffloadConfig.legacy(
            policy=policy_name, threshold=threshold_value),
            device="cpu") as s:
        _calls(torch.matmul, policy.host_array, a_np, b_np)
        s.sync()
        mine = s.stats
    with repro.session(JConfig.legacy(policy=policy_name,
                                      threshold=threshold_value)) as s:
        _calls(jnp.matmul, jpol.host_array, a_np, b_np)
        s.sync()
        ref = s.stats
    assert mine.reuse_ratio() == pytest.approx(ref.reuse_ratio())
    assert mine.dispatch_hit_ratio() == pytest.approx(
        ref.dispatch_hit_ratio())
    assert sum(r.calls for r in mine.per_routine.values()) == 7


# --------------------------------------------------------------------- #
# the resets and lookups                                                 #
# --------------------------------------------------------------------- #
def _reset_case(name):
    if name == "clear_caches":
        rng = np.random.default_rng(1)
        a_np = rng.standard_normal((256, 256)).astype(np.float32)
        out = []
        for mod, sess, host, cfg, kw in (
                (blas, repro_torch.session, policy.host_array,
                 OffloadConfig, {"device": "cpu"}),
                (jblas, repro.session, jpol.host_array, JConfig, {})):
            mod.clear_caches()
            with sess(cfg.legacy(policy="dfu", threshold=100.0), **kw):
                a = host(a_np)
                mod.gemm(a, a, alpha=2.0)
            before = len(mod._BOUND)
            mod.clear_caches()
            out.append((before > 0, len(mod._BOUND)))
        return out
    if name == "reset":
        out = []
        for ms, pol, x in ((memspace, policy, np.ones(3, np.float32)),
                           (jms, jpol, np.ones(3, np.float32))):
            held = pol.host_array(x)
            ms.install(ms.active())
            tagged = ms.tier_of(held)
            ms.reset()
            out.append((tagged, ms.tier_of(held),
                        ms.active().simulated))
        return out
    out = []
    for reg in (callsite.CallSiteRegistry(), jcs.CallSiteRegistry()):
        prof = reg.profile("app.py:12")
        out.append((reg.get("app.py:12") is prof, reg.get("app.py:13"),
                    len(reg)))
    return out


@pytest.mark.parametrize("name", ["clear_caches", "reset", "get"])
def test_resets_and_lookups_match_reference(clean_env, ref_tiers, name):
    """``blas.clear_caches`` empties the memoized dispatch closures (the
    reference also its scalar cache; the port keeps none);
    ``memspace.reset`` drops the installed mapping, the probed default
    and the simulated tiers' tags (a host first-touched tensor then reads
    as device-born); ``CallSiteRegistry.get`` finds a profile without
    making one."""
    mine, ref = _reset_case(name)
    assert mine == ref
    if name == "clear_caches":
        assert mine == (True, 0)
    if name == "reset":
        assert mine == (memspace.HOST, memspace.DEVICE, True)

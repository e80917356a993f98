"""The port's twins of the JAX package's drivers (``repro_torch.examples``)
against the reference, on the CPU.

Each twin runs through its own ``main`` or the function it splits out,
and its numbers are held to the reference's on the same inputs:

* quickstart: every per-routine counter equals the reference's run of
  the same application code (the gemv's vector device-born in both, as
  ``tests/test_torch_intercept_legacy.py`` does: a host column fails in
  JAX 0.9);
* must_lsms at n 128 under cpu, memcopy, counter and dfu, against
  ``repro.core.install`` + ``repro.apps.lsms.run_mini`` with x64 on:
  energy within 1e-10 (four trace(tau)/n terms of ~1 from well
  conditioned float64 LUs agree to ~1e-15), the residuals under 1e-10,
  solves and every zgemm counter equal;
* parsec_dft at ngrid 1024, nstates 32 under dfu: the Ritz values within
  1e-8 of the reference's (both converge to dense eigvalsh's within
  ~4e-8; the same float64 iteration in two libraries differs by
  rounding only) and every dgemm counter equal;
* serve_offload on mamba2's ``reduced()`` config with the reference's
  weights (``models/convert.py``) and prompt: tokens and ``ServeStats``
  equal the JAX ``Server``'s under dfu, memcopy and pinned;
* train_100m: ``CONFIG_100M`` equals the reference's field for field, and
  3 steps at 4 x 32 with a checkpoint every 2 steps;
* the GH200 replays of both twins' production traces (cut in scale)
  equal ``repro.memtier.replay_trace``'s report for report.

The reference side is built from ``repro``'s modules: its
``examples/must_lsms.py`` and ``parsec_dft.py`` set ``jax_enable_x64``
at import, which would leak into other files on the same worker.  Every
twin raises without ``--device`` where there is no CUDA.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.apps import dft as jdft  # noqa: E402
from repro.apps import lsms as jlsms  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402
from repro.memtier import GH200 as JGH200  # noqa: E402
from repro.memtier import replay_trace as jreplay  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import serve as jserve  # noqa: E402

from repro_torch.apps import dft, lsms  # noqa: E402
from repro_torch.examples import (must_lsms, parsec_dft,  # noqa: E402
                                  quickstart, serve_offload, train_100m)
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TWINS = (quickstart, must_lsms, parsec_dft, serve_offload, train_100m)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("SCILIB_POLICY", "SCILIB_THRESHOLD", "SCILIB_SYNC",
                "SCILIB_DEVICE_BYTES", "SCILIB_DISPATCH_CACHE",
                "SCILIB_DEVICES", "SCILIB_KERNELS", "SCILIB_PRECISION"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _reference_example(name: str):
    """A reference driver module that sets no global JAX flag."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counters(stats, skip=("seconds",)) -> dict:
    return {name: {k: v for k, v in dataclasses.asdict(r).items()
                   if k not in skip}
            for name, r in stats.per_routine.items()}


# --------------------------------------------------------------------- #
def test_quickstart_counts_like_the_reference(clean_env, capsys):
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "results identical with offload enabled: OK" in out
    assert "result tier: device" in out
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((768, 768)).astype("float32")
    b_np = rng.standard_normal((768, 768)).astype("float32")
    with repro.session(JConfig.legacy(policy="dfu", threshold=500.0)) as s:
        a, b = jcore.host_array(a_np), jcore.host_array(b_np)
        x = jnp.asarray(b_np[:, 0].copy())
        c = jnp.matmul(a, b)
        for _ in range(5):
            c = jnp.matmul(a, c)
        jnp.einsum("ij,kj->ik", c, b)
        jnp.dot(a[:64, :64], b[:64, :64])
        jnp.matmul(a, x)
        s.sync()
        want = _counters(s.stats)
        reuse = s.runtime.mean_buffer_reuse()
    assert got["counters"] == {name: {k: want[name][k] for k in fields}
                               for name, fields in got["counters"].items()}
    assert set(got["counters"]) == {"sgemm", "sgemv"}
    assert got["counters"]["sgemm"]["offloaded"] == 7
    assert got["reuse"] == pytest.approx(reuse)


# --------------------------------------------------------------------- #
LSMS_KW = dict(atoms=2, energies=2, scf=1, n=128)


def test_must_lsms_matches_the_reference_per_policy(x64, clean_env, capsys):
    got = must_lsms.run_policies(device="cpu", **LSMS_KW)
    assert "energies identical across policies: OK" in \
        capsys.readouterr().out
    skip = ("seconds", "flops")
    for policy in must_lsms.POLICIES:
        jcore.install(policy=policy, threshold=must_lsms.THRESHOLD)
        try:
            want = jlsms.run_mini(**LSMS_KW)
        finally:
            stats = jcore.uninstall()
        mine = got[policy]
        assert abs(mine["energy"] - want["energy"]) <= 1e-10, policy
        assert mine["max_resid"] < 1e-10 and want["max_resid"] < 1e-10
        assert mine["n_solves"] == want["n_solves"] == 4
        zw = _counters(stats, skip)["zgemm"]
        zg = {k: v for k, v in mine["zgemm"].items() if k not in skip}
        assert zg == {k: zw[k] for k in zg}, policy
        assert zg["calls"] == 4
    n2 = 128 * 128 * 16
    # the rules of core/policy.py at these shapes (t-matrix device-born)
    assert got["dfu"]["zgemm"]["bytes_in"] == 2 * n2
    assert got["dfu"]["zgemm"]["cache_hits"] == 2
    assert got["counter"]["zgemm"]["bytes_in"] == 2 * n2
    assert got["memcopy"]["zgemm"]["bytes_in"] == 4 * n2
    assert got["memcopy"]["zgemm"]["bytes_out"] == 4 * n2
    assert got["cpu"]["zgemm"]["offloaded"] == 0
    assert got["cpu"]["zgemm"]["transient_bytes"] == 4 * n2
    assert len(got["dfu"]["trace"]) == 4


def _report(rep) -> dict:
    return dataclasses.asdict(rep)


def test_must_lsms_replay_equals_the_reference(capsys):
    kw = dict(atoms_per_node=3, energies=2, scf=1)
    got = must_lsms.replay(lsms.production_trace(**kw), specs=("gh200",))
    want = jreplay(jlsms.production_trace(**kw), spec=JGH200,
                   policies=must_lsms.POLICIES)
    assert list(got["gh200"]) == list(want)
    for p in want:
        assert _report(got["gh200"][p]) == _report(want[p])
    assert "DFU speedup vs CPU on gh200" in capsys.readouterr().out


# --------------------------------------------------------------------- #
def test_parsec_dft_matches_the_reference(x64, clean_env, capsys):
    got = parsec_dft.main(["--device", "cpu", "--part", "live"])["live"]
    assert "max_err(low half)" in capsys.readouterr().out
    jcore.install(policy="dfu", threshold=parsec_dft.THRESHOLD)
    try:
        want = jdft.run_mini(ngrid=1024, nstates=32)
    finally:
        stats = jcore.uninstall()
    assert got["max_err_low_half"] < 1e-6
    assert want["max_err_low_half"] < 1e-6
    assert got["exact_min"] == pytest.approx(want["exact_min"], abs=1e-12)
    assert abs(got["ritz_min"] - want["ritz_min"]) <= 1e-8
    skip = ("seconds", "flops")
    mine = _counters(got["stats"], skip)["dgemm"]
    ref = _counters(stats, skip)["dgemm"]
    assert mine == {k: ref[k] for k in mine}
    # H and psi are born on the device: DFU moves nothing
    assert mine["bytes_in"] == 0
    # 3 products per Rayleigh-Ritz step, cheb_order per filter sweep
    assert mine["calls"] == 3 + 8 * (10 + 3)


def test_parsec_dft_replay_equals_the_reference(capsys):
    kw = dict(scf=1, filt_per_scf=1)
    got = parsec_dft.replay(dft.production_trace(**kw), specs=("gh200",))
    want = jreplay(jdft.production_trace(**kw), spec=JGH200,
                   policies=must_lsms.POLICIES)
    for p in want:
        assert _report(got["gh200"][p]) == _report(want[p])
    assert "dgemm_s" in capsys.readouterr().out


# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mamba_reference():
    """The reference driver's serving run, policy by policy: its reduced
    mamba2, weights from PRNGKey(0), the 4 x 16 prompt from PRNGKey(1)."""
    cfg = jreg.get_config("mamba2_1_3b").reduced()
    model = jreg.Model.from_config(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                cfg.vocab)
    runs = {}
    for policy in serve_offload.POLICIES:
        srv = jserve.Server(model, params, jserve.ServeConfig(
            max_len=96, offload_policy=policy, cache_dtype=jnp.float32))
        runs[policy] = (np.asarray(srv.generate(prompt, 32)), srv.stats)
    return np.asarray(prompt), jax.tree.map(np.asarray, params), runs


def _serve_stats(s) -> tuple:
    return (s.bytes_host_to_dev, s.bytes_dev_to_host, s.cache_reuses,
            s.migrations, s.tokens)


def test_serve_offload_matches_the_reference(mamba_reference, capsys):
    prompt, params_np, runs = mamba_reference
    cfg = registry.get_config("mamba2_1_3b").reduced()
    model = registry.Model.from_config(cfg)
    got = serve_offload.run(model, params_from_jax(params_np, cfg),
                            torch.from_numpy(prompt), device="cpu")
    assert "identical generations under all policies: OK" in \
        capsys.readouterr().out
    for policy in serve_offload.POLICIES:
        tokens, stats = got[policy]
        np.testing.assert_array_equal(tokens.numpy(), runs[policy][0])
        assert _serve_stats(stats) == _serve_stats(runs[policy][1])
    assert got["dfu"][1].migrations == 1
    assert got["memcopy"][1].bytes_dev_to_host == \
        got["memcopy"][1].bytes_host_to_dev == 32 * \
        got["dfu"][1].bytes_host_to_dev


def test_serve_offload_main_runs_on_the_cpu(capsys):
    got = serve_offload.main(["--device", "cpu"])
    assert set(got) == set(serve_offload.POLICIES)
    assert tuple(got["dfu"][0].shape) == (4, 32)
    assert "identical generations" in capsys.readouterr().out


# --------------------------------------------------------------------- #
def test_config_100m_equals_the_reference():
    ref = _reference_example("train_100m").CONFIG_100M
    mine = dataclasses.asdict(train_100m.CONFIG_100M)
    assert mine == dataclasses.asdict(ref)
    assert train_100m.CONFIG_100M.param_count() == ref.param_count()


def test_train_100m_runs_three_steps(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    got = train_100m.main(["--device", "cpu", "--steps", "3", "--batch",
                           "4", "--seq", "32", "--ckpt-every", "2",
                           "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "params=137.8M" in out and "over 3 steps" in out
    hist = got["history"]
    assert len(hist) == 3
    assert all(math.isfinite(h["loss"]) for h in hist)
    tr = got["trainer"]
    assert (tr.tcfg.n_micro, tr.tcfg.remat) == (2, "dots")
    # the periodic checkpoint at step 2 and the final one at step 3
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_2", "step_3"]


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("twin", TWINS, ids=lambda m: m.__name__)
def test_twins_raise_without_cuda_unless_asked(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main([])

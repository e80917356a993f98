"""The port's serving loop against the JAX package's on the CPU.

``repro_torch.train.Server`` and ``repro.train.Server`` generate from the
same reduced gemma2 weights (the reference's, carried across by
``params_from_jax``) and the same prompt of 24 tokens, longer than the
reduced local window of 16, under each placement policy, with the
prefill attending over its fresh keys (the flash kernel's path) and over
the cache.  Greedy tokens must be equal, against the reference run both
on XLA and on its interpreted Pallas kernels (``SCILIB_PALLAS=1``), and
every byte, migration and reuse count of ``ServeStats`` must equal the
reference's.  Two concurrent streams over one shared pool give each
stream the single-stream tokens and counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import Server, ServeConfig  # noqa: E402

BATCH, PROMPT, GEN, MAX_LEN = 2, 24, 8, 40
POLICIES = ("dfu", "memcopy", "pinned")
#: the reduced gemma2 cache: 2 period positions x (k, v), each
#: (2 groups, batch 2, 2 KV heads, 40 slots, head size 16) float32
CACHE_BYTES = 4 * 2 * BATCH * 2 * MAX_LEN * 16 * 4


def _stats(s):
    return (s.bytes_host_to_dev, s.bytes_dev_to_host, s.cache_reuses,
            s.migrations, s.tokens)


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, 512, (BATCH, PROMPT))


def _jax_run(fresh, policy, prompt, pallas, monkeypatch):
    if pallas:
        monkeypatch.setenv("SCILIB_PALLAS", "1")
    else:
        monkeypatch.delenv("SCILIB_PALLAS", raising=False)
    cfg = dataclasses.replace(jreg.get_config("gemma2_9b").reduced(),
                              prefill_fresh_kv=fresh)
    model = jreg.Model.from_config(cfg)
    params = model.init(jax.random.PRNGKey(0))
    srv = jserve.Server(model, params, jserve.ServeConfig(
        max_len=MAX_LEN, offload_policy=policy, cache_dtype=jnp.float32))
    out = np.asarray(srv.generate(jnp.asarray(prompt, jnp.int32), GEN))
    return out, _stats(srv.stats), params


@pytest.fixture(scope="module")
def reference(prompt):
    """The reference's tokens per (fresh, pallas) under dfu, its stats per
    policy, and its weights."""
    mp = pytest.MonkeyPatch()
    try:
        tokens, stats = {}, {}
        for fresh in (True, False):
            for pallas in (False, True):
                out, st, params = _jax_run(fresh, "dfu", prompt, pallas, mp)
                tokens[fresh, pallas] = out
                stats["dfu"] = st
        for policy in ("memcopy", "pinned"):
            out, stats[policy], _ = _jax_run(True, policy, prompt, False, mp)
            assert (out == tokens[True, False]).all()
    finally:
        mp.undo()
    return tokens, stats, jax.tree.map(np.asarray, params)


def _port(fresh, params_np, scfg_kw):
    cfg = dataclasses.replace(registry.get_config("gemma2_9b").reduced(),
                              prefill_fresh_kv=fresh)
    model = registry.Model.from_config(cfg)
    params = params_from_jax(params_np, cfg)
    return Server(model, params, ServeConfig(**scfg_kw), device="cpu")


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_generate_matches_reference(reference, prompt, policy, fresh):
    tokens, stats, params_np = reference
    srv = _port(fresh, params_np, dict(max_len=MAX_LEN, offload_policy=policy,
                                       cache_dtype=torch.float32))
    out = srv.generate(torch.from_numpy(prompt), GEN).numpy()
    for pallas in (False, True):
        np.testing.assert_array_equal(out, tokens[fresh, pallas])
    assert _stats(srv.stats) == stats[policy]


def test_stats_follow_the_papers_accounting(reference):
    """DFU moves the cache once and reuses it on every decode step;
    memcopy round-trips it around the prefill and every step."""
    _, stats, _ = reference
    steps = GEN - 1
    assert stats["dfu"] == (CACHE_BYTES, 0, steps, 1, BATCH * steps)
    assert stats["memcopy"] == (GEN * CACHE_BYTES, GEN * CACHE_BYTES, 0, 0,
                                BATCH * steps)
    assert stats["pinned"] == (0, 0, steps, 0, BATCH * steps)


def test_temperature_sampling_is_seeded(reference, prompt):
    _, _, params_np = reference
    outs = []
    for seed in (3, 3, 4):
        srv = _port(True, params_np, dict(max_len=MAX_LEN, temperature=1.0,
                                          cache_dtype=torch.float32,
                                          seed=seed))
        outs.append(srv.generate(torch.from_numpy(prompt), GEN))
    assert torch.equal(outs[0], outs[1])
    assert all(((o >= 0) & (o < 512)).all() for o in outs)


def test_server_needs_a_card_unless_asked_for_the_cpu(reference):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device=None would use it")
    cfg = registry.get_config("gemma2_9b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(registry.Model.from_config(cfg), None, ServeConfig())


def test_launch_serve_runs_on_the_cpu(capsys):
    rc = launch_serve.main(["--arch", "gemma2_9b", "--reduced", "--device",
                            "cpu", "--batch", "2", "--prompt-len", "20",
                            "--gen", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "generated (2, 5)" in out
    assert "migrations=1, cache reuses=4" in out


def test_launch_serve_refuses_streams(capsys):
    """``--streams 2`` serves two concurrent streams over one shared
    pool: each stream migrates its cache once and reuses it on every
    decode step, and the pool's per-tenant report prints."""
    rc = launch_serve.main(["--arch", "gemma2_9b", "--reduced", "--device",
                            "cpu", "--batch", "2", "--prompt-len", "20",
                            "--gen", "5", "--streams", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "streams=2 pool=256MB" in out
    assert "shared pool 'serve'" in out
    for idx in (0, 1):
        assert (f"stream-{idx}: generated (2, 5) migrations=1 "
                f"cache reuses=4") in out


def test_streams_match_one_stream_and_reference_tenants(reference, prompt,
                                                        capsys):
    """Two streams over shared weights each give the single-stream
    tokens (the reference's), the single-stream ServeStats, and the
    per-tenant pool rows the reference's ``_serve_streams`` reports."""
    import argparse

    from repro.launch import serve as jlaunch
    from repro_torch.core.residency import SharedDevicePool
    tokens, stats, params_np = reference
    cfg = registry.get_config("gemma2_9b").reduced()
    model = registry.Model.from_config(cfg)
    params = params_from_jax(params_np, cfg)
    scfg = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    pool = SharedDevicePool(256 << 20, name="serve")
    got = launch_serve.serve_streams(model, params, scfg,
                                     torch.from_numpy(prompt), GEN, 2,
                                     pool, device="cpu")
    for out, st, row, _ in got:
        np.testing.assert_array_equal(out.numpy(), tokens[True, False])
        assert _stats(st) == stats["dfu"]
    jcfg = jreg.get_config("gemma2_9b").reduced()
    jmodel = jreg.Model.from_config(jcfg)
    jparams = jax.tree.map(jnp.asarray, params_np)
    args = argparse.Namespace(offload_config="", pool_mb=256, streams=2,
                              gen=GEN, policy="dfu")
    capsys.readouterr()
    jlaunch._serve_streams(args, jcfg, jmodel, jparams, jserve.ServeConfig(
        max_len=MAX_LEN, cache_dtype=jnp.float32),
        jnp.asarray(prompt, jnp.int32), None)
    printed = capsys.readouterr().out
    for idx, (_, _, row, _) in enumerate(got):
        line = f"  stream-{idx}: " + " ".join(
            f"{k}={v}" for k, v in sorted(row.items()))
        assert line in printed.splitlines(), (line, printed)

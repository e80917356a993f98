"""The port's serving loop on the MoE, SSM and hybrid models against the
JAX package's on the CPU.

``repro_torch.train.Server`` and ``repro.train.Server`` generate from the
same reduced granite-moe-1b-a400m, mamba2-1.3b and jamba-1.5-large-398b
weights (the reference's, carried across by ``params_from_jax``) and the
same prompt of 24 tokens (one SSD chunk) under each placement policy.
Greedy tokens must be equal, against the reference run both on XLA and on
its interpreted Pallas kernels (``SCILIB_PALLAS=1``), and every byte,
migration and reuse count of ``ServeStats`` must equal the reference's,
with a float32 cache and with a bf16 one, in which the SSD state's
``ssm_h`` stays float32 in both packages and is counted so.
``launch/serve.py`` serves the reduced granite and mamba2 on the CPU.
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

BATCH, PROMPT, GEN, MAX_LEN = 2, 24, 8, 32
POLICIES = ("dfu", "memcopy", "pinned")
ARCHS = ("granite_moe_1b_a400m", "mamba2_1_3b", "jamba_1_5_large_398b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _stats(s):
    return (s.bytes_host_to_dev, s.bytes_dev_to_host, s.cache_reuses,
            s.migrations, s.tokens)


def _cfg(reg, arch, model_dtype):
    return dataclasses.replace(reg.get_config(arch).reduced(),
                               dtype=model_dtype)


def _jax_run(arch, policy, prompt, cache_dtype, pallas, monkeypatch,
             model_dtype="float32"):
    if pallas:
        monkeypatch.setenv("SCILIB_PALLAS", "1")
    else:
        monkeypatch.delenv("SCILIB_PALLAS", raising=False)
    model = jreg.Model.from_config(_cfg(jreg, arch, model_dtype))
    params = model.init(jax.random.PRNGKey(0))
    srv = jserve.Server(model, params, jserve.ServeConfig(
        max_len=MAX_LEN, offload_policy=policy,
        cache_dtype=DTYPES[cache_dtype][0]))
    out = np.asarray(srv.generate(jnp.asarray(prompt, jnp.int32), GEN))
    return out, _stats(srv.stats), params


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """Per architecture: the prompt, the reference's tokens and stats per
    (policy, cache dtype, pallas) run, and its weights."""
    arch = request.param
    prompt = np.random.default_rng(0).integers(0, 512, (BATCH, PROMPT))
    # (policy, cache dtype, pallas, model dtype)
    runs = [("dfu", "float32", False, "float32"),
            ("dfu", "float32", True, "float32"),
            ("memcopy", "float32", False, "float32"),
            ("pinned", "float32", False, "float32"),
            ("memcopy", "bfloat16", False, "float32"),
            ("dfu", "bfloat16", False, "bfloat16"),
            ("memcopy", "bfloat16", False, "bfloat16")]
    mp = pytest.MonkeyPatch()
    try:
        got = {}
        for policy, dt, pallas, model_dt in runs:
            out, st, params = _jax_run(arch, policy, prompt, dt, pallas, mp,
                                       model_dt)
            got[policy, dt, pallas, model_dt] = (out, st)
    finally:
        mp.undo()
    return arch, prompt, got, jax.tree.map(np.asarray, params)


def _port(arch, params_np, model_dtype="float32", **scfg):
    cfg = _cfg(registry, arch, model_dtype)
    return Server(registry.Model.from_config(cfg),
                  params_from_jax(params_np, cfg), ServeConfig(**scfg),
                  device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_generate_matches_reference(reference, policy):
    arch, prompt, runs, params_np = reference
    srv = _port(arch, params_np, max_len=MAX_LEN, offload_policy=policy,
                cache_dtype=torch.float32)
    out = srv.generate(torch.from_numpy(prompt), GEN).numpy()
    for pallas in (False, True):
        np.testing.assert_array_equal(
            out, runs["dfu", "float32", pallas, "float32"][0])
    want_out, want_stats = runs[policy, "float32", False, "float32"]
    np.testing.assert_array_equal(out, want_out)
    assert _stats(srv.stats) == want_stats


@pytest.mark.parametrize("policy", ["dfu", "memcopy"])
def test_bf16_cache_counts_the_float32_state(reference, policy):
    """A bf16 model over a bf16 cache, as served on the card: SSD layers
    keep ssm_h in float32, and the bytes DFU moves once and memcopy
    moves around every step are the reference's.  (Tokens are compared
    in the float32 runs: bf16 arithmetic rounds differently in the two
    frameworks at every operation.)"""
    arch, prompt, runs, params_np = reference
    srv = _port(arch, params_np, "bfloat16", max_len=MAX_LEN,
                offload_policy=policy, cache_dtype=torch.bfloat16)
    srv.generate(torch.from_numpy(prompt), GEN)
    want_stats = runs[policy, "bfloat16", False, "bfloat16"][1]
    assert _stats(srv.stats) == want_stats
    cfg = _cfg(registry, arch, "bfloat16")
    cache = registry.Model.from_config(cfg).init_cache(
        BATCH, MAX_LEN, torch.bfloat16, device="cpu")
    nbytes = sum(x.nbytes for pair in cache for x in pair)
    assert want_stats[0] == (nbytes if policy == "dfu" else GEN * nbytes)
    ssd = [pair for pos, pair in enumerate(cache)
           if not cfg.is_attn_layer(pos)]
    assert all(h.dtype == torch.float32 and c.dtype == torch.bfloat16
               for h, c in ssd)


def test_conv_state_keeps_the_cache_dtype(reference):
    """A float32 model over a bf16 cache: the reference's decode step
    returns conv_state promoted to float32 (the concatenation of the
    bf16 state and the float32 projection, ssm.py:80, is not cast back,
    unlike the prefill's, transformer.py:78-80), so under memcopy its
    cache grows after the first step.  The port writes the new state
    into the cache in place, in the cache dtype: every round trip moves
    the same bytes.  Tokens agree; only the accounting differs."""
    arch, prompt, runs, params_np = reference
    srv = _port(arch, params_np, max_len=MAX_LEN, offload_policy="memcopy",
                cache_dtype=torch.bfloat16)
    out = srv.generate(torch.from_numpy(prompt), GEN).numpy()
    want_out, (h2d, d2h, *rest) = runs["memcopy", "bfloat16", False,
                                       "float32"]
    np.testing.assert_array_equal(out, want_out)
    cfg = registry.get_config(arch).reduced()
    cache = registry.Model.from_config(cfg).init_cache(
        BATCH, MAX_LEN, torch.bfloat16, device="cpu")
    nbytes = sum(x.nbytes for pair in cache for x in pair)
    assert _stats(srv.stats) == (GEN * nbytes, GEN * nbytes, *rest)
    promoted = any(not cfg.is_attn_layer(pos) for pos in range(len(cache)))
    assert (h2d > GEN * nbytes and d2h > h2d) == promoted


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "granite_moe_1b_a400m"])
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    rc = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "32", "--gen",
                            "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "generated (2, 5)" in out
    assert "migrations=1, cache reuses=4" in out

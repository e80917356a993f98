"""The port's VLM family (pixtral-12b) against the JAX package on the CPU.

Reduced pixtral-12b (2 layers, d_model 64, GQA 4/1, an 8-row patch
prefix, float32) with the reference's own weights carried across by
``params_from_jax``.  The stub frontend's ``patch_embeds`` go before the
token embeddings: they take cache slots and positions, and their rows are
dropped before the vocab head.  Compared: the forward with and without
patches, the prefill into a cache and three decode steps at positions
P + T onward, and ``Server`` generation with and without patches under
each placement policy (tokens and every ``ServeStats`` count equal to
the reference's, on XLA and on its interpreted Pallas kernels).

``generate`` keeps the reference's decode start, ``prompt.shape[1]`` =
T, not the P + T slots the prefill wrote (``repro/train/serve.py:160``):
each decode step overwrites a slot inside the prefix's and the prompt's
keys.  One test pins that, in both packages; another holds ``prefill``
then ``decode(start_pos=P + T)``, which both packages take, against the
reference.

Tolerance 1e-5 on logits and caches, relative to the reference's largest
value (float32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import cache_to_numpy  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import Server, ServeConfig  # noqa: E402

TOL = 1e-5
BATCH, PROMPT, GEN, MAX_LEN = 2, 12, 6, 32
POLICIES = ("dfu", "memcopy", "pinned")


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def pair():
    jcfg = jreg.get_config("pixtral_12b").reduced()
    cfg = registry.get_config("pixtral_12b").reduced()
    jm = jreg.Model.from_config(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = registry.Model.from_config(cfg)
    pnp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (BATCH, PROMPT))
    patches = rng.standard_normal((BATCH, cfg.patch_prefix,
                                   cfg.d_model)).astype(np.float32)
    return jm, jp, m, params_from_jax(pnp, cfg), pnp, prompt, patches


def test_config_and_model_api_are_the_references(pair):
    jm, _, m, *_ = pair
    assert dataclasses.asdict(registry.get_config("pixtral-12b")) == \
        dataclasses.asdict(jreg.get_config("pixtral_12b"))
    assert m.extra_inputs(2, 64) == jm.extra_inputs(2, 64) == {
        "patch_embeds": (2, 8, 64)}
    assert m.text_len(64) == jm.text_len(64) == 56


def test_forward_with_and_without_patches(pair):
    jm, jp, m, p, _, prompt, patches = pair
    for kw in ({}, {"patch_embeds": patches}):
        jl, _, _ = jm.forward(jp, jnp.asarray(prompt),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, _, _ = m.forward(p, torch.from_numpy(prompt),
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert tl.shape == (BATCH, PROMPT, m.cfg.vocab)
        assert _rel(tl, jl) <= TOL


def test_prefill_then_decode_after_the_prefix(pair):
    """The prefill writes P + T slots; decode steps at P + T onward."""
    jm, jp, m, p, _, prompt, patches = pair
    n_patch = m.cfg.patch_prefix
    jc = jm.init_cache(BATCH, MAX_LEN, jnp.float32)
    tc = m.init_cache(BATCH, MAX_LEN, torch.float32)
    jl, _, jc = jm.forward(jp, jnp.asarray(prompt[:, :8]),
                           patch_embeds=jnp.asarray(patches), cache=jc,
                           cache_pos=jnp.asarray(0, jnp.int32))
    tl, _, tc = m.forward(p, torch.from_numpy(prompt[:, :8]),
                          patch_embeds=torch.from_numpy(patches), cache=tc,
                          cache_pos=0)
    assert tl.shape[1] == 8 and _rel(tl, jl) <= TOL
    for step in range(3):
        pos = n_patch + 8 + step
        tok = prompt[:, 8 + step:9 + step]
        jl, _, jc = jm.forward(jp, jnp.asarray(tok), cache=jc,
                               cache_pos=jnp.asarray(pos, jnp.int32))
        tl, _, tc = m.forward(p, torch.from_numpy(tok), cache=tc,
                              cache_pos=pos)
        assert _rel(tl, jl) <= TOL
        for tkv, jkv in zip(cache_to_numpy(tc), cache_to_numpy(jc)):
            for t, j in zip(tkv, jkv):
                assert _rel(t, j) <= TOL


def _stats(s):
    return (s.bytes_host_to_dev, s.bytes_dev_to_host, s.cache_reuses,
            s.migrations, s.tokens)


@pytest.fixture(scope="module")
def reference(pair):
    """The reference's tokens and stats per (policy, patches, pallas)."""
    jm, jp, _, _, _, prompt, patches = pair
    runs = [(pol, pat, False) for pol in POLICIES for pat in (False, True)]
    runs += [("dfu", False, True), ("dfu", True, True)]
    mp = pytest.MonkeyPatch()
    got = {}
    try:
        for policy, with_patches, pallas in runs:
            if pallas:
                mp.setenv("SCILIB_PALLAS", "1")
            else:
                mp.delenv("SCILIB_PALLAS", raising=False)
            srv = jserve.Server(jm, jp, jserve.ServeConfig(
                max_len=MAX_LEN, offload_policy=policy,
                cache_dtype=jnp.float32))
            extra = ({"patch_embeds": jnp.asarray(patches)}
                     if with_patches else None)
            out = srv.generate(jnp.asarray(prompt, jnp.int32), GEN, extra)
            got[policy, with_patches, pallas] = (np.asarray(out),
                                                 _stats(srv.stats))
    finally:
        mp.undo()
    return got


def _server(pair, policy):
    m, p = pair[2], pair[3]
    return Server(m, p, ServeConfig(max_len=MAX_LEN, offload_policy=policy,
                                    cache_dtype=torch.float32),
                  device="cpu")


@pytest.mark.parametrize("with_patches", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_server_matches_reference(pair, reference, policy, with_patches):
    prompt, patches = pair[5], pair[6]
    srv = _server(pair, policy)
    extra = ({"patch_embeds": torch.from_numpy(patches)}
             if with_patches else None)
    out = srv.generate(torch.from_numpy(prompt), GEN, extra).numpy()
    want, stats = reference[policy, with_patches, False]
    np.testing.assert_array_equal(out, want)
    if policy == "dfu":
        np.testing.assert_array_equal(
            out, reference["dfu", with_patches, True][0])
    assert _stats(srv.stats) == stats


def test_generate_decodes_from_the_text_length(pair):
    """The reference's ``generate`` decodes from T, not P + T: its first
    decode step writes slot T, inside the prefill's P + T keys, and slots
    from P + T on stay empty.  The port keeps those semantics, in both
    packages alike."""
    jm, jp, m, p, _, prompt, patches = pair
    n_patch = m.cfg.patch_prefix
    jsrv = jserve.Server(jm, jp, jserve.ServeConfig(
        max_len=MAX_LEN, offload_policy="pinned", cache_dtype=jnp.float32))
    jtok, jc = jsrv.prefill(jnp.asarray(prompt, jnp.int32),
                            {"patch_embeds": jnp.asarray(patches)})
    jgen, jc = jsrv.decode(jtok, jc, PROMPT, GEN - 1)
    srv = _server(pair, "pinned")
    tok, tc = srv.prefill(torch.from_numpy(prompt),
                          {"patch_embeds": torch.from_numpy(patches)})
    gen, tc = srv.decode(tok, tc, PROMPT, GEN - 1)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    k = cache_to_numpy(tc)[0][0]
    assert _rel(k, cache_to_numpy(jc)[0][0]) <= TOL
    # slots P + T .. : never written; slot T holds a decode step's key
    assert not k[:, :, :, n_patch + PROMPT:].any()
    assert k[:, :, :, PROMPT].any()
    full = srv.generate(torch.from_numpy(prompt), GEN,
                        {"patch_embeds": torch.from_numpy(patches)})
    np.testing.assert_array_equal(full[:, 1:].numpy(), gen.numpy())


def test_decode_from_the_prefix_end_matches_reference(pair):
    """``prefill`` then ``decode(start_pos=P + T)`` (what a VLM server
    should run) gives the reference's tokens and cache."""
    jm, jp, m, p, _, prompt, patches = pair
    start = m.cfg.patch_prefix + PROMPT
    jsrv = jserve.Server(jm, jp, jserve.ServeConfig(
        max_len=MAX_LEN, offload_policy="dfu", cache_dtype=jnp.float32))
    jtok, jc = jsrv.prefill(jnp.asarray(prompt, jnp.int32),
                            {"patch_embeds": jnp.asarray(patches)})
    jgen, jc = jsrv.decode(jtok, jc, start, GEN - 1)
    srv = _server(pair, "dfu")
    tok, tc = srv.prefill(torch.from_numpy(prompt),
                          {"patch_embeds": torch.from_numpy(patches)})
    gen, tc = srv.decode(tok, tc, start, GEN - 1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    for tkv, jkv in zip(cache_to_numpy(tc), cache_to_numpy(jc)):
        for t, j in zip(tkv, jkv):
            assert _rel(t, j) <= TOL
    assert _stats(srv.stats) == _stats(jsrv.stats)

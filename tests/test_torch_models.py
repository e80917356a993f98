"""The port's dense LM stack against the JAX package on the CPU.

Reduced gemma2 (GQA, alternating local/global windows, soft-caps,
post-norms, (1 + w) RMSNorm, scaled and tied embeddings) and reduced
qwen1.5-4b (QKV bias, untied embeddings, MHA), with the reference's own
initialized weights carried across by ``params_from_jax``.  The forward
without a cache, the prefill into a cache (attending over the fresh keys
or over the cache) and single decode steps are compared.

Tolerance 1e-4 on logits and caches, relative to the reference's largest
value: reduced configs are float32, and the two frameworks' float32
products and transcendental functions round differently (~1e-6 seen).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs.base import torch_dtype  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        cache_to_numpy, params_from_jax)

TOL = 1e-4
ARCHS = ["gemma2_9b", "qwen1_5_4b"]


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _caches_close(tc, jc):
    for tkv, jkv in zip(cache_to_numpy(tc), cache_to_numpy(jc)):
        for t, j in zip(tkv, jkv):
            assert _rel(t, j) <= TOL


def _pair(arch, fresh=False):
    jcfg = dataclasses.replace(jreg.get_config(arch).reduced(),
                               prefill_fresh_kv=fresh)
    cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                              prefill_fresh_kv=fresh)
    jm = jreg.Model.from_config(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = registry.Model.from_config(cfg)
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _tokens(cfg, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, t))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_cache(arch):
    jm, jp, m, p = _pair(arch)
    toks = _tokens(m.cfg, 24)
    jl, _, jc = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    tl, aux, tc = m.forward(p, torch.from_numpy(toks))
    assert jc is None and tc is None and float(aux) == 0.0
    assert tl.dtype == torch.float32
    assert _rel(tl, jl) <= TOL
    jl, _, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32), last_only=True)
    tl, _, _ = m.forward(p, torch.from_numpy(toks), last_only=True)
    assert tl.shape[1] == 1 and _rel(tl, jl) <= TOL


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps(arch, fresh):
    """Prefill 24 tokens into a 40-slot cache, then 3 decode steps; the
    caches stay in the reference's stacked layout and agree."""
    jm, jp, m, p = _pair(arch, fresh)
    toks = _tokens(m.cfg, 24)
    jc = jm.init_cache(2, 40, jnp.float32)
    tc = m.init_cache(2, 40, torch.float32)
    assert [tuple(x.shape) for kv in tc for x in kv] == \
        [tuple(x.shape) for kv in jc for x in kv]
    jl, _, jc = jm.forward(jp, jnp.asarray(toks, jnp.int32), cache=jc,
                           cache_pos=jnp.zeros((), jnp.int32))
    tl, _, tc = m.forward(p, torch.from_numpy(toks), cache=tc, cache_pos=0)
    assert _rel(tl, jl) <= TOL
    _caches_close(tc, jc)
    for step in range(3):
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
        pos = 24 + step
        jl, _, jc = jm.forward(jp, jnp.asarray(tok, jnp.int32), cache=jc,
                               cache_pos=jnp.asarray(pos, jnp.int32))
        tl, _, tc = m.forward(p, torch.from_numpy(tok), cache=tc,
                              cache_pos=pos)
        assert _rel(tl, jl) <= TOL
        _caches_close(tc, jc)


def test_decode_from_a_carried_cache():
    """A cache filled by the reference, carried across with
    cache_from_jax, decodes as the reference does."""
    jm, jp, m, p = _pair("gemma2_9b")
    toks = _tokens(m.cfg, 20)
    jc = jm.init_cache(2, 32, jnp.float32)
    jl, _, jc = jm.forward(jp, jnp.asarray(toks, jnp.int32), cache=jc,
                           cache_pos=jnp.zeros((), jnp.int32))
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), dtype=torch.float32)
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
    jl, _, jc = jm.forward(jp, jnp.asarray(tok, jnp.int32), cache=jc,
                           cache_pos=jnp.asarray(20, jnp.int32))
    tl, _, tc = m.forward(p, torch.from_numpy(tok), cache=tc, cache_pos=20)
    assert _rel(tl, jl) <= TOL
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", ["gemma2_9b", "qwen1_5_4b", "deepseek_7b",
                                  "qwen2_5_32b"])
def test_dense_configs_are_the_references(arch):
    assert dataclasses.asdict(registry.get_config(arch)) == \
        dataclasses.asdict(jreg.get_config(arch))
    assert registry.get_config(arch.replace("_", "-")) is \
        registry.get_config(arch)


def test_registry_lists_every_arch_and_refuses_the_unported():
    assert registry.ARCHS == jreg.ARCHS
    for arch in set(registry.ARCHS) - set(registry.PORTED):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            registry.get_config(arch)


def test_init_layout_and_storage_types():
    """Seeded init in the reference's tree and shapes; matrices stored in
    cfg.dtype (bf16 here), norm weights in float32; the same seed gives
    the same weights."""
    cfg = dataclasses.replace(registry.get_config("gemma2_9b").reduced(),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jreg.get_config("gemma2_9b").reduced(),
                               dtype="bfloat16")
    jp = jreg.Model.from_config(jcfg).init(jax.random.PRNGKey(0))
    model = registry.Model.from_config(cfg)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(p.named_parameters())
    assert len(got) == len(jleaves)
    for path, leaf in jleaves:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        t = got[name]
        assert tuple(t.shape) == leaf.shape, name
        norm = name.split(".")[-1] in transformer.NORMS
        assert t.dtype == (torch.float32 if norm else torch.bfloat16), name
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(p.parameters(), again.parameters()))
    assert torch_dtype(cfg.dtype) == torch.bfloat16


def test_the_unported_blocks_raise():
    cfg = dataclasses.replace(registry.get_config("gemma2_9b").reduced(),
                              n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        transformer.init_model(torch.Generator(), cfg, "cpu")


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(7, 12)
    assert _rel(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                           1.0),
                jL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, 1.0)) \
        <= 1e-6
    for p in (pos, np.stack([pos, pos + 3])):
        assert _rel(L.rope(torch.from_numpy(x), torch.from_numpy(p), 1e4),
                    jL.rope(jnp.asarray(x), jnp.asarray(p), 1e4)) <= 1e-5


def test_matmul_folds_activation_dims_into_one_launch(monkeypatch):
    """A stack of activations times one matrix runs one 2-D product over
    the folded rows; the result is unchanged."""
    calls = []
    real = ops.gemm

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape), b.data_ptr()))
        return real(a, b)

    monkeypatch.setattr(ops, "gemm", spy)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 7, 16, generator=gen)
    w = torch.randn(16, 5, generator=gen)
    out = ops.matmul(x, w)
    assert calls == [((21, 16), (16, 5), w.data_ptr())]
    assert out.shape == (3, 7, 5)
    # float32 products of 16 terms, in whatever order the library picks
    assert torch.allclose(out, torch.stack([xi @ w for xi in x]),
                          rtol=1e-6, atol=1e-6)
    xt = x.transpose(0, 1)                     # non-contiguous stack
    assert torch.allclose(ops.matmul(xt, w),
                          torch.stack([xi @ w for xi in xt]),
                          rtol=1e-6, atol=1e-6)
    calls.clear()
    ops.matmul(x, torch.randn(3, 16, 5, generator=gen))
    assert calls[0][:2] == ((3, 7, 16), (3, 16, 5))   # still batched

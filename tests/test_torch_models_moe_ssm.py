"""The port's MoE, SSM and hybrid LM stacks against the JAX package's on
the CPU.

Reduced granite-moe-1b-a400m and moonshot-v1-16b-a3b (MoE on every
layer), mamba2-1.3b (SSD on every layer) and jamba-1.5-large-398b (one
8-layer period: SSD with attention at position 3, MoE at odd positions),
with the reference's own initialized weights carried across by
``params_from_jax``.  The forward without a cache (logits and the summed
router aux loss), the prefill into a cache and three decode steps are
compared, logits and every cache leaf (float32 ``ssm_h`` among them), as
is a decode from a bf16 cache the reference filled, carried across by
``cache_from_jax``.

Tolerance 1e-4 relative to the reference's largest value (float32
configs; the two frameworks' products and transcendental functions round
differently, ~1e-6 seen).  A leaf that the cache holds in bf16 is held to
one bf16 rounding (2^-8) instead: the two sides round float32 values
that differ in their last bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        cache_to_numpy, params_from_jax)

TOL = 1e-4
BF16_TOL = 2.0 ** -8
ARCHS = ["granite_moe_1b_a400m", "moonshot_v1_16b_a3b", "mamba2_1_3b",
         "jamba_1_5_large_398b"]
#: prompt of two SSD chunks, so the inter-chunk scan runs at prefill
PROMPT, MAX_LEN = 128, 136


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


_PAIRS = {}


def _pair(arch):
    """The reference's model and weights and the port's, made once per
    architecture in this module."""
    if arch not in _PAIRS:
        jm = jreg.Model.from_config(jreg.get_config(arch).reduced())
        jp = jm.init(jax.random.PRNGKey(0))
        m = registry.Model.from_config(registry.get_config(arch).reduced())
        _PAIRS[arch] = (jm, jp, m, params_from_jax(
            jax.tree.map(np.asarray, jp), m.cfg))
    return _PAIRS[arch]


@pytest.fixture(params=ARCHS)
def pair(request):
    return _pair(request.param)


def _tokens(cfg, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, t))


def test_forward_and_aux_without_cache(pair):
    jm, jp, m, p = pair
    toks = _tokens(m.cfg, PROMPT)
    jl, jaux, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    tl, aux, tc = m.forward(p, torch.from_numpy(toks))
    assert tc is None and tl.dtype == torch.float32
    assert _rel(tl, jl) <= TOL
    if m.cfg.n_experts:
        assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) <= TOL * max(abs(float(jaux)), 1e-6)
    jl, _, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32), last_only=True)
    tl, _, _ = m.forward(p, torch.from_numpy(toks), last_only=True)
    assert tl.shape[1] == 1 and _rel(tl, jl) <= TOL


def test_prefill_and_decode_steps(pair):
    """Prefill 128 tokens into a 136-slot float32 cache, then 3 decode
    steps; logits, aux and every cache leaf agree, in the reference's
    stacked layout and dtypes."""
    jm, jp, m, p = pair
    toks = _tokens(m.cfg, PROMPT, seed=1)
    jc = jm.init_cache(2, MAX_LEN, jnp.float32)
    tc = m.init_cache(2, MAX_LEN, torch.float32)
    assert [(tuple(x.shape), str(x.dtype)[6:]) for kv in tc for x in kv] \
        == [(tuple(x.shape), str(x.dtype)) for kv in jc for x in kv]
    jl, jaux, jc = jm.forward(jp, jnp.asarray(toks, jnp.int32), cache=jc,
                              cache_pos=jnp.zeros((), jnp.int32))
    tl, aux, tc = m.forward(p, torch.from_numpy(toks), cache=tc,
                            cache_pos=0)
    assert _rel(tl, jl) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * max(abs(float(jaux)), 1e-6)
    _caches_close(tc, jc)
    for step in range(3):
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
        pos = PROMPT + step
        jl, jaux, jc = jm.forward(jp, jnp.asarray(tok, jnp.int32), cache=jc,
                                  cache_pos=jnp.asarray(pos, jnp.int32))
        tl, aux, tc = m.forward(p, torch.from_numpy(tok), cache=tc,
                                cache_pos=pos)
        assert _rel(tl, jl) <= TOL
        assert abs(float(aux) - float(jaux)) <= \
            TOL * max(abs(float(jaux)), 1e-6)
        _caches_close(tc, jc)


def test_decode_from_a_carried_bf16_cache(pair):
    """A bf16 cache the reference filled (its ssm_h float32), carried
    across by cache_from_jax with each leaf's dtype kept, decodes as the
    reference does."""
    jm, jp, m, p = pair
    toks = _tokens(m.cfg, 64, seed=2)
    jc = jm.init_cache(2, 72, jnp.bfloat16)
    jl, _, jc = jm.forward(jp, jnp.asarray(toks, jnp.int32), cache=jc,
                           cache_pos=jnp.zeros((), jnp.int32))
    jnp_cache = jax.tree.map(np.asarray, jc)
    tc = cache_from_jax(jnp_cache, dtype=torch.bfloat16)
    for pos, (tkv, jkv) in enumerate(zip(tc, jc)):
        for t, j in zip(tkv, jkv):
            assert str(t.dtype)[6:] == str(j.dtype), pos
            assert np.array_equal(t.float().numpy(),
                                  np.asarray(j, np.float32))
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
    jl, _, jc = jm.forward(jp, jnp.asarray(tok, jnp.int32), cache=jc,
                           cache_pos=jnp.asarray(64, jnp.int32))
    tl, _, tc = m.forward(p, torch.from_numpy(tok), cache=tc, cache_pos=64)
    assert _rel(tl, jl) <= TOL
    for tkv, jkv in zip(tc, jc):
        for t, j in zip(tkv, jkv):
            tol = TOL if t.dtype == torch.float32 else BF16_TOL
            assert _rel(t, j) <= tol


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m",
                                  "moonshot_v1_16b_a3b",
                                  "jamba_1_5_large_398b"])
def test_moe_impls_through_forward(arch):
    """forward's moe_impl reaches every MoE layer: dense and a2a (no
    mesh: scatter) against the reference's."""
    jm, jp, m, p = _pair(arch)
    toks = _tokens(m.cfg, 16, seed=3)
    for impl in ("dense", "a2a"):
        jl, jaux, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32),
                                 moe_impl=impl)
        tl, aux, _ = m.forward(p, torch.from_numpy(toks), moe_impl=impl)
        assert _rel(tl, jl) <= TOL
        assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


def test_mamba2_mlp_of_width_zero(monkeypatch):
    """mamba2-1.3b's config has d_ff 0 (reduced() gives 128): every layer
    carries an MLP of width 0, which adds zeros in the reference.  The
    port agrees, and launches no product for it: 2 per layer (in_proj,
    out_proj) and the vocab head."""
    import dataclasses

    from repro_torch.kernels import ops
    jcfg = dataclasses.replace(jreg.get_config("mamba2_1_3b").reduced(),
                               d_ff=0)
    cfg = dataclasses.replace(registry.get_config("mamba2_1_3b").reduced(),
                              d_ff=0)
    jm = jreg.Model.from_config(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = registry.Model.from_config(cfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    assert tuple(p["blocks"][0]["mlp"]["wg"].shape) == (cfg.n_layers,
                                                        cfg.d_model, 0)
    calls = []
    real = ops.gemm

    def spy(a, b):
        calls.append(tuple(b.shape))
        return real(a, b)

    monkeypatch.setattr(ops, "gemm", spy)
    toks = _tokens(cfg, 64, seed=4)
    jl, _, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    tl, _, _ = m.forward(p, torch.from_numpy(toks))
    assert _rel(tl, jl) <= TOL
    assert len(calls) == 2 * cfg.n_layers + 1

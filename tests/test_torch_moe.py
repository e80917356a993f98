"""The port's MoE layer against the JAX package's on the CPU.

``repro_torch.models.moe`` and ``repro.models.moe`` get the same weights
(the reference's ``init_moe``, carried across by ``params_from_jax``) and the
same numpy inputs, on reduced granite-moe (4 experts, top-2, float32).
The scatter and dense plans, the aux loss, capacity drops, the dispatch
rows and the ``a2a`` plan without a mesh are compared, against the
reference run on XLA and on its interpreted Pallas gemm
(``SCILIB_PALLAS=1``).  A router whose columns tie pins the order of
equal probabilities: the lower expert index first, as ``jax.lax.top_k``
orders them.

Tolerance 1e-4 relative to the reference's largest value (float32 on
both sides; products and transcendental functions round differently).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cfgs(**kw):
    jcfg = dataclasses.replace(
        jreg.get_config("granite_moe_1b_a400m").reduced(), **kw)
    cfg = dataclasses.replace(
        registry.get_config("granite_moe_1b_a400m").reduced(), **kw)
    return jcfg, cfg


def _params(jp, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _x(cfg, t=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)


@pytest.fixture
def pallas(request, monkeypatch):
    if request.param:
        monkeypatch.setenv("SCILIB_PALLAS", "1")
    else:
        monkeypatch.delenv("SCILIB_PALLAS", raising=False)
    return request.param


@pytest.mark.parametrize("pallas", [False, True], indirect=True)
@pytest.mark.parametrize("impl", ["scatter", "dense", "a2a"])
def test_moe_fwd_matches_reference(impl, pallas):
    jcfg, cfg = _cfgs()
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    p = _params(jp, cfg)
    x = _x(cfg)
    jout, jaux = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x), impl=impl)
    out, aux = moe.moe_fwd(p, cfg, torch.from_numpy(x), impl=impl)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert _rel(out, jout) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


def test_scatter_equals_dense_when_nothing_drops():
    """The reference's own oracle (tests/test_models.py): with capacity
    for every token, the scatter plan computes the dense plan's sum."""
    _, cfg = _cfgs(capacity_factor=8.0)
    p = params_from_jax(jax.tree.map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(2), _cfgs()[0])), cfg)
    x = torch.from_numpy(_x(cfg, t=8))
    out_s, aux_s = moe.moe_fwd(p, cfg, x, impl="scatter")
    out_d, aux_d = moe.moe_fwd(p, cfg, x, impl="dense")
    assert torch.allclose(out_s, out_d, rtol=1e-4, atol=1e-4)
    assert float(aux_s) == float(aux_d)


def test_capacity_drops_match_reference():
    """capacity_factor 0.25 over 128 tokens: 16 slots per expert against
    ~64 tokens each, so most choices drop.  The dispatch rows (kept and
    dropped alike), the output and the aux loss equal the reference's."""
    jcfg, cfg = _cfgs(capacity_factor=0.25)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    p = _params(jp, cfg)
    x = _x(cfg, t=64, seed=3)
    n = x.shape[0] * x.shape[1]
    cap = moe.capacity(cfg, n)
    assert cap == math.ceil(cfg.top_k * n * 0.25 / cfg.n_experts) == 16
    xf = x.reshape(n, -1)
    jw, jidx, _ = jmoe._route(jp, jcfg, jnp.asarray(xf))
    _, jdest = jmoe._dispatch_local(jcfg, jnp.asarray(xf), jw, jidx, cap)
    _, idx, _ = moe._route(p, cfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    dest = moe.dispatch(cfg, idx, cap)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    dropped = int((dest == cfg.n_experts * cap).sum())
    assert dropped == n * cfg.top_k - cfg.n_experts * cap
    jout, jaux = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
    out, aux = moe.moe_fwd(p, cfg, torch.from_numpy(x))
    assert _rel(out, jout) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


def test_capacity_at_decode_and_prefill():
    """8 slots at least (a decode step of batch 2), the token count at
    most; granite's 2 x 4096 prefill gets ceil(8 n 1.25 / 32)."""
    _, cfg = _cfgs()
    assert moe.capacity(cfg, 2) == 8
    full = registry.get_config("granite_moe_1b_a400m")
    assert moe.capacity(full, 2) == 8
    assert moe.capacity(full, 2 * 4096) == 2560
    assert moe.capacity(dataclasses.replace(full, capacity_factor=4.0),
                        2 * 4096) == 2 * 4096


def _tied(cls, scales, d=8):
    """A router whose logits are ``x[:, 0] * scales``: row 0 holds the
    scales, every other row is 0, so each logit is one exact product and
    equal scales give equal logits in any summation order."""
    cfg = cls(name="tied", family="moe", n_layers=2, d_model=d, n_heads=1,
              n_kv_heads=1, d_ff=16, vocab=32, n_experts=len(scales),
              top_k=2, d_ff_expert=4, dtype="float32")
    router = np.zeros((d, len(scales)), np.float32)
    router[0] = scales
    return cfg, router


def test_tied_router_puts_the_lower_index_first():
    """Probabilities [.1, .3, .3, .2, .3, .05] (up to each token's
    positive factor): jax.lax.top_k takes experts 1 and 2, lower index
    first among the three tied at .3.  The port agrees in its routing and
    its output; torch.topk orders these ties otherwise, so a port on
    torch.topk would fail here."""
    scales = np.array([.1, .3, .3, .2, .3, .05], np.float32)
    jcfg, router = _tied(JConfig, scales)
    cfg, _ = _tied(ModelConfig, scales)
    jp = dict(jmoe.init_moe(jax.random.PRNGKey(4), jcfg))
    jp["router"] = jnp.asarray(router)
    p = _params(jp, cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    xf = x.reshape(16, 8)
    _, jidx, _ = jmoe._route(jp, jcfg, jnp.asarray(xf))
    assert (np.asarray(jidx) == [1, 2]).all()
    probs = torch.softmax(torch.from_numpy(xf @ router), dim=-1)
    _, idx = moe.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # the control: torch.topk breaks these ties another way
    assert not np.array_equal(torch.topk(probs, 2).indices.numpy(),
                              np.asarray(jidx))
    for impl in ("scatter", "dense"):
        jout, _ = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x), impl=impl)
        out, _ = moe.moe_fwd(p, cfg, torch.from_numpy(x), impl=impl)
        assert _rel(out, jout) <= TOL


def test_one_launch_per_expert_product(monkeypatch):
    """The router and the three expert products are one gemm call each,
    the expert ones batched over every expert: never a loop."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.gemm

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(ops, "gemm", spy)
    _, cfg = _cfgs()
    p = params_from_jax(jax.tree.map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(5), _cfgs()[0])), cfg)
    moe.moe_fwd(p, cfg, torch.from_numpy(_x(cfg)))
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    cap = moe.capacity(cfg, 32)
    assert calls == [((32, d), (d, e)), ((e, cap, d), (e, d, ff)),
                     ((e, cap, d), (e, d, ff)), ((e, cap, ff), (e, ff, d))]


def test_unknown_impl_raises():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="impl"):
        moe.moe_fwd(None, cfg, torch.zeros(1, 1, cfg.d_model), impl="ep")

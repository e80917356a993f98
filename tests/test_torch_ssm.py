"""The port's Mamba2 SSD mixer against the JAX package's on the CPU.

``repro_torch.models.ssm`` and ``repro.models.ssm`` get the same weights
(the reference's ``init_ssm`` with its float32 vectors perturbed from
their init values, carried across by ``params_from_jax``) and the same numpy
inputs, on reduced mamba2 (d_model 64, 8 heads of 16, state 16,
float32): the causal conv with and without a state, the chunked SSD at
one chunk (T 16) and two (T 128, so the inter-chunk scan runs) with its
final state, and decode steps, against the reference on XLA and on its
interpreted Pallas gemm (``SCILIB_PALLAS=1``).

Tolerance 1e-4 relative to the reference's largest value (float32 on
both sides; products and exp round differently).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def pair():
    jcfg = jreg.get_config("mamba2_1_3b").reduced()
    cfg = registry.get_config("mamba2_1_3b").reduced()
    jp = dict(jssm.init_ssm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for name in ("conv_b", "dt_bias", "d_skip", "norm_w"):
        jp[name] = jnp.asarray(jp[name] + 0.3 * rng.standard_normal(
            jp[name].shape).astype(np.float32))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, p


@pytest.fixture
def pallas(request, monkeypatch):
    if request.param:
        monkeypatch.setenv("SCILIB_PALLAS", "1")
    else:
        monkeypatch.delenv("SCILIB_PALLAS", raising=False)
    return request.param


def _x(cfg, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)


def test_float32_parameters_stay_float32(pair):
    """Under a bf16 model the SSD's float32 vectors stay float32 (a bf16
    a_log would change every decay), the projections take bf16."""
    _, jp, cfg, _ = pair
    p = params_from_jax(jax.tree.map(np.asarray, jp),
                              dataclasses.replace(cfg, dtype="bfloat16"))
    for name, t in p.named_parameters():
        want = (torch.float32 if name in ("a_log", "dt_bias", "d_skip",
                                          "norm_w", "conv_b")
                else torch.bfloat16)
        assert t.dtype == want, name
    assert torch.equal(p["a_log"], torch.from_numpy(np.asarray(jp["a_log"])))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(pair, with_state):
    _, jp, _, p = pair
    rng = np.random.default_rng(2)
    c = jp["conv_w"].shape[1]
    xbc = rng.standard_normal((2, 5 if not with_state else 1, c)).astype(
        np.float32)
    state = rng.standard_normal((2, 3, c)).astype(np.float32) \
        if with_state else None
    jout, jst = jssm._causal_conv(
        jnp.asarray(xbc), jp["conv_w"], jp["conv_b"],
        None if state is None else jnp.asarray(state))
    out, st = ssm._causal_conv(
        torch.from_numpy(xbc), p["conv_w"], p["conv_b"],
        None if state is None else torch.from_numpy(state))
    assert _rel(out, jout) <= TOL
    if with_state:
        assert _rel(st, jst) == 0.0
    else:
        assert st is None and jst is None


@pytest.mark.parametrize("pallas", [False, True], indirect=True)
@pytest.mark.parametrize("t", [16, 128])
def test_ssd_fwd_matches_reference(pair, t, pallas):
    """One chunk (T 16) and two chunks of 64 (T 128: the scan carries a
    state across), with the final (ssm_h, conv_state)."""
    jcfg, jp, cfg, p = pair
    x = _x(cfg, t)
    jout = jssm.ssd_fwd(jp, jcfg, jnp.asarray(x))
    out = ssm.ssd_fwd(p, cfg, torch.from_numpy(x))
    assert _rel(out, jout) <= TOL
    jout, (jh, jc) = jssm.ssd_fwd(jp, jcfg, jnp.asarray(x),
                                  return_state=True)
    out, (h, c) = ssm.ssd_fwd(p, cfg, torch.from_numpy(x),
                              return_state=True)
    assert h.dtype == torch.float32
    assert tuple(h.shape) == (2, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim)
    assert _rel(out, jout) <= TOL
    assert _rel(h, jh) <= TOL
    assert _rel(c, jc) <= TOL


def test_ssd_fwd_refuses_a_partial_chunk(pair):
    """The reference asserts T % min(64, T) == 0 (ssm.py:115); the port
    raises ValueError naming the chunk."""
    jcfg, jp, cfg, p = pair
    x = _x(cfg, 100)
    with pytest.raises(AssertionError):
        jssm.ssd_fwd(jp, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="chunks of 64"):
        ssm.ssd_fwd(p, cfg, torch.from_numpy(x))


@pytest.mark.parametrize("pallas", [False, True], indirect=True)
def test_ssd_step_matches_reference(pair, pallas):
    """Three decode steps from a random state, the state carried by each
    package through its own steps."""
    jcfg, jp, cfg, p = pair
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim)).astype(np.float32)
    c0 = rng.standard_normal((2, cfg.ssm_conv - 1,
                              cfg.d_inner + 2 * cfg.ssm_state)
                             ).astype(np.float32)
    jst = (jnp.asarray(h0), jnp.asarray(c0))
    st = (torch.from_numpy(h0), torch.from_numpy(c0))
    for step in range(3):
        x = _x(cfg, 1, seed=10 + step)
        jout, jst = jssm.ssd_step(jp, jcfg, jnp.asarray(x), jst)
        out, st = ssm.ssd_step(p, cfg, torch.from_numpy(x), st)
        assert _rel(out, jout) <= TOL
        assert _rel(st[0], jst[0]) <= TOL
        assert _rel(st[1], jst[1]) <= TOL


def test_prefill_then_steps_equal_one_forward(pair):
    """The SSD's own consistency: a prefill of 64 positions into a state
    and 64 steps give the outputs of one forward over 128."""
    _, _, cfg, p = pair
    x = torch.from_numpy(_x(cfg, 128, seed=5))
    full = ssm.ssd_fwd(p, cfg, x)
    out, st = ssm.ssd_fwd(p, cfg, x[:, :64], return_state=True)
    outs = [out]
    for i in range(64, 128):
        o, st = ssm.ssd_step(p, cfg, x[:, i:i + 1], st)
        outs.append(o)
    assert _rel(torch.cat(outs, dim=1), full.numpy()) <= TOL


def test_init_ssm_state_is_whole(pair):
    """Stacked zero state: float32 ssm_h beside conv_state in the cache
    dtype, each group its own memory (never an expanded view)."""
    _, _, cfg, _ = pair
    h, c = ssm.init_ssm_state(cfg, 2, torch.bfloat16, lead=(3,))
    assert (h.dtype, c.dtype) == (torch.float32, torch.bfloat16)
    assert tuple(h.shape) == (3, 2, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim)
    assert tuple(c.shape) == (3, 2, cfg.ssm_conv - 1,
                              cfg.d_inner + 2 * cfg.ssm_state)
    h[0].fill_(1.0)
    c[1].fill_(1.0)
    assert float(h[1:].abs().sum()) == 0.0
    assert float(c[0].abs().sum()) == 0.0 and float(c[2].abs().sum()) == 0.0

"""The port's enc-dec family (whisper-tiny) against the JAX package on the
CPU.

Reduced whisper-tiny (2 encoder + 2 decoder layers, d_model 64, 32
frames, float32) with the reference's own initialized weights carried
across by ``params_from_jax``: LayerNorm, the tanh-GELU MLP and the
sinusoids; the forward without a cache; the prefill into a cache (the
fresh cross K/V replacing the placeholder) and three decode steps that
read it back; and ``Server`` generation under each placement policy,
whose tokens and every ``ServeStats`` count must equal the reference's,
with the reference on XLA and on its interpreted Pallas kernels
(``SCILIB_PALLAS=1``).  With a bf16 cache under a float32 model the
prefill's cross K/V comes back float32 in both packages, so memcopy
moves more bytes after the prefill than before it.

Tolerance 1e-5 on logits and caches, relative to the reference's largest
value (float32 on both sides; ~2e-7 seen).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as jED  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import encdec, registry  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        cache_to_numpy, params_from_jax)
from repro_torch.train import Server, ServeConfig  # noqa: E402

TOL = 1e-5
BATCH, PROMPT, GEN, MAX_LEN = 2, 12, 6, 24
POLICIES = ("dfu", "memcopy", "pinned")


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(fresh=False):
    jcfg = dataclasses.replace(jreg.get_config("whisper_tiny").reduced(),
                               prefill_fresh_kv=fresh)
    cfg = dataclasses.replace(registry.get_config("whisper_tiny").reduced(),
                              prefill_fresh_kv=fresh)
    jm = jreg.Model.from_config(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = registry.Model.from_config(cfg)
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _inputs(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, t))
    frames = rng.standard_normal((BATCH, cfg.encoder_seq,
                                  cfg.d_model)).astype(np.float32)
    return toks, frames


def test_config_is_the_references():
    for arch in ("whisper_tiny", "whisper-tiny"):
        assert dataclasses.asdict(registry.get_config(arch)) == \
            dataclasses.asdict(jreg.get_config("whisper_tiny"))


def test_layer_norm_gelu_mlp_and_sinusoid_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    got = L.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    assert _rel(got, jL.layer_norm(x, w, b)) <= TOL
    # a bf16 input comes back bf16, normalized in float32
    got = L.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                       torch.from_numpy(b))
    want = jL.layer_norm(jnp.asarray(x, jnp.bfloat16), w, b)
    assert got.dtype == torch.bfloat16 and _rel(got, want) <= 1e-2
    jp = jax.tree.map(np.asarray, jL.init_mlp(jax.random.PRNGKey(1),
                                              jreg.get_config(
                                                  "whisper_tiny").reduced()))
    assert sorted(jp) == ["b1", "b2", "w1", "w2"]
    # unit-scale weights, so the activations span GELU's curved part
    jp = {k: (rng.standard_normal(v.shape)
              / (np.sqrt(v.shape[0]) if v.ndim == 2 else 1.0)).astype(
                  np.float32) for k, v in jp.items()}
    p = {k: torch.from_numpy(v) for k, v in jp.items()}
    got = L.mlp_fwd(p, torch.from_numpy(x))
    want = jL.mlp_fwd(jp, x)
    assert _rel(got, want) <= TOL
    # PyTorch's default erf form misses the reference by over 5x the
    # tolerance (6e-5 here): the port must take jax.nn.gelu's tanh form
    h = torch.from_numpy(x) @ p["w1"] + p["b1"]
    erf = torch.nn.functional.gelu(h) @ p["w2"] + p["b2"]
    assert _rel(erf, want) > 5 * TOL
    assert _rel(encdec._sinusoid(32, 64), jED._sinusoid(32, 64)) <= TOL
    # at whisper-tiny's 1500 frames: XLA's and PyTorch's float32 exp
    # differ by one ulp in 19 of the 192 frequencies, and position 1499
    # multiplies that into ~1e-4 of angle, under bf16's 4e-3 step at 1
    assert _rel(encdec._sinusoid(1500, 384), jED._sinusoid(1500, 384)) \
        <= 3e-4


def test_init_layout_and_storage_types():
    """The reference's tree and shapes; matrices and ``pos_dec`` in
    cfg.dtype (bf16 here), the LayerNorms' w and b in float32; with
    ``master``, every leaf float32 and taking a gradient."""
    cfg = dataclasses.replace(registry.get_config("whisper_tiny").reduced(),
                              dtype="bfloat16")
    jp = jreg.Model.from_config(jreg.get_config("whisper_tiny").reduced()
                                ).init(jax.random.PRNGKey(0))
    model = registry.Model.from_config(cfg)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    got = dict(p.named_parameters())
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(got) == len(jleaves)
    for path, leaf in jleaves:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        assert tuple(got[name].shape) == leaf.shape, name
        ln = name.split(".")[-2:][0] in ("ln1", "ln2", "lnx", "ln_enc",
                                         "ln_dec")
        assert got[name].dtype == (torch.float32 if ln else torch.bfloat16)
        assert not got[name].requires_grad
    master = model.init(torch.Generator().manual_seed(0), "cpu", master=True)
    assert all(x.dtype == torch.float32 and x.requires_grad
               for x in master.parameters())


def test_forward_without_cache():
    jm, jp, m, p = _pair()
    toks, frames = _inputs(m.cfg, 10)
    jl, jaux, _ = jm.forward(jp, jnp.asarray(toks), frames=frames)
    tl, aux, tc = m.forward(p, torch.from_numpy(toks),
                            frames=torch.from_numpy(frames))
    assert tc is None and float(aux) == float(jaux) == 0.0
    assert tl.dtype == torch.float32 and _rel(tl, jl) <= TOL
    # enc_out given directly, last position only
    enc = encdec.encode(p, m.cfg, torch.from_numpy(frames))
    assert _rel(enc, jED.encode(jp, jm.cfg, frames)) <= TOL
    jl, _, _ = jm.forward(jp, jnp.asarray(toks), frames=frames,
                          last_only=True)
    tl, _, _ = m.forward(p, torch.from_numpy(toks), enc_out=enc,
                         last_only=True)
    assert tl.shape[1] == 1 and _rel(tl, jl) <= TOL


@pytest.mark.parametrize("fresh", [True, False])
def test_prefill_then_decode_steps(fresh):
    """The prefill writes the self K/V in place and replaces the cross
    placeholder with the fresh K/V; three decode steps read it back.
    Logits and every cache leaf match the reference's after each call."""
    jm, jp, m, p = _pair(fresh)
    toks, frames = _inputs(m.cfg, 8 + 3)
    jc = jm.init_cache(BATCH, MAX_LEN, jnp.float32)
    tc = m.init_cache(BATCH, MAX_LEN, torch.float32)
    placeholder = tc[1]
    jl, _, jc = jm.forward(jp, jnp.asarray(toks[:, :8]), frames=frames,
                           cache=jc, cache_pos=jnp.asarray(0, jnp.int32))
    tl, _, tc = m.forward(p, torch.from_numpy(toks[:, :8]),
                          frames=torch.from_numpy(frames), cache=tc,
                          cache_pos=0)
    assert tc[1][0] is not placeholder[0] and not placeholder[0].any()
    assert _rel(tl, jl) <= TOL
    for step in range(3):
        pos = 8 + step
        jl, _, jc = jm.forward(jp, jnp.asarray(toks[:, pos:pos + 1]),
                               cache=jc, cache_pos=jnp.asarray(pos,
                                                                jnp.int32))
        tl, _, tc = m.forward(p, torch.from_numpy(toks[:, pos:pos + 1]),
                              cache=tc, cache_pos=pos)
        assert _rel(tl, jl) <= TOL
        for tkv, jkv in zip(cache_to_numpy(tc), cache_to_numpy(jc)):
            for t, j in zip(tkv, jkv):
                assert _rel(t, j) <= TOL
    # a cache carried across from the reference decodes the same
    tc2 = cache_from_jax(jax.tree.map(np.asarray, jc), torch.float32)
    jl, _, _ = jm.forward(jp, jnp.asarray(toks[:, :1]), cache=jc,
                          cache_pos=jnp.asarray(11, jnp.int32))
    tl, _, _ = m.forward(p, torch.from_numpy(toks[:, :1]), cache=tc2,
                         cache_pos=11)
    assert _rel(tl, jl) <= TOL


def _stats(s):
    return (s.bytes_host_to_dev, s.bytes_dev_to_host, s.cache_reuses,
            s.migrations, s.tokens)


@pytest.fixture(scope="module")
def reference():
    """The reference's tokens and stats per (policy, cache dtype, pallas)
    run, its weights, the prompt and the frames."""
    cfg = jreg.get_config("whisper_tiny").reduced()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab,
                                               (BATCH, PROMPT))
    frames = np.random.default_rng(1).standard_normal(
        (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    model = jreg.Model.from_config(cfg)
    params = model.init(jax.random.PRNGKey(0))
    runs = [("dfu", "float32", False), ("dfu", "float32", True),
            ("memcopy", "float32", False), ("pinned", "float32", False),
            ("memcopy", "bfloat16", False)]
    mp = pytest.MonkeyPatch()
    got = {}
    try:
        for policy, dt, pallas in runs:
            if pallas:
                mp.setenv("SCILIB_PALLAS", "1")
            else:
                mp.delenv("SCILIB_PALLAS", raising=False)
            srv = jserve.Server(model, params, jserve.ServeConfig(
                max_len=MAX_LEN, offload_policy=policy,
                cache_dtype=getattr(jnp, dt)))
            out = srv.generate(jnp.asarray(prompt, jnp.int32), GEN,
                               {"frames": jnp.asarray(frames)})
            got[policy, dt, pallas] = (np.asarray(out), _stats(srv.stats))
    finally:
        mp.undo()
    return got, jax.tree.map(np.asarray, params), prompt, frames


def _port_server(params_np, policy, dtype=torch.float32):
    cfg = registry.get_config("whisper_tiny").reduced()
    return Server(registry.Model.from_config(cfg),
                  params_from_jax(params_np, cfg),
                  ServeConfig(max_len=MAX_LEN, offload_policy=policy,
                              cache_dtype=dtype), device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_server_matches_reference(reference, policy):
    got, params_np, prompt, frames = reference
    srv = _port_server(params_np, policy)
    out = srv.generate(torch.from_numpy(prompt), GEN,
                       {"frames": torch.from_numpy(frames)}).numpy()
    want, stats = got[policy, "float32", False]
    np.testing.assert_array_equal(out, want)
    if policy == "dfu":
        np.testing.assert_array_equal(out, got["dfu", "float32", True][0])
    assert _stats(srv.stats) == stats


def test_bf16_cache_takes_the_fresh_float32_cross_kv(reference):
    """Under a float32 model with a bf16 cache, the prefill's cross K/V
    replaces the bf16 placeholder in float32 in both packages: memcopy
    moves the bf16 tree in before the prefill and the mixed tree after
    it, byte for byte the reference's."""
    got, params_np, prompt, frames = reference
    cfg = registry.get_config("whisper_tiny").reduced()
    srv = _port_server(params_np, "memcopy", torch.bfloat16)
    out = srv.generate(torch.from_numpy(prompt), GEN,
                       {"frames": torch.from_numpy(frames)}).numpy()
    want, stats = got["memcopy", "bfloat16", False]
    assert _stats(srv.stats) == stats
    self_b = 2 * cfg.n_layers * BATCH * cfg.n_kv_heads * MAX_LEN \
        * cfg.head_dim * 2
    cross = 2 * cfg.n_layers * BATCH * cfg.n_kv_heads * cfg.encoder_seq \
        * cfg.head_dim
    assert stats[0] == (self_b + 2 * cross) + (GEN - 1) * (self_b + 4 * cross)
    np.testing.assert_array_equal(out, want)


def test_launch_serve_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "whisper_tiny", "--reduced",
                              "--batch", "2", "--prompt-len", "8", "--gen",
                              "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=whisper-tiny-smoke policy=dfu device=cpu" in out
    assert "migrations=1, cache reuses=3" in out

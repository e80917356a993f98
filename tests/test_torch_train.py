"""The port's training step and trainer, against the JAX package and on
their own, on the CPU.

* Parity: the port's ``make_train_step`` and the reference's jitted one
  take the same reduced weights (``params_from_jax(..., master=True)``)
  and the same numpy batches, 3 steps with 2 microbatches, for the dense
  (qwen1.5-4b), enc-dec (whisper-tiny), VLM (pixtral-12b) and MoE
  (granite-moe-1b-a400m) families, and under each remat mode.  Per step
  the loss agrees to 1e-5 and ``grad_norm`` to 1e-4 relative; after 3
  steps every parameter agrees to 1e-4 absolute, 1% of the peak learning
  rate 1e-2 (~1e-5 seen: float32 products and transcendentals round
  differently in XLA and PyTorch, and Adam's normalized step carries
  that into parameters whose gradients nearly cancel).  A sign flip of a
  tiny gradient would show as ~2 x lr = 2e-2 and fail.
* Every test of ``tests/test_train_infra.py`` against the port alone,
  with that file's limits, and ``test_models.py::test_smoke_train_step``
  over all ten architectures.
* The kernels inside autograd: per step, each product's launch runs
  three times (forward, dA, dB) and flash attention once, twice under
  ``remat="full"``; ``remat="dots"`` saves the 2-D products' outputs.
  dA and dB of the gemm operator (transposed views, folds, batches) and
  dq, dk, dv of the flash operator against ``jax.grad`` of the
  reference's product and attention.
* ``launch/train.py`` on the CPU; ``--mesh``/``--dry-compile`` raise.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import init_compression as jinit_compression  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import attention, gemm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_config, registry  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.optim import AdamW, init_compression  # noqa: E402
from repro_torch.train import Server, ServeConfig  # noqa: E402
from repro_torch.train import Trainer, TrainConfig, make_train_step  # noqa
from repro_torch.tree import leaves  # noqa: E402

LOSS_RTOL, GNORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-4
PEAK_LR = 1e-2


def _batch(model, rng, b=4, t=16):
    cfg = model.cfg
    toks = rng.integers(0, cfg.vocab, (b, model.text_len(t) + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for k, shape in model.extra_inputs(b, t).items():
        batch[k] = rng.standard_normal(shape).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,remat", [
    ("qwen1_5_4b", "none"), ("qwen1_5_4b", "dots"),
    ("whisper_tiny", "none"), ("whisper_tiny", "full"),
    ("pixtral_12b", "none"), ("granite_moe_1b_a400m", "none")])
def test_train_step_matches_reference(arch, remat):
    kw = dict(n_micro=2, remat=remat, moe_impl="scatter", warmup=1,
              peak_lr=PEAK_LR, steps=3)
    jm = jreg.Model.from_config(jreg.get_config(arch).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    m = registry.Model.from_config(registry.get_config(arch).reduced())
    p = params_from_jax(jax.tree.map(np.asarray, jp), m.cfg, master=True)
    assert all(x.dtype == torch.float32 and x.requires_grad
               for x in p.parameters())
    jopt, opt = JAdamW(), AdamW()
    jstep = jax.jit(jloop.make_train_step(jm, jloop.TrainConfig(**kw), jopt))
    step = make_train_step(m, TrainConfig(**kw), opt)
    jstate = (jopt.init(jp), jinit_compression(jp))
    state = (opt.init(p), init_compression(p))
    rng = np.random.default_rng(0)
    for s in range(3):
        batch = _batch(m, rng)
        jp, jos, jcs, jmet = jstep(jp, *jstate,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jnp.asarray(s, jnp.int32))
        jstate = (jos, jcs)
        p, os_, cs, met = step(p, *state, {k: torch.from_numpy(v) for k, v
                                           in batch.items()}, s)
        state = (os_, cs)
        assert float(met["lr"]) == float(jmet["lr"])
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=GNORM_RTOL)
    jl = jax.tree.leaves(jp)
    assert len(jl) == len(leaves(p))
    for a, b in zip(jl, leaves(p)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=PARAM_ATOL)
    assert int(state[0].step) == int(jstate[0].step) == 3


# ----------------------------------------------------------------------- #
# the kernels inside autograd                                              #
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_kernel_calls_per_step(monkeypatch, remat):
    """One step of reduced whisper-tiny (no MoE: every product is 2-D and
    both of its operands take a gradient).  The gemm launch runs 3 x
    the forward's products (under dots too: the recompute reuses the
    saved outputs; under full 4 x); flash runs as often as in the
    forward (under dots and full twice: the recompute runs it again),
    and never in the backward."""
    cfg = get_config("whisper_tiny").reduced()
    model = Model.from_config(cfg)
    calls = {"gemm": 0, "flash": 0}
    real_gemm, real_flash = gemm._gemm, attention._flash

    def spy_gemm(*a, **kw):
        calls["gemm"] += 1
        return real_gemm(*a, **kw)

    def spy_flash(*a, **kw):
        calls["flash"] += 1
        return real_flash(*a, **kw)

    monkeypatch.setattr(gemm, "_gemm", spy_gemm)
    monkeypatch.setattr(attention, "_flash", spy_flash)
    params = model.init(torch.Generator().manual_seed(0), "cpu", master=True)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(model, np.random.default_rng(1), b=2, t=12).items()}
    model.forward(params, batch["tokens"], frames=batch["frames"])
    fwd = dict(calls)
    # per layer: encoder q k v o + 2 MLP; decoder self 4, cross q k v o,
    # 2 MLP; the tied head
    assert fwd["gemm"] == 6 * cfg.encoder_layers + 10 * cfg.n_layers + 1
    # encoder self, decoder self and cross attention: all Tq >= 8
    assert fwd["flash"] == cfg.encoder_layers + 2 * cfg.n_layers
    calls.update(gemm=0, flash=0)
    opt = AdamW()
    step = make_train_step(model, TrainConfig(remat=remat), opt)
    step(params, opt.init(params), init_compression(params), batch, 0)
    gemms = {"none": 3, "dots": 3, "full": 4}[remat] * fwd["gemm"]
    flashes = (1 if remat == "none" else 2) * fwd["flash"]
    assert (calls["gemm"], calls["flash"]) == (gemms, flashes)


_OPERAND_CASES = {
    "2-D": ((24, 16), (16, 20), False, False),
    "A transposed view": ((16, 24), (16, 20), True, False),
    "B transposed view": ((24, 16), (20, 16), False, True),
    "3-D A, 2-D B (fold)": ((3, 24, 16), (16, 20), False, False),
    "batched": ((3, 24, 16), (3, 16, 20), False, False),
}


@pytest.mark.parametrize("case", list(_OPERAND_CASES))
def test_gemm_gradients_match_jax_grad(case):
    """dA and dB of ``ops.matmul`` through the gemm operator against
    ``jax.grad`` of the reference's product, on the same float32 inputs:
    transposed views, the fold of a 3-D activation against a 2-D weight
    (dB summed over the fold) and batched products."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops
    sa, sb, ta, tb = _OPERAND_CASES[case]
    rng = np.random.default_rng(7)
    an = rng.standard_normal(sa).astype(np.float32)
    bn = rng.standard_normal(sb).astype(np.float32)
    a_of = (lambda x: x.mT) if ta else (lambda x: x)
    b_of = (lambda x: x.mT) if tb else (lambda x: x)
    ja_of = (lambda x: x.T) if ta else (lambda x: x)
    jb_of = (lambda x: x.T) if tb else (lambda x: x)
    a = torch.from_numpy(an).requires_grad_()
    b = torch.from_numpy(bn).requires_grad_()
    c = ops.matmul(a_of(a), b_of(b))
    assert c.grad_fn is not None
    wn = rng.standard_normal(tuple(c.shape)).astype(np.float32)
    da, db = torch.autograd.grad((c * torch.from_numpy(wn)).sum(), (a, b))
    jda, jdb = jax.grad(lambda x, y: jnp.sum(
        jref.matmul(ja_of(x), jb_of(y)) * wn), argnums=(0, 1))(an, bn)
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape,strided,copied", [
    ((96, 51), False, True), ((3, 96, 51), False, True),
    ((96, 48), False, False), ((96, 48), True, True)])
def test_backward_pads_a_gradient_path_1_cannot_read(shape, strided,
                                                     copied):
    """The incoming gradient of the gemm operator's backward: a bf16 dC
    whose row stride TMA cannot describe (odd N, as whisper's vocab
    head) or that no layout reads is copied into rows padded to a
    multiple of 8, which plans both backward products on path 1; an
    aligned one goes in as it is."""
    rng = np.random.default_rng(9)
    full = torch.from_numpy(rng.standard_normal(
        shape[:-1] + (2 * shape[-1],)).astype(np.float32)).bfloat16()
    x = full[..., ::2] if strided else full[..., :shape[-1]].contiguous()
    got = gemm._matrix(x)
    assert torch.equal(got, x) and (got.data_ptr() != x.data_ptr()) == copied
    assert got.stride(-2) % 8 == 0 and got.stride(-1) == 1
    a = torch.zeros(shape[:-2] + (shape[-2], 64), dtype=torch.bfloat16)
    b = torch.zeros(shape[:-2] + (shape[-1], 64), dtype=torch.bfloat16)
    assert gemm.plan(got, b).path == gemm.TC
    assert gemm.plan(a.mT, got).path == gemm.TC


def test_gemm_out_dtype_takes_no_gradient():
    """An ``out_dtype`` product has no operator behind it: under autograd
    it raises rather than return a result cut off from the graph."""
    a = torch.ones(8, 8, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(TypeError, match="out_dtype"):
        gemm.gemm(a, torch.ones(8, 8, dtype=torch.bfloat16),
                  out_dtype=torch.float32)
    with torch.no_grad():
        assert gemm.gemm(a, torch.ones(8, 8, dtype=torch.bfloat16),
                         out_dtype=torch.float32).dtype == torch.float32


@pytest.mark.parametrize("causal,tk,hkv", [(True, 24, 2), (False, 24, 4),
                                           (False, 37, 2)])
def test_flash_gradients_match_jax_grad(causal, tk, hkv):
    """dq, dk, dv of the flash operator (its backward recomputes the plain
    formulation) against ``jax.grad`` of the reference's attention: causal
    with 2 query heads per KV head, non-causal, and cross-attention at a
    ragged key length."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(8)
    qn = rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
    kn = rng.standard_normal((2, hkv, tk, 16)).astype(np.float32)
    vn = rng.standard_normal((2, hkv, tk, 16)).astype(np.float32)
    wn = rng.standard_normal(qn.shape).astype(np.float32)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    out = attention.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(wn)).sum(), (q, k, v))
    want = jax.grad(lambda x, y, z: jnp.sum(jref.attention(
        x, y, z, causal=causal) * wn), argnums=(0, 1, 2))(qn, kn, vn)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_no_grad_path_is_the_wrappers_alone(monkeypatch):
    """Serving (no gradient) never enters the autograd operators."""
    called = []
    monkeypatch.setattr(gemm, "gemm_grad",
                        lambda *a: called.append(1) or None)
    cfg = get_config("qwen1_5_4b").reduced()
    model = Model.from_config(cfg)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    out, _, _ = model.forward(p, torch.zeros(1, 8, dtype=torch.long))
    assert called == [] and not out.requires_grad


# ----------------------------------------------------------------------- #
# tests/test_train_infra.py, against the port                             #
# ----------------------------------------------------------------------- #
def _mk(steps=6, ckpt=None, **kw):
    cfg = get_config("qwen1_5_4b").reduced()
    m = Model.from_config(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=24,
                                    global_batch=4))
    tcfg = TrainConfig(steps=steps, ckpt_every=3, log_every=100,
                       warmup=2, moe_impl="dense", **kw)
    return Trainer(m, pipe, tcfg, ckpt_dir=ckpt, device="cpu"), m


def test_loss_decreases():
    tr, _ = _mk(steps=10)
    hist = tr.fit(verbose=False)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_checkpoint_restart_exact():
    with tempfile.TemporaryDirectory() as d:
        tr1, _ = _mk(steps=9, ckpt=d)
        tr1.fit(steps=6, verbose=False)
        tr2, _ = _mk(steps=9, ckpt=d)
        tr2.fit(verbose=False)
        assert tr2.step == 9
        with tempfile.TemporaryDirectory() as d2:
            tr3, _ = _mk(steps=9, ckpt=d2)
            tr3.fit(verbose=False)
        for a, b in zip(leaves(tr2.params), leaves(tr3.params)):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_microbatch_equivalence():
    h1 = _mk(steps=3, n_micro=1)[0].fit(verbose=False)
    h2 = _mk(steps=3, n_micro=2)[0].fit(verbose=False)
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) < 1e-3


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equivalence(remat):
    h1 = _mk(steps=2, remat="none")[0].fit(verbose=False)
    h2 = _mk(steps=2, remat=remat)[0].fit(verbose=False)
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) < 1e-4


def test_grad_compress_close_but_not_exact():
    h1 = _mk(steps=4, grad_compress=False)[0].fit(verbose=False)
    h2 = _mk(steps=4, grad_compress=True)[0].fit(verbose=False)
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) < 0.1
    assert h1[-1]["loss"] != h2[-1]["loss"]


def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8)
    p1 = TokenPipeline(cfg, num_shards=1)
    p4 = TokenPipeline(cfg, num_shards=4)
    torch.testing.assert_close(p1.batch(5)["tokens"], p1.batch(5)["tokens"],
                               rtol=0, atol=0)
    g = p4.global_batch(5)
    assert g["tokens"].shape == (8, 16)
    full = p1.batch(3)
    assert full["tokens"].shape == (8, 16)
    # labels are the next-token shift of the same draw
    assert torch.equal(full["tokens"][:, 1:], full["labels"][:, :-1])


def test_checkpoint_store_atomic_and_prune():
    from repro_torch.checkpoint import CheckpointStore
    with tempfile.TemporaryDirectory() as d:
        store = CheckpointStore(d, keep=2)
        tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3))}}
        for s in (1, 2, 3):
            store.save(s, tree, blocking=True)
        assert store.latest_step() == 3
        assert sorted(os.listdir(d)) == ["step_2", "step_3"]
        restored, manifest = store.restore(tree)
        assert torch.equal(restored["a"], tree["a"])
        assert manifest["step"] == 3


def test_serve_policies_identical_output():
    cfg = get_config("qwen1_5_4b").reduced()
    m = Model.from_config(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    prompt = torch.ones((2, 8), dtype=torch.long)
    outs = {}
    for pol in ("dfu", "memcopy", "pinned"):
        srv = Server(m, params, ServeConfig(max_len=32, offload_policy=pol,
                                            cache_dtype=torch.float32),
                     device="cpu")
        outs[pol] = srv.generate(prompt, 8)
        if pol == "dfu":
            assert srv.stats.migrations == 1
            assert srv.stats.cache_reuses >= 6
    assert torch.equal(outs["dfu"], outs["memcopy"])
    assert torch.equal(outs["dfu"], outs["pinned"])


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_smoke_train_step(arch):
    """``test_models.py::test_smoke_train_step`` against the port."""
    cfg = get_config(arch).reduced()
    m = Model.from_config(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu", master=True)
    opt = AdamW()
    step = make_train_step(m, TrainConfig(n_micro=1, remat="none",
                                          moe_impl="dense"), opt)
    b, t = 2, 16
    tokens = torch.randint(0, cfg.vocab, (b, m.text_len(t)),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    for k, shape in m.extra_inputs(b, t).items():
        batch[k] = torch.randn(shape, generator=torch.Generator())
    l0 = leaves(params)[0].detach().clone()
    params2, _, _, metrics = step(params, opt.init(params),
                                  init_compression(params), batch, 1)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.allclose(l0, leaves(params2)[0])


# ----------------------------------------------------------------------- #
# the entry point                                                          #
# ----------------------------------------------------------------------- #
def test_launch_train_runs_on_the_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        assert launch_train.main([
            "--arch", "whisper_tiny", "--reduced", "--steps", "4",
            "--batch", "2", "--seq", "8", "--ckpt-dir", d,
            "--ckpt-every", "2", "--device", "cpu"]) == 0
        assert sorted(os.listdir(d)) == ["step_2", "step_4"]
    out = capsys.readouterr().out
    assert "after 4 steps" in out and "device cpu" in out


@pytest.mark.parametrize("flags", [["--mesh", "multi"], ["--dry-compile"]])
def test_launch_train_mesh_paths_wait_for_item_11d(flags, capsys):
    """Either flag alone trains as without it, as the reference's
    launcher does (only both together run the dry run,
    ``tests/test_torch_sharding.py``)."""
    assert launch_train.main([
        "--arch", "qwen1_5_4b", "--reduced", "--steps", "2", "--batch", "2",
        "--seq", "8", "--device", "cpu"] + flags) == 0
    out = capsys.readouterr().out
    assert "after 2 steps" in out and "device cpu" in out
    assert "[ok" not in out


def test_trainer_and_launcher_run_on_the_card_unless_asked(monkeypatch):
    """Without CUDA, the trainer and the driver raise unless given the
    CPU; they never fall back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen1_5_4b").reduced()
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=8,
                                    global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Model.from_config(cfg), pipe, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen1_5_4b", "--reduced"])
    model = Model.from_config(dataclasses.replace(
        get_config("whisper_tiny").reduced()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(model, None, ServeConfig())

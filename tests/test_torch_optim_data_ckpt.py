"""The port's optimizer, schedule, gradient compression, data pipeline,
checkpoints and tree order against the JAX package on the CPU, and the
port's independence from it.

* ``AdamW.update`` (clip on and off), ``cosine_schedule`` and
  ``compress_decompress`` take the same float32 inputs as the
  reference's and agree to float32 rounding (AdamW: 1e-6 relative on
  parameters and moments; the schedule: equal; int8 compression: equal
  codes, so equal values and residuals).
* The data pipeline: each batch a pure function of (seed, step, shard),
  the reference's Zipf CDF and EOS rate, labels the next-token shift;
  its bits are its own (the reference draws with threefry).
* Checkpoints: the port's leaf order is ``jax.tree.flatten``'s, so a
  trainer state written by either package restores in the other,
  leaf for leaf; async saves, pruning, and errors.
* ``src/repro_torch`` imports neither ``jax`` nor ``repro``.
"""
import ast
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JPipeline  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import compress_decompress as jcompress  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.optim import init_compression as jinit_compression  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import (AdamW, CompressionState,  # noqa: E402
                               compress_decompress, cosine_schedule,
                               init_compression)
from repro_torch.optim.adamw import OptState  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": ({"a": rng.standard_normal(7).astype(np.float32)},
                       {"a": rng.standard_normal(7).astype(np.float32)}),
            "b": rng.standard_normal((3,)).astype(np.float32)}


@pytest.mark.parametrize("grad_clip", [1.0, 0.0, 1e3])
def test_adamw_matches_reference(grad_clip):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt = JAdamW(grad_clip=grad_clip)
    opt = AdamW(grad_clip=grad_clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = [torch.from_numpy(x.copy()) for x in jax.tree.leaves(params)]
    ts = opt.init(tp)
    for step in range(4):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                        * 3).astype(np.float32), params)
        lr = np.float32(1e-2 * (step + 1))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                             jnp.asarray(lr))
        tp, ts = opt.update([torch.from_numpy(g) for g in
                             jax.tree.leaves(grads)], ts, tp,
                            torch.tensor(lr))
    for got, want in ((tp, jax.tree.leaves(jp)), (ts.mu, js.mu),
                      (ts.nu, js.nu)):
        for g, w in zip(got, jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    assert int(ts.step) == int(js.step) == 4


def test_cosine_schedule_matches_reference():
    for step in (0, 1, 5, 19, 20, 21, 57, 99, 100, 150):
        kw = dict(peak_lr=3e-4, warmup=20, total=100)
        got = cosine_schedule(step, **kw)
        assert got.dtype == torch.float32
        assert float(got) == float(jcosine(step, **kw))


def test_compress_decompress_matches_reference():
    """Equal int8 codes (round half to even in both), so equal values and
    residuals, over two steps of error feedback; ties included."""
    rng = np.random.default_rng(1)
    grads = _tree(rng)
    # a tie: 0.5 of a quantization step, which rounds to even
    grads["b"] = np.array([127.0, 0.5, 1.5], np.float32)
    jstate = jinit_compression(grads)
    state = init_compression([torch.from_numpy(g)
                              for g in jax.tree.leaves(grads)])
    for _ in range(2):
        jout, jstate = jcompress(jax.tree.map(jnp.asarray, grads), jstate)
        out, state = compress_decompress(
            [torch.from_numpy(g) for g in jax.tree.leaves(grads)], state)
        for g, w in zip(out, jax.tree.leaves(jout)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(state.residual, jax.tree.leaves(jstate.residual)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-7)
    assert isinstance(state, CompressionState)


def test_pipeline_is_a_pure_function_with_the_references_distribution():
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=8, doc_len=16)
    p1, p4 = TokenPipeline(cfg), TokenPipeline(cfg, num_shards=4)
    assert torch.equal(p1.batch(5)["tokens"], TokenPipeline(cfg).batch(5)[
        "tokens"])
    assert not torch.equal(p1.batch(5)["tokens"], p1.batch(6)["tokens"])
    other = TokenPipeline(DataConfig(vocab=1000, seq_len=64, global_batch=8,
                                     doc_len=16, seed=7))
    assert not torch.equal(p1.batch(5)["tokens"], other.batch(5)["tokens"])
    g = p4.global_batch(5)
    assert torch.equal(g["tokens"][2:4], p4.batch(5, 1)["tokens"])
    assert g["tokens"].dtype == torch.int64
    it = p1.iter_from(3)
    assert torch.equal(next(it)["tokens"], p1.batch(3)["tokens"])
    assert torch.equal(next(it)["tokens"], p1.batch(4)["tokens"])
    jp = JPipeline(JDataConfig(vocab=1000, seq_len=64, global_batch=8,
                               doc_len=16))
    np.testing.assert_array_equal(p1._cdf.numpy(), np.asarray(jp._cdf))
    # the same distribution: EOS rate near 1/16 and Zipf's head heavy
    toks = torch.cat([p1.batch(s)["tokens"] for s in range(40)])
    jtoks = np.concatenate([np.asarray(jp.batch(s)["tokens"])
                            for s in range(40)])
    for t in (toks.numpy(), jtoks):
        assert abs((t == 0).mean() - (1 / 16 + 0.2)) < 0.03
        assert (t < 10).mean() > 0.5 and t.max() < 1000
    with pytest.raises(ValueError, match="multiple of num_shards"):
        TokenPipeline(cfg, num_shards=3)


def test_tree_order_is_jax_flatten_order():
    """The trainer's state tree, as the port holds it (Params, lists,
    NamedTuples), flattens in the reference's order; unflatten rebuilds
    it."""
    jcfg = jreg.get_config("whisper_tiny").reduced()
    jp = jreg.Model.from_config(jcfg).init(jax.random.PRNGKey(0))
    cfg = registry.get_config("whisper_tiny").reduced()
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, master=True)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = leaves(p)
    assert len(got) == len(jflat)
    for t, (_, a) in zip(got, jflat):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(a))
    tree = {"params": p, "opt": AdamW().init(p),
            "comp": init_compression(p)}
    flat = leaves(tree)
    back = unflatten(tree, [x.detach().clone() for x in flat])
    assert isinstance(back["opt"], OptState)
    assert all(x.requires_grad for x in back["params"].parameters())
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), flat))
    with pytest.raises(ValueError, match="more leaves"):
        unflatten(tree, flat + [flat[0]])


def _states(steps):
    """The reference's and the port's trainer state for reduced qwen, the
    port's carried across from the reference's after ``steps`` updates."""
    jcfg = jreg.get_config("qwen1_5_4b").reduced()
    jp = jreg.Model.from_config(jcfg).init(jax.random.PRNGKey(0))
    jopt = JAdamW()
    js = jopt.init(jp)
    rng = np.random.default_rng(2)
    for _ in range(steps):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), jp)
        jp, js = jopt.update(g, js, jp, jnp.asarray(1e-3, jnp.float32))
    jstate = {"params": jp, "opt": js, "comp": jinit_compression(jp)}
    cfg = registry.get_config("qwen1_5_4b").reduced()
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, master=True)
    state = {"params": p, "opt": AdamW().init(p),
             "comp": init_compression(p)}
    return jstate, state


def test_checkpoint_crosses_between_the_packages():
    """A trainer state saved by the reference restores in the port, and
    the port's save of it restores in the reference, leaf for leaf."""
    jstate, state = _states(2)
    with tempfile.TemporaryDirectory() as d:
        JStore(d).save(2, jstate, blocking=True)
        got, manifest = CheckpointStore(d).restore(state)
        assert manifest["step"] == 2 and int(got["opt"].step) == 2
        for t, a in zip(leaves(got), jax.tree.leaves(jstate)):
            np.testing.assert_array_equal(t.detach().numpy(), np.asarray(a))
    with tempfile.TemporaryDirectory() as d:
        CheckpointStore(d).save(5, got, blocking=True)
        back, manifest = JStore(d).restore(jstate)
        assert manifest["step"] == 5
        for a, t in zip(jax.tree.leaves(back), leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), t.detach().numpy())
        names = sorted(os.listdir(os.path.join(d, "step_5")))
        assert names == sorted(["manifest.json"] + [
            f"leaf_{i}.npy" for i in range(len(leaves(got)))])


def test_async_save_copies_before_returning_and_errors_surface():
    x = torch.arange(6.0)
    with tempfile.TemporaryDirectory() as d:
        store = CheckpointStore(d, keep=1)
        store.save(1, {"x": x}, blocking=False)
        x.add_(100.0)                       # training goes on meanwhile
        store.wait()
        got, _ = store.restore({"x": x})
        assert torch.equal(got["x"], torch.arange(6.0))
        store.save(2, {"x": x.bfloat16()}, blocking=True)
        got, manifest = store.restore({"x": x.bfloat16()})
        assert got["x"].dtype == torch.bfloat16
        assert manifest["leaves"][0]["dtype"] == "bfloat16"
        assert sorted(os.listdir(d)) == ["step_2"]
        with pytest.raises(ValueError, match="holds 1 leaves"):
            store.restore({"x": x, "y": x})
        with pytest.raises(ValueError, match="shape"):
            store.restore({"x": torch.zeros(3)})
        # a file where the writer makes its step_3.tmp/ directory
        open(os.path.join(d, "step_3.tmp"), "w").close()
        store.save(3, {"x": x}, blocking=False)
        with pytest.raises(FileExistsError):
            store.wait()
        store.wait()                        # raised once, then clear
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            CheckpointStore(d).restore({"x": x})


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_port_imports_neither_jax_nor_the_reference():
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300)

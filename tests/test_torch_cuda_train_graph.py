"""The trainer's captured step on the card.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py

``Trainer.fit`` on the card warms its step up once (eagerly, on a side
stream), then captures it in one CUDA graph and replays it per step
(``train/loop.py``).  The reduced configs of qwen1.5-4b (dense) and
whisper-tiny (enc-dec, with frames), with seeded random weights made on
the card, are held to ``make_train_step`` called from Python with host
integer steps on the same weights and batches, under deterministic
algorithms (the embedding's accumulating backward then sums in a fixed
order):

* losses, learning rates and gradient norms equal, and every parameter,
  moment and residual bit for bit, under remat none, dots and full, two
  microbatches, with and without ``grad_compress``;
* a second fit replays without capturing; another batch shape captures
  anew;
* the launch counters move per replay as per eager step, the backward's
  products included;
* a replay makes no host sync (``set_sync_debug_mode("error")``);
* a restore from a mid-run checkpoint after the capture replays the rest
  of the run bit for bit;
* a step that cannot be captured raises: no eager fallback.
"""
import dataclasses
import importlib
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.optim import init_compression  # noqa: E402
from repro_torch.train import Trainer, TrainConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

pytestmark = pytest.mark.cuda

BATCH, SEQ, STEPS = 4, 32, 4
COUNTERS = {"gemm": ("launches", "reduce_launches"),
            "attention": ("launches", "copies")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda", 0)
    torch.use_deterministic_algorithms(False)


def _setup(arch, dev, seq=SEQ, **kw):
    cfg = get_config(arch).reduced()
    model = Model.from_config(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=BATCH))
    extra_fn = None
    if cfg.family == "encdec":
        def extra_fn(step):
            gen = torch.Generator().manual_seed(100 + step)
            return {"frames": torch.randn(BATCH, cfg.encoder_seq,
                                          cfg.d_model, generator=gen)}
    tcfg = TrainConfig(steps=STEPS, warmup=2, peak_lr=1e-2, n_micro=2,
                       **kw)
    return model, pipe, tcfg, extra_fn


def _batch(pipe, extra_fn, step, dev):
    batch = pipe.global_batch(step)
    if extra_fn is not None:
        batch.update(extra_fn(step))
    return {k: v.to(dev) for k, v in batch.items()}


def _state(tr):
    return [x.detach().clone() for x in leaves(tr._state_tree())]


def _eager(model, pipe, tcfg, extra_fn, dev, steps=STEPS):
    """The same run with the step called from Python at host ints."""
    tr = Trainer(model, pipe, tcfg, extra_batch_fn=extra_fn, device=dev)
    step = make_train_step(model, tcfg, tr.opt)
    params, opt, comp = tr.params, tr.opt_state, tr.comp_state
    hist = []
    for s in range(steps):
        params, opt, comp, met = step(params, opt, comp,
                                      _batch(pipe, extra_fn, s, dev), s)
        hist.append({k: float(v) for k, v in met.items()})
    tr.params, tr.opt_state, tr.comp_state = params, opt, comp
    return hist, _state(tr)


CASES = [("qwen1_5_4b", "none", False), ("qwen1_5_4b", "dots", False),
         ("qwen1_5_4b", "full", False), ("qwen1_5_4b", "none", True),
         ("whisper_tiny", "none", False), ("whisper_tiny", "dots", True)]


@pytest.mark.parametrize("arch,remat,compress", CASES)
def test_replays_equal_the_eager_steps(arch, remat, compress, dev):
    model, pipe, tcfg, extra_fn = _setup(arch, dev, remat=remat,
                                         grad_compress=compress)
    tr = Trainer(model, pipe, tcfg, extra_batch_fn=extra_fn, device=dev)
    hist = tr.fit(verbose=False)
    assert tr.replays == STEPS - 1
    want_hist, want = _eager(model, pipe, tcfg, extra_fn, dev)
    assert hist == want_hist
    got = _state(tr)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(tr.opt_state.step) == STEPS


def test_a_second_fit_replays_another_shape_captures(dev):
    model, pipe, tcfg, extra_fn = _setup("qwen1_5_4b", dev)
    tr = Trainer(model, pipe, tcfg, extra_batch_fn=extra_fn, device=dev)
    tr.fit(verbose=False)
    graph = tr.graphed.graph
    tr.fit(steps=STEPS + 2, verbose=False)
    assert tr.graphed.graph is graph and tr.replays == STEPS + 1
    # a longer sequence: the next step warms up, the one after captures
    tr.pipe = TokenPipeline(DataConfig(vocab=model.cfg.vocab,
                                       seq_len=2 * SEQ, global_batch=BATCH))
    hist = tr.fit(steps=STEPS + 5, verbose=False)
    assert tr.graphed.graph is not graph and tr.replays == STEPS + 3
    assert len(hist) == STEPS + 5
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)


def _counts():
    out = {}
    for mod, names in COUNTERS.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        out.update({f"{mod}.{n}": getattr(m, n) for n in names})
    from repro_torch.kernels import attention
    out.update({f"attention.{k}": v
                for k, v in attention.launches_by_path.items()})
    return out


def _reset():
    for mod in COUNTERS:
        importlib.import_module(f"repro_torch.kernels.{mod}").reset_launches()


@pytest.mark.parametrize("arch,remat", [("whisper_tiny", "none"),
                                        ("qwen1_5_4b", "dots")])
def test_a_replay_counts_an_eager_step(arch, remat, dev):
    model, pipe, tcfg, extra_fn = _setup(arch, dev, remat=remat)
    tr = Trainer(model, pipe, tcfg, extra_batch_fn=extra_fn, device=dev)
    tr.fit(steps=2, verbose=False)
    batch = _batch(pipe, extra_fn, 2, dev)
    step = make_train_step(model, tcfg, tr.opt)
    copy = unflatten(tr.params, [x.detach().clone().requires_grad_()
                                 for x in leaves(tr.params)])
    _reset()
    step(copy, tr.opt.init(copy), init_compression(copy), batch, 2)
    eager = _counts()
    _reset()
    tr._card_step(batch)
    replay = _counts()
    assert replay == eager
    assert eager["gemm.launches"] > 0
    assert tr.replays == 2


def test_a_replay_makes_no_host_sync(dev):
    model, pipe, tcfg, extra_fn = _setup("whisper_tiny", dev,
                                         remat="dots", grad_compress=True)
    tr = Trainer(model, pipe, tcfg, extra_batch_fn=extra_fn, device=dev)
    tr.fit(steps=2, verbose=False)
    batch = _batch(pipe, extra_fn, 2, dev)
    tr.step = 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = tr._card_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tr.replays == 2
    assert torch.isfinite(metrics["loss"]).item()


def test_a_restore_after_the_capture_replays_bit_for_bit(dev, tmp_path):
    """Six steps with a checkpoint every three; then the step-6
    checkpoint is removed and the same Trainer fits again: it restores
    step 3 into the graph's buffers and replays steps 3-5, ending on the
    first run's weights and losses."""
    model, pipe, tcfg, extra_fn = _setup("whisper_tiny", dev,
                                         grad_compress=True)
    tcfg = dataclasses.replace(tcfg, steps=6, ckpt_every=3)
    tr = Trainer(model, pipe, tcfg, ckpt_dir=str(tmp_path),
                 extra_batch_fn=extra_fn, device=dev)
    hist = list(tr.fit(verbose=False))
    want = _state(tr)
    graph = tr.graphed.graph
    tr.store.wait()
    shutil.rmtree(tmp_path / "step_6")
    again = tr.fit(verbose=False)
    assert tr.graphed.graph is graph and tr.replays == 5 + 3
    assert again[6:] == hist[3:]
    for a, b in zip(_state(tr), want):
        assert torch.equal(a, b)
    # a fresh Trainer from the step-3 checkpoint: warm-up, capture, replay
    shutil.rmtree(tmp_path / "step_6")
    fresh = Trainer(model, pipe, tcfg, ckpt_dir=str(tmp_path),
                    extra_batch_fn=extra_fn, device=dev)
    rest = fresh.fit(verbose=False)
    assert rest == hist[3:] and fresh.replays == 2
    for a, b in zip(_state(fresh), want):
        assert torch.equal(a, b)


def test_a_failed_capture_raises(dev, monkeypatch):
    """A host read inside the step cannot be captured: the capture raises
    and nothing runs the step eagerly in its place."""
    model, pipe, tcfg, extra_fn = _setup("qwen1_5_4b", dev)
    tr = Trainer(model, pipe, tcfg, extra_batch_fn=extra_fn, device=dev)
    real, calls = tr._step_fn, []

    def reading(params, opt, comp, batch, step):
        calls.append(step)
        if len(calls) > 1:
            int(step)       # a host read: illegal while capturing
        return real(params, opt, comp, batch, step)

    tr._step_fn = reading
    with pytest.raises(RuntimeError):
        tr.fit(verbose=False)
    assert len(calls) == 2 and tr.replays == 0 and tr.step == 1
    torch.cuda.synchronize()

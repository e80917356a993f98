"""A step count on the device, the input of the captured train step,
against the host integer and against the JAX package on the CPU.

The reference jits its step and passes the count as
``jnp.asarray(self.step, jnp.int32)`` (``repro/train/loop.py:153,
197-200``); the port's captured step (``train/loop.py``
``Trainer._card_step``) passes a 0-d int32 tensor, which the cosine
schedule and AdamW's bias correction read on the device, and keeps its
state in its own buffers (``Trainer._update`` copies the optimizer's new
step count and the new compression residuals back into them).  For the
reduced qwen1.5-4b (dense) and whisper-tiny (enc-dec, with frames), two
microbatches, under remat none, dots and full and with ``grad_compress``:

* the step at an int32 tensor count against the same step at the host
  integer, over 3 steps: metrics and every parameter, moment, step count
  and residual bit for bit (the same operations on the same values);
  and ``Trainer.fit`` (``Trainer._update``, the captured step's body,
  state in place) against the functional step at host integers, bit for
  bit;
* the tensor-count step against the reference's jitted step fed
  ``jnp.asarray(s, jnp.int32)``, with ``tests/test_torch_train.py``'s
  tolerances: loss 1e-5 and grad_norm 1e-4 relative per step, every
  parameter within 1e-4 after 3 steps (1% of the peak lr 1e-2).  Not
  under ``grad_compress``: its int8 rounding turns a float32 ulp between
  XLA and PyTorch into a whole quantum (max|g|/127) on the odd element,
  an Adam step of ~lr there (whisper-tiny: 2 of 16384 weights 3.7e-4
  off); ``tests/test_torch_optim_data_ckpt.py`` holds the compression to
  the reference on equal inputs;
* no ``item``/``tolist``/``bool``/``int``/``float``/``index`` in a step
  at a tensor count, the backward and the optimizer included.

The card's capture and replay are ``tests/test_torch_cuda_train_graph.py``.
"""
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
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import AdamW, init_compression  # noqa: E402
from repro_torch.train import Trainer, TrainConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

LOSS_RTOL, GNORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-4
PEAK_LR = 1e-2
STEPS = 3

CASES = [("qwen1_5_4b", "none", False), ("qwen1_5_4b", "dots", False),
         ("qwen1_5_4b", "full", False), ("qwen1_5_4b", "dots", True),
         ("whisper_tiny", "none", True), ("whisper_tiny", "full", False)]


def _kw(remat, compress):
    return dict(n_micro=2, remat=remat, grad_compress=compress,
                moe_impl="scatter", warmup=1, peak_lr=PEAK_LR, steps=STEPS)


def _batches(model, seed=0, b=4, t=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, model.cfg.vocab, (b, model.text_len(t) + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for k, shape in model.extra_inputs(b, t).items():
            batch[k] = rng.standard_normal(shape).astype(np.float32)
        out.append(batch)
    return out


def _fresh(model, seed=0):
    params = model.init(torch.Generator().manual_seed(seed), "cpu",
                        master=True)
    opt = AdamW()
    return params, opt, opt.init(params), init_compression(params)


def _run(model, tcfg, count):
    """STEPS steps from seed-0 weights, each count made by ``count``;
    (metrics per step, every state leaf after)."""
    params, opt, ostate, cstate = _fresh(model)
    step = make_train_step(model, tcfg, opt)
    mets = []
    for s, batch in enumerate(_batches(model)):
        params, ostate, cstate, met = step(
            params, ostate, cstate,
            {k: torch.from_numpy(v) for k, v in batch.items()}, count(s))
        mets.append({k: v.clone() for k, v in met.items()})
    state = [x.detach().clone() for x in leaves(
        {"params": params, "opt": ostate, "comp": cstate})]
    return mets, state


def _int32(s):
    return torch.tensor(s, dtype=torch.int32)


@pytest.mark.parametrize("arch,remat,compress", CASES)
def test_tensor_step_equals_the_host_int_step(arch, remat, compress):
    model = registry.Model.from_config(registry.get_config(arch).reduced())
    tcfg = TrainConfig(**_kw(remat, compress))
    by_int, s_int = _run(model, tcfg, int)
    by_tensor, s_tensor = _run(model, tcfg, _int32)
    for a, b in zip(by_int, by_tensor):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert len(s_int) == len(s_tensor)
    for a, b in zip(s_int, s_tensor):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,remat,compress", CASES[:2] + CASES[3:5])
def test_trainer_update_in_place_equals_the_eager_fit(arch, remat,
                                                      compress):
    """The captured step's body on the CPU: ``Trainer.fit`` runs
    ``Trainer._update`` at a tensor count, its state written back into
    the Trainer's own tensors, against the functional step at the host
    integer (new state returned) from the same seed on the same
    batches."""
    cfg = registry.get_config(arch).reduced()
    model = registry.Model.from_config(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=4))

    def frames(step):
        if cfg.family != "encdec":
            return {}
        gen = torch.Generator().manual_seed(step)
        return {"frames": torch.randn(4, cfg.encoder_seq, cfg.d_model,
                                      generator=gen)}

    tcfg = TrainConfig(**_kw(remat, compress))
    tr = Trainer(model, pipe, tcfg, extra_batch_fn=frames, device="cpu")
    tensors = [id(x) for x in leaves(tr._state_tree())]
    hist = tr.fit(verbose=False)
    assert [id(x) for x in leaves(tr._state_tree())] == tensors
    params, opt, ostate, cstate = _fresh(model)
    step = make_train_step(model, tcfg, opt)
    for s in range(STEPS):
        batch = pipe.global_batch(s)
        batch.update(frames(s))
        params, ostate, cstate, met = step(params, ostate, cstate, batch, s)
        assert {k: float(v) for k, v in met.items()} == hist[s]
    want = leaves({"params": params, "opt": ostate, "comp": cstate})
    for a, b in zip(leaves(tr._state_tree()), want):
        assert torch.equal(a, b)
    assert int(tr.opt_state.step) == STEPS


@pytest.mark.parametrize("arch,remat,compress", CASES[:3] + CASES[5:])
def test_tensor_step_matches_the_reference(arch, remat, compress):
    kw = _kw(remat, compress)
    jm = jreg.Model.from_config(jreg.get_config(arch).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    m = registry.Model.from_config(registry.get_config(arch).reduced())
    p = params_from_jax(jax.tree.map(np.asarray, jp), m.cfg, master=True)
    jopt, opt = JAdamW(), AdamW()
    jstep = jax.jit(jloop.make_train_step(jm, jloop.TrainConfig(**kw), jopt))
    step = make_train_step(m, TrainConfig(**kw), opt)
    jstate = (jopt.init(jp), jinit_compression(jp))
    state = (opt.init(p), init_compression(p))
    for s, batch in enumerate(_batches(m)):
        jp, jos, jcs, jmet = jstep(jp, *jstate,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jnp.asarray(s, jnp.int32))
        jstate = (jos, jcs)
        p, os_, cs, met = step(p, *state, {k: torch.from_numpy(v) for k, v
                                           in batch.items()}, _int32(s))
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
    assert int(state[0].step) == int(jstate[0].step) == STEPS


class _HostReads:
    """Makes every read of a tensor's value into Python raise while
    armed: ``item``, ``tolist``, ``bool``, ``int``, ``float``, ``index``."""
    NAMES = ("item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self, monkeypatch):
        self.armed = False
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, real))

    def _guard(self, name, real):
        def read(t, *args, **kw):
            if self.armed:
                raise AssertionError(f"Tensor.{name} on the train step")
            return real(t, *args, **kw)
        return read


@pytest.mark.parametrize("arch,remat,compress", [
    ("qwen1_5_4b", "dots", True), ("qwen1_5_4b", "full", False),
    ("whisper_tiny", "none", True)])
def test_step_at_a_tensor_count_reads_nothing_on_the_host(
        arch, remat, compress, monkeypatch):
    model = registry.Model.from_config(registry.get_config(arch).reduced())
    tcfg = TrainConfig(**_kw(remat, compress))
    params, opt, ostate, cstate = _fresh(model)
    step = make_train_step(model, tcfg, opt)
    batch = {k: torch.from_numpy(v) for k, v in _batches(model)[0].items()}
    count = _int32(0)
    want = make_train_step(model, tcfg, opt)(
        unflatten(params, [x.detach().clone().requires_grad_()
                           for x in leaves(params)]),
        opt.init(params), init_compression(params), batch, 0)[3]
    guard = _HostReads(monkeypatch)
    guard.armed = True
    try:
        _, _, _, met = step(params, ostate, cstate, batch, count)
    finally:
        guard.armed = False
    for k in want:
        assert torch.equal(met[k], want[k]), k


def test_a_recorded_stream_takes_other_threads_moves(monkeypatch):
    """A captured backward launches from autograd's device thread onto
    the capture's stream: ``compat.recording`` registers the stream
    current where it is entered, and files the moves of any thread
    launching into it while it captures in the capture's record; a
    thread on another stream counts at once."""
    import threading
    from repro_torch.kernels import compat

    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    local = threading.local()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(local, "stream", None) is not None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: local.stream)
    counters = {"launches": 0}

    def launch(handle):
        local.stream = Stream(handle) if handle else None
        compat.count(counters, launches=1)

    local.stream = Stream(7)                        # the capture's stream
    with compat.recording() as record:
        compat.count(counters, launches=1)          # the capturing thread
        for handle in (7, 8, None):                 # three other threads
            th = threading.Thread(target=launch, args=(handle,))
            th.start()
            th.join()
        with compat.recording() as inner:           # nested on stream 7
            th = threading.Thread(target=launch, args=(7,))
            th.start()
            th.join()
        assert len(inner) == 1
        th = threading.Thread(target=launch, args=(7,))
        th.start()
        th.join()
    assert counters["launches"] == 2                # streams 8 and none
    assert len(record) == 3
    compat.replayed(record)
    assert counters["launches"] == 5
    assert compat._BY_STREAM == {}
    th = threading.Thread(target=launch, args=(7,))  # capture over
    th.start()
    th.join()
    assert counters["launches"] == 6

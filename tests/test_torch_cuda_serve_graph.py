"""The serving loop's captured decode step on the card.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py

``Server.decode`` on the card warms its step up once (eagerly), then
captures it in one CUDA graph and replays it per token
(``train/serve.py``).  The reduced configs of gemma2 (windowed and
global layers), granite (MoE), mamba2 (SSD), whisper (enc-dec) and
pixtral (patch prefix, decode from P + T), float32, with seeded random
weights made on the card, are held to the eager step run from Python:

* tokens and every cache leaf bit for bit against ``Server._decode_step``
  called with host positions over 8 steps: the same kernels on the same
  inputs (the decode kernel's device ``kv_len`` agrees with the host int
  bit for bit, PERF.md section 2);
* the launch counters move per replay as per eager step;
* a replay makes no host sync (``set_sync_debug_mode("error")``);
* a second sequence on one Server reuses its capture (same shapes) or
  captures anew (another batch);
* two Servers capture and replay in two threads at once;
* temperature sampling through the graph draws what the eager step draws
  from the same seed;
* a step that cannot be captured raises: no eager fallback.
"""
import importlib
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.train import Server, ServeConfig  # noqa: E402

pytestmark = pytest.mark.cuda

ARCHS = ["gemma2_9b", "granite_moe_1b_a400m", "mamba2_1_3b",
         "whisper_tiny", "pixtral_12b"]
BATCH, PROMPT, STEPS = 2, 16, 8
COUNTERS = {"gemm": ("launches", "reduce_launches"),
            "attention": ("launches", "copies"),
            "decode_attention": ("launches", "memsets", "copies")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


_MODELS = {}


def _model(arch, dev):
    if arch not in _MODELS:
        cfg = get_config(arch).reduced()
        model = Model.from_config(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        gen = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen)
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = torch.randn(BATCH, cfg.encoder_seq,
                                          cfg.d_model, generator=gen)
        if cfg.patch_prefix:
            extra["patch_embeds"] = torch.randn(
                BATCH, cfg.patch_prefix, cfg.d_model, generator=gen)
        _MODELS[arch] = (model, params, prompt, extra)
    return _MODELS[arch]


def _server(model, params, dev, policy="dfu", temperature=0.0):
    start = PROMPT + model.cfg.patch_prefix
    return Server(model, params, ServeConfig(
        max_len=start + STEPS + 2, offload_policy=policy,
        temperature=temperature, cache_dtype=torch.float32), device=dev)


def _leaves(cache):
    if isinstance(cache, (tuple, list)):
        return [x for sub in cache for x in _leaves(sub)]
    return [cache]


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


def _graph_run(model, params, prompt, extra, dev, **kw):
    srv = _server(model, params, dev, **kw)
    start = PROMPT + model.cfg.patch_prefix
    tok, cache = srv.prefill(prompt, extra)
    gen, cache = srv.decode(tok, cache, start, STEPS)
    return srv, gen, cache


def _eager_run(model, params, prompt, extra, dev, **kw):
    srv = _server(model, params, dev, **kw)
    start = PROMPT + model.cfg.patch_prefix
    tok, cache = srv.prefill(prompt, extra)
    outs = []
    with torch.no_grad():
        for i in range(STEPS):
            tok, cache = srv._decode_step(tok, cache, start + i)
            outs.append(tok)
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_replays_equal_the_eager_step(arch, dev):
    model, params, prompt, extra = _model(arch, dev)
    srv, gen, cache = _graph_run(model, params, prompt, extra, dev)
    assert srv.replays == STEPS - 1
    want, eager_cache = _eager_run(model, params, prompt, extra, dev)
    assert torch.equal(gen, want)
    got, ref = _leaves(cache), _leaves(eager_cache)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["memcopy", "pinned"])
def test_placements_replay_the_same_tokens(policy, dev):
    model, params, prompt, extra = _model("gemma2_9b", dev)
    _, want, _ = _graph_run(model, params, prompt, extra, dev)
    srv, got, _ = _graph_run(model, params, prompt, extra, dev,
                             policy=policy)
    assert srv.replays == STEPS - 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["gemma2_9b", "granite_moe_1b_a400m"])
def test_a_replay_counts_an_eager_step(arch, dev):
    model, params, prompt, extra = _model(arch, dev)
    srv = _server(model, params, dev)
    start = PROMPT + model.cfg.patch_prefix
    tok, cache = srv.prefill(prompt, extra)
    with torch.no_grad():
        _reset()
        tok, cache = srv._decode_step(tok, cache, start)
        eager = _counts()
        gen, cache = srv.decode(tok, cache, start + 1, 3)
    assert srv.replays == 2
    _reset()
    with torch.no_grad():
        srv._step(gen[:, -1:], cache, start + 4)
    replay = _counts()
    assert replay == eager
    assert eager["gemm.launches"] > 0
    assert eager["decode_attention.launches"] > 0


def test_a_second_sequence_reuses_or_recaptures(dev):
    """A second decode on the same Server: a new cache of the same shapes
    is copied into the captured buffers (no new capture), another batch
    warms up and captures anew; tokens as a fresh Server's each time."""
    model, params, prompt, extra = _model("gemma2_9b", dev)
    srv, first, _ = _graph_run(model, params, prompt, extra, dev)
    graph = srv.graphed.graph
    tok, cache = srv.prefill(prompt, extra)
    again, _ = srv.decode(tok, cache, PROMPT, STEPS)
    assert srv.graphed.graph is graph and srv.replays == 2 * STEPS - 1
    assert torch.equal(again, first)
    one = prompt[:1]
    _, want, _ = _graph_run(model, params, one, {}, dev)
    tok, cache = srv.prefill(one)
    got, _ = srv.decode(tok, cache, PROMPT, STEPS)
    assert srv.graphed.graph is not graph
    assert srv.replays == 2 * STEPS - 1 + STEPS - 1
    assert torch.equal(got, want)


def test_a_replay_makes_no_host_sync(dev):
    model, params, prompt, extra = _model("granite_moe_1b_a400m", dev)
    srv, gen, cache = _graph_run(model, params, prompt, extra, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok, _ = srv._step(gen[:, -1:], cache, PROMPT + STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tok.shape == (BATCH, 1)


def test_two_servers_capture_in_two_threads(dev):
    model, params, prompt, extra = _model("gemma2_9b", dev)
    _, want, _ = _graph_run(model, params, prompt, extra, dev)
    results, errors = [None, None], []

    def worker(i):
        try:
            srv, gen, _ = _graph_run(model, params, prompt, extra, dev)
            results[i] = (srv.replays, gen)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for replays, gen in results:
        assert replays == STEPS - 1
        assert torch.equal(gen, want)


def test_temperature_draws_equal_the_eager_step(dev):
    model, params, prompt, extra = _model("gemma2_9b", dev)
    srv, got, _ = _graph_run(model, params, prompt, extra, dev,
                             temperature=1.0)
    assert srv.replays == STEPS - 1
    want, _ = _eager_run(model, params, prompt, extra, dev, temperature=1.0)
    assert torch.equal(got, want)


def test_a_failed_capture_raises(dev, monkeypatch):
    """A host read inside the step cannot be captured: the capture raises
    and nothing runs the step eagerly in its place."""
    model, params, prompt, extra = _model("mamba2_1_3b", dev)
    srv = _server(model, params, dev)
    tok, cache = srv.prefill(prompt, extra)
    real = srv._decode_step
    calls = []

    def reading(tok, cache, pos):
        calls.append(pos)
        if isinstance(pos, torch.Tensor) and len(calls) > 1:
            int(pos)        # a host read: illegal while capturing
        return real(tok, cache, pos)

    monkeypatch.setattr(srv, "_decode_step", reading)
    with pytest.raises(RuntimeError):
        srv.decode(tok, cache, PROMPT, 3)
    assert len(calls) == 2 and srv.replays == 0
    torch.cuda.synchronize()


"""A cache position on the device, the input of the captured decode step,
against the host integer and against the JAX package on the CPU.

The reference traces its decode step's position as a ``jnp.int32``
(``repro/train/serve.py:76,130``); the port's captured step
(``train/serve.py``) gives the model a one-element int32 tensor, which the
cache write, the rope positions and ``kv_len`` read on the device.  For
the reduced configs of the six served families (gemma2: windowed and
global layers, soft-caps; granite: MoE; mamba2: SSD; jamba: the hybrid
cache; whisper: enc-dec with the prefill's cross K/V; pixtral: the patch
prefix, decode from P + T) a prefill and three decode steps run with a
tensor position:

* against the same steps with the host integer: logits and every cache
  leaf bit for bit (the same operations on the same values);
* against the reference's forward fed ``jnp.asarray(pos, jnp.int32)``,
  with the reference's own initialized weights: the parity tolerances of
  ``test_torch_models.py``, ``test_torch_models_moe_ssm.py`` (1e-4),
  ``test_torch_encdec.py`` and ``test_torch_vlm.py`` (1e-5), relative to
  the reference's largest value (float32 on both sides).

A decode step at a tensor position reads no tensor value on the host (a
captured step could not hold one), and the launch counters' capture
record (``kernels.compat.recording``) adds per replay what the captured
step would have counted.  The card's own checks (capture and replay
against the eager step) are ``tests/test_torch_cuda_serve_graph.py``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro_torch.kernels import compat, ops  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (cache_to_numpy,  # noqa: E402
                                        params_from_jax)

#: each family's parity tolerance, as its own model test states it
TOL = {"gemma2_9b": 1e-4, "granite_moe_1b_a400m": 1e-4,
       "mamba2_1_3b": 1e-4, "jamba_1_5_large_398b": 1e-4,
       "whisper_tiny": 1e-5, "pixtral_12b": 1e-5}
ARCHS = list(TOL)
BATCH, PROMPT, STEPS, MAX_LEN = 2, 16, 3, 32

_PAIRS = {}


def _pair(arch):
    """The reference's model and weights, the port's with the same
    weights, and the family's inputs (tokens; frames or patches)."""
    if arch not in _PAIRS:
        jm = jreg.Model.from_config(jreg.get_config(arch).reduced())
        jp = jm.init(jax.random.PRNGKey(0))
        m = registry.Model.from_config(registry.get_config(arch).reduced())
        cfg = m.cfg
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (BATCH, PROMPT + STEPS))
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = rng.standard_normal(
                (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.patch_prefix:
            extra["patch_embeds"] = rng.standard_normal(
                (BATCH, cfg.patch_prefix, cfg.d_model)).astype(np.float32)
        _PAIRS[arch] = (jm, jp, m, params_from_jax(
            jax.tree.map(np.asarray, jp), cfg), toks, extra)
    return _PAIRS[arch]


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaves(cache):
    """Copies of every cache leaf (the port's are written in place)."""
    return [np.array(x) for pair in cache_to_numpy(cache) for x in pair]


def _port_steps(m, p, toks, extra, position):
    """Prefill the prompt, then STEPS decode steps fed the prompt's next
    tokens; ``position(int)`` makes each call's cache_pos.  Returns each
    call's logits and a copy of the cache after it."""
    start = PROMPT + m.cfg.patch_prefix
    cache = m.init_cache(BATCH, MAX_LEN, torch.float32)
    logits, _, cache = m.forward(
        p, torch.from_numpy(toks[:, :PROMPT]), cache=cache,
        cache_pos=position(0),
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    out = [(logits, _leaves(cache))]
    for step in range(STEPS):
        tok = torch.from_numpy(toks[:, PROMPT + step:PROMPT + step + 1])
        logits, _, cache = m.forward(p, tok, cache=cache,
                                     cache_pos=position(start + step))
        out.append((logits, _leaves(cache)))
    return out


def _tensor_pos(pos):
    # the prefill takes the reference's 0-dim form, the steps the
    # captured step's one-element form
    shape = () if pos == 0 else (1,)
    return torch.full(shape, pos, dtype=torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_equals_host_int_and_reference(arch):
    jm, jp, m, p, toks, extra = _pair(arch)
    with torch.no_grad():
        by_int = _port_steps(m, p, toks, extra, lambda pos: pos)
        by_tensor = _port_steps(m, p, toks, extra, _tensor_pos)
    for (li, ci), (lt, ct) in zip(by_int, by_tensor):
        assert torch.equal(li, lt)
        assert len(ci) == len(ct)
        for a, b in zip(ci, ct):
            assert np.array_equal(a, b)
    # the reference, its position a traced-style int32 array
    start = PROMPT + m.cfg.patch_prefix
    jc = jm.init_cache(BATCH, MAX_LEN, jnp.float32)
    jl, _, jc = jm.forward(jp, jnp.asarray(toks[:, :PROMPT]), cache=jc,
                           cache_pos=jnp.asarray(0, jnp.int32),
                           **{k: jnp.asarray(v) for k, v in extra.items()})
    want = [(jl, jc)]
    for step in range(STEPS):
        jl, _, jc = jm.forward(
            jp, jnp.asarray(toks[:, PROMPT + step:PROMPT + step + 1]),
            cache=jc, cache_pos=jnp.asarray(start + step, jnp.int32))
        want.append((jl, jc))
    for (lt, ct), (jl, jc) in zip(by_tensor, want):
        assert _rel(lt, jl) <= TOL[arch]
        for t, j in zip(ct, _leaves(jc)):
            assert _rel(t, j) <= TOL[arch]


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
                raise AssertionError(f"Tensor.{name} on the decode step")
            return real(t, *args, **kw)
        return read


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_at_a_tensor_position_reads_nothing_on_the_host(
        arch, monkeypatch):
    """No host read in the step a graph captures.  The decode kernel's
    plain version, which the CPU runs in the kernel's place, checks
    ``kv_len``'s range on the host; on the card the kernel reads it
    there, so the check is lifted inside that call only, and the call
    must have received the int32 tensor."""
    _, _, m, p, toks, extra = _pair(arch)
    cache = m.init_cache(BATCH, MAX_LEN, torch.float32)
    with torch.no_grad():
        m.forward(p, torch.from_numpy(toks[:, :PROMPT]), cache=cache,
                  cache_pos=0,
                  **{k: torch.from_numpy(v) for k, v in extra.items()})
    guard = _HostReads(monkeypatch)
    real, seen = ops.decode_attention, []

    def decode(q, k, v, kv_len, **kw):
        assert isinstance(kv_len, torch.Tensor)
        assert kv_len.dtype == torch.int32 and kv_len.numel() == 1
        seen.append(kv_len)
        guard.armed = False
        try:
            return real(q, k, v, kv_len, **kw)
        finally:
            guard.armed = True

    monkeypatch.setattr(ops, "decode_attention", decode)
    pos = torch.full((1,), PROMPT + m.cfg.patch_prefix, dtype=torch.int32)
    guard.armed = True
    try:
        with torch.no_grad():
            logits, _, _ = m.forward(
                p, torch.from_numpy(toks[:, PROMPT:PROMPT + 1]),
                cache=cache, cache_pos=pos)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    finally:
        guard.armed = False
    assert tok.shape == (BATCH, 1)
    cfg = m.cfg
    global_layers = sum(cfg.is_attn_layer(i) and cfg.layer_window(i) == 0
                        for i in range(cfg.n_layers))
    assert len(seen) == global_layers
    assert all(int(x) == int(pos) + 1 for x in seen)


def test_capture_record_counts_once_per_replay():
    """While a thread records (a capture), its counter moves go into the
    record and no counter moves; each replay then adds the record; other
    threads count their own launches meanwhile."""
    counters = {"launches": 0, "memsets": 0}
    by_path = {"wgmma": 0, "fma": 0}
    with compat.recording() as record:
        compat.count(counters, launches=1, memsets=1)
        compat.count(counters, launches=1)
        compat.count(by_path, wgmma=1)
        other = threading.Thread(
            target=lambda: compat.count(counters, launches=5))
        other.start()
        other.join()
    assert counters == {"launches": 5, "memsets": 0}
    assert by_path == {"wgmma": 0, "fma": 0}
    for _ in range(3):
        compat.replayed(record)
    assert counters == {"launches": 5 + 3 * 2, "memsets": 3}
    assert by_path == {"wgmma": 3, "fma": 0}
    compat.count(counters, launches=1)      # outside: counted at once
    assert counters["launches"] == 12


def test_nested_records_restore_the_outer_one():
    counters = {"launches": 0}
    with compat.recording() as outer:
        compat.count(counters, launches=1)
        with compat.recording() as inner:
            compat.count(counters, launches=2)
        compat.count(counters, launches=4)
    assert counters["launches"] == 0
    compat.replayed(outer)
    assert counters["launches"] == 5
    compat.replayed(inner)
    assert counters["launches"] == 7

"""The port's attention kernels' plain versions and ``ops.attention``
against the JAX package on the CPU.

Same numpy inputs through ``repro.kernels`` (the Pallas kernels in
interpret mode, and ``ref``) and ``repro_torch.kernels``.  On the CPU the
port's wrappers take their plain versions, so these tests hold the
arithmetic the CUDA kernels are checked against on the card
(``tests/test_torch_cuda_attention.py``, ``chip_smoke.py``) to the
reference, and show that ``ops.attention`` takes the reference's
branches under the reference's conditions.

Tolerances, on max|port - reference| / max|reference|, and why: float32
2e-4, the port's full softmax against the kernel's online softmax
(different summation orders, ~1e-6 seen); bfloat16 3e-2, the reference
test's own (``tests/test_kernels.py``): the kernel rounds its output to
bf16, the plain version too, in different places; float32 against
``ref.attention`` 2e-5: the same formula on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.attention import flash_attention as jflash  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jdecode)
from repro_torch.kernels import (attention, decode_attention,  # noqa: E402
                                 ops, ref)

RNG = np.random.default_rng(13)
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _qkv(b, hq, hkv, tq, tk, d):
    return (RNG.standard_normal((b, hq, tq, d)).astype(np.float32),
            RNG.standard_normal((b, hkv, tk, d)).astype(np.float32),
            RNG.standard_normal((b, hkv, tk, d)).astype(np.float32))


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() <= tol


def _both(arrays, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, window=32),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=48, softcap=20.0),
])
def test_flash_matches_interpreted_kernel(kwargs, dtype):
    """The five configurations of tests/test_kernels.py:85-97."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 4, 2, 128, 128, 64), dtype)
    want = jflash(jq, jk, jv, bq=64, bk=64, interpret=True, **kwargs)
    got = attention.flash_attention(q, k, v, **kwargs)
    assert got.dtype == q.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,kwargs", [
    (1, 2, 2, 100, 100, 32, dict()),                       # ragged Tq
    (2, 4, 2, 64, 128, 64, dict(causal=True)),            # Tq < Tk
    (1, 4, 2, 48, 48, 256, dict(softcap=50.0, window=16)),  # gemma2 heads
])
def test_flash_shapes_match_interpreted_kernel(b, hq, hkv, tq, tk, d,
                                               kwargs):
    arrays = _qkv(b, hq, hkv, tq, tk, d)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    want = jflash(jq, jk, jv, bq=64, bk=64, interpret=True, **kwargs)
    _close(attention.flash_attention(q, k, v, **kwargs), want,
           TOL["float32"])


def test_noncausal_ragged_tk_follows_ref_not_the_tpu_kernel():
    """causal=False with Tk % bk != 0: the port masks keys past Tk, as
    ref.attention does; the TPU kernel lets its zero padding into the
    softmax (attention.py:58-63 and 96-100), which this pins."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, 2, 100, 100, 32), "float32")
    want = jref.attention(jq, jk, jv, causal=False)
    _close(attention.flash_attention(q, k, v, causal=False), want, 2e-5)
    tpu = np.asarray(jflash(jq, jk, jv, causal=False, bq=64, bk=64,
                            interpret=True))
    assert np.abs(tpu - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("kv_len", [1, 37, 128, 256])
def test_decode_matches_interpreted_kernel(kv_len):
    """tests/test_kernels.py:125-137's shapes and lengths."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 8, 2, 1, 256, 64), "float32")
    want = jdecode(jq, jk, jv, jnp.asarray(kv_len), bk=64, interpret=True)
    _close(decode_attention.decode_attention(q, k, v, kv_len), want,
           TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_softcap_and_ragged_cache(dtype):
    """S = 300 is not a multiple of the kernel's 64-key block, softcap 50,
    head size 256, group 2 (gemma2's decode)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 4, 2, 1, 300, 256), dtype)
    want = jdecode(jq, jk, jv, jnp.asarray(259), softcap=50.0, bk=64,
                   interpret=True)
    got = decode_attention.decode_attention(q, k, v, 259, softcap=50.0)
    assert got.dtype == q.dtype
    _close(got, want, TOL[dtype])


def test_decode_rejects_a_length_outside_the_cache():
    q, k, v = (torch.zeros(1, 2, 1, 16), torch.zeros(1, 2, 8, 16),
               torch.zeros(1, 2, 8, 16))
    for bad in (0, 9):
        with pytest.raises(ValueError, match="kv_len"):
            decode_attention.decode_attention(q, k, v, bad)


def test_chunked_matches_reference():
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 4, 2, 64, 64, 16), "float32")
    want = jref.attention_chunked(jq, jk, jv, chunk_q=16, softcap=20.0)
    _close(ref.attention_chunked(q, k, v, chunk_q=16, softcap=20.0), want,
           2e-5)


#: (tq, kv_len, causal, window, chunk_q) -> the branch the reference takes
BRANCH_CASES = [
    (1, 40, True, 0, 0),        # decode kernel
    (1, 40, True, 16, 0),       # windowed decode: plain
    (1, 40, False, 0, 0),       # non-causal decode: plain
    (16, None, True, 0, 0),     # flash kernel
    (16, None, True, 8, 0),     # flash kernel, windowed
    (8, None, False, 0, 0),     # flash kernel at its smallest Tq
    (16, 40, True, 0, 0),       # prefill into a cache: plain
    (6, None, True, 0, 2),      # below 8 rows, chunked
    (4, None, True, 0, 0),      # below 8 rows: plain
]


@pytest.mark.parametrize("tq,kv_len,causal,window,chunk_q", BRANCH_CASES)
def test_ops_attention_takes_the_reference_branch(monkeypatch, tq, kv_len,
                                                  causal, window, chunk_q):
    """Spies on both packages' branch targets: under SCILIB_PALLAS=1 the
    reference's use_pallas() holds, so both must name the same one."""
    taken = {}

    def spy(pkg, name):
        def f(*a, **kw):
            taken[pkg] = name
            return a[0]
        return f

    monkeypatch.setenv("SCILIB_PALLAS", "1")
    for pkg, mod, names in (
            ("jax", jops, ("decode_attention", "flash_attention")),
            ("torch", ops, ("decode_attention", "flash_attention"))):
        for name in names:
            monkeypatch.setattr(mod, name, spy(pkg, name))
    for pkg, mod in (("jax", jref), ("torch", ref)):
        monkeypatch.setattr(mod, "attention", spy(pkg, "attention"))
        monkeypatch.setattr(mod, "attention_chunked",
                            spy(pkg, "attention_chunked"))
    s = 48
    q, k, v = _qkv(1, 4, 2, tq, s if kv_len else tq, 16)
    kw = dict(causal=causal, window=window, softcap=50.0, chunk_q=chunk_q)
    jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   kv_len=None if kv_len is None else jnp.asarray(kv_len),
                   **kw)
    ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), kv_len=kv_len, **kw)
    assert taken["torch"] == taken["jax"]

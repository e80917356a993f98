"""The decode kernel's plan and its single-launch order on the CPU.

``repro_torch.kernels.decode_attention.plan`` splits a [B, Hkv, S, D]
cache's keys into chunks from the cache's shape alone, so that a
``kv_len`` given by value and one read on the device split them alike;
``decode_chunks_plain`` is the kernel's order in plain PyTorch: each
chunk's exact max, p = 2^(x - m) in log2 units with the soft-cap's exp
form, then the chunks combined in chunk order.  These tests hold the
plan's rules and hold that order, per query row, against the TPU kernel
itself, run interpreted (``repro.kernels.decode_attention
.decode_attention(..., interpret=True)``) and fed ``jnp.asarray(kv_len)``
as the reference takes it.  The CUDA kernel is held to the plain version
on the card (``tests/test_torch_cuda_attention.py``, ``chip_smoke.py``).

Tolerances, on the worst row's max|port - reference| / max|reference|:
1e-2 in bfloat16 (chip_smoke.py's ATTN_TOL: both sides compute in float32
and each rounds its output once, one bf16 ulp of a row's largest value at
most); 1e-5 in float32, where the two differ only in summation order, in
exp2 of log2-scaled logits against exp, and in the soft-cap's exp form
against tanh (~1e-6 seen).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jdecode)
from repro_torch.kernels import decode_attention as da  # noqa: E402

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
#: gemma2-9b's serve shape: batch 2, 8 KV heads, a 4624-slot cache of
#: head size 256, kv_len 4609 at the first decode step
SERVE = (2, 8, 4624, 256)
#: randn q times this: logits of standard deviation ~30, where softcap
#: 50 bites (chip_smoke.py's ATTN_Q_SCALE)
Q_SCALE = 30.0


def _inputs(seed, b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, hq, 1, d)) * Q_SCALE,
              rng.standard_normal((b, hkv, s, d)),
              rng.standard_normal((b, hkv, s, d)))
    torch_in = [torch.from_numpy(a.astype(np.float32)).to(dtype)
                for a in arrays]
    jax_in = [jnp.asarray(t.float().numpy(), JDT[dtype]) for t in torch_in]
    return torch_in, jax_in


def _row_rel(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    den = np.maximum(np.abs(want).max(-1), np.finfo(np.float32).tiny)
    return float((np.abs(got - want).max(-1) / den).max())


def _covers(p: da.Plan, kv_len: int) -> None:
    """The grid's chunks cover [0, kv_len) and no chunk lies wholly past
    it."""
    assert (p.grid - 1) * p.chunk < kv_len <= p.grid * p.chunk


def test_plan_at_the_serve_shape():
    """15 chunks of 320 keys per pair, 240 blocks: one wave at 2 blocks
    per SM on 132 SMs, over 90% of its slots busy."""
    p = da.plan(*SERVE, kv_len=4609)
    assert p == da.Plan(chunk=320, grid=15, blocks=240)
    slots = da.SMS * da.BLOCKS_PER_SM
    assert 0.9 * slots <= p.blocks <= slots
    assert da.plan(*SERVE) == p        # a device kv_len: every chunk of S


@pytest.mark.parametrize("kv_len", [1, 255, 256, 257, SERVE[2]])
def test_plan_chunks_follow_the_cache_not_kv_len(kv_len):
    p = da.plan(*SERVE, kv_len=kv_len)
    assert p.chunk == da.plan(*SERVE).chunk == 320
    assert p.chunk % da.CHUNK_ALIGN == 0
    _covers(p, kv_len)
    assert p.blocks == p.grid * SERVE[0] * SERVE[1]


@pytest.mark.parametrize("shape", [(1, 1, 100000, 128), (64, 8, 2048, 64),
                                   (1, 2, 5, 16), (2, 2, 300, 64)])
def test_plan_bounds_the_chunk(shape):
    """A long cache over few pairs keeps chunks at MAX_CHUNK keys (more
    waves); many pairs take one chunk of at most MAX_CHUNK each."""
    p = da.plan(*shape)
    assert da.CHUNK_ALIGN <= p.chunk <= da.MAX_CHUNK
    assert p.chunk % da.CHUNK_ALIGN == 0
    _covers(p, shape[2])


def test_plan_rejects_a_length_outside_the_cache():
    for bad in (0, SERVE[2] + 1):
        with pytest.raises(ValueError, match="kv_len"):
            da.plan(*SERVE, kv_len=bad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 255, 256, 257, 300])
def test_chunk_order_matches_interpreted_kernel(dtype, kv_len):
    """S = 300 over 2 pairs: chunks of 32 keys, so a kv_len crosses up to
    ten of them, with the last one ragged; softcap 50, head size 256,
    group 2 (gemma2's decode)."""
    (q, k, v), (jq, jk, jv) = _inputs(kv_len, 1, 4, 2, 300, 256, dtype)
    assert da.plan(1, 2, 300, 256, kv_len).chunk == 32
    want = jdecode(jq, jk, jv, jnp.asarray(kv_len), softcap=50.0, bk=64,
                   interpret=True)
    got = da.decode_chunks_plain(q, k, v, kv_len, softcap=50.0)
    assert got.dtype == dtype and got.shape == (1, 4, 1, 256)
    assert _row_rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_chunk_order_every_group(group):
    """Groups 1 to 8, no softcap, head size 64, kv_len 257 over chunks of
    32 keys, in float32."""
    (q, k, v), (jq, jk, jv) = _inputs(group, 2, 2 * group, 2, 300, 64,
                                      torch.float32)
    want = jdecode(jq, jk, jv, jnp.asarray(257), bk=64, interpret=True)
    got = da.decode_chunks_plain(q, k, v, 257)
    assert _row_rel(got, want) <= TOL[torch.float32]


def test_chunk_order_matches_the_plain_version_at_the_serve_shape():
    """The serve shape's 15 chunks against ref.attention (the plain
    version), in bf16 with the softcap: the order changes no row by more
    than one bf16 ulp."""
    b, hkv, s, d = SERVE
    (q, k, v), _ = _inputs(7, b, 16, hkv, s, d, torch.bfloat16)
    want = da.decode_attention_plain(q, k, v, 4609, softcap=50.0)
    got = da.decode_chunks_plain(q, k, v, 4609, softcap=50.0)
    assert _row_rel(got, jnp.asarray(want.float().numpy())) <= \
        TOL[torch.bfloat16]


def test_wrapper_takes_a_tensor_kv_len():
    """A one-element int32 tensor gives the int's result on the CPU; any
    other tensor is refused."""
    (q, k, v), _ = _inputs(3, 2, 4, 2, 300, 64, torch.bfloat16)
    counted = (da.launches, da.memsets, da.copies)
    want = da.decode_attention(q, k, v, 257, softcap=50.0)
    for kv in (torch.tensor(257, dtype=torch.int32),
               torch.tensor([257], dtype=torch.int32)):
        assert torch.equal(da.decode_attention(q, k, v, kv, softcap=50.0),
                           want)
    # the CPU route launches, zeroes and copies nothing, a view off the
    # kernel's 16-byte rules included
    off = torch.cat([k[..., :1], k], -1)[..., 1:]
    assert torch.equal(da.decode_attention(q, off, v, 257, softcap=50.0),
                       want)
    assert (da.launches, da.memsets, da.copies) == counted
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, v, torch.tensor([257]))
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, v, torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_len"):
        da.decode_attention(q, k, v, torch.tensor([301], dtype=torch.int32))


def test_kernel_ab_compares_ptxas_lines_and_needs_a_card(capsys):
    """launch/kernel_ab.py prints a variant's ptxas line as
    compat.ptxas_variants reads it, asks for one tree, and without a CUDA
    card exits 1 before building."""
    from repro_torch.kernels import compat
    from repro_torch.launch import kernel_ab
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113decode_kernelI13__nv_bfloat16Li256ELi2EEEv6Params'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 70 registers, used 1 barriers, 32 bytes smem"])
    (v,) = compat.ptxas_variants(log)
    assert kernel_ab.line(v) == ("decode_kernel<13__nv_bfloat16Li256ELi2>: "
                                 "70 registers, 32 B smem, 0 B stack, 0 B "
                                 "spill stores")
    assert kernel_ab.main([]) == 2
    if not torch.cuda.is_available():
        assert kernel_ab.main(["build/parent"]) == 1
        assert "no CUDA device" in capsys.readouterr().err

"""The port's flash and decode attention kernels on the card.

These tests need a CUDA card and skip without one (the ``cuda`` marker);
they import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py

Each kernel is held to its plain version on the same inputs.  Tolerances
on max|kernel - plain| / max|plain|, and why: float32, both sides compute
in float32 and differ only in summation order and in the online against
the full softmax (~1e-6 expected); bfloat16 and float16, the same float32
arithmetic on identical inputs, then one rounding of each output to the
16-bit type (2^-8 relative for bf16), which the two sides may take in
different directions.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention, decode_attention, ops  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _qkv(dev, dtype, b, hq, hkv, tq, tk, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    return rnd(b, hq, tq, d), rnd(b, hkv, tk, d), rnd(b, hkv, tk, d)


@pytest.mark.parametrize("d", attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_kernel_every_head_size(dev, d, dtype):
    """Ragged T = 100 (two query and key tiles), GQA group 2, causal,
    softcap 50 and window 40: every masking branch at each D variant."""
    q, k, v = _qkv(dev, dtype, 2, 4, 2, 100, 100, d)
    launched = attention.launches
    kw = dict(causal=True, window=40, softcap=50.0)
    got = attention.flash_attention(q, k, v, **kw)
    want = attention.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attention.launches == launched + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("kw,tq,tk", [
    (dict(causal=True), 128, 128),
    (dict(causal=False), 100, 100),          # ragged Tk without causal
    (dict(causal=True, window=32), 128, 128),
    (dict(causal=True, softcap=30.0), 128, 128),
    (dict(causal=True, window=48, softcap=20.0), 128, 128),
    (dict(causal=True), 40, 130),            # right-aligned queries
    (dict(causal=False, window=16), 70, 150),
])
def test_flash_kernel_masks(dev, kw, tq, tk):
    q, k, v = _qkv(dev, torch.float32, 2, 4, 2, tq, tk, 64, seed=1)
    got = attention.flash_attention(q, k, v, **kw)
    assert _rel(got, attention.flash_attention_plain(q, k, v, **kw)) <= 1e-4


def test_flash_kernel_reads_strided_views(dev):
    """q, k, v as the model makes them: head-transposed views of
    (B, T, H, D) projections, passed with their strides, not copied."""
    b, t, hq, hkv, d = 2, 96, 4, 2, 32
    q = torch.randn(b, t, hq, d, device=dev).transpose(1, 2)
    k = torch.randn(b, t, hkv, d, device=dev).transpose(1, 2)
    v = torch.randn(b, t, hkv, d, device=dev).transpose(1, 2)
    assert not q.is_contiguous()
    got = attention.flash_attention(q, k, v, softcap=50.0)
    want = attention.flash_attention_plain(q, k, v, softcap=50.0)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("d", attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(TOL))
def test_decode_kernel_every_head_size(dev, d, dtype):
    """S = 300 (not a multiple of the 64-key tile), kv_len 257 (two key
    chunks, the last one key long), softcap 50, group 2."""
    q, k, v = _qkv(dev, dtype, 2, 4, 2, 1, 300, d)
    launched = decode_attention.launches
    got = decode_attention.decode_attention(q, k, v, 257, softcap=50.0)
    want = decode_attention.decode_attention_plain(q, k, v, 257,
                                                   softcap=50.0)
    torch.cuda.synchronize()
    assert decode_attention.launches == launched + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("kv_len", [1, 37, 128, 256, 300])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (10, 2), (16, 2)])
def test_decode_kernel_lengths_and_groups(dev, kv_len, hq, hkv):
    q, k, v = _qkv(dev, torch.float32, 2, hq, hkv, 1, 300, 64, seed=2)
    got = decode_attention.decode_attention(q, k, v, kv_len)
    want = decode_attention.decode_attention_plain(q, k, v, kv_len)
    assert _rel(got, want) <= 1e-4


def test_decode_kernel_ignores_keys_past_kv_len(dev):
    """NaN past kv_len must not reach the output: those keys are never
    loaded."""
    q, k, v = _qkv(dev, torch.bfloat16, 1, 4, 2, 1, 200, 128)
    k[:, :, 77:] = float("nan")
    v[:, :, 77:] = float("nan")
    got = decode_attention.decode_attention(q, k, v, 77)
    assert bool(torch.isfinite(got).all())
    want = decode_attention.decode_attention_plain(q, k[:, :, :77],
                                                   v[:, :, :77], 77)
    assert _rel(got, want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("kv_len", [1, 255, 256, 257, 1000])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_device_kv_len_equals_host_bit_for_bit(dev, kv_len, group):
    """kv_len as a one-element int32 tensor on the card (the grid covers
    every chunk of S = 1000, chunks of 32 keys) against the same length
    by value (only the live chunks): the same bits, one launch counted per
    call, repeats equal to the first; both within tolerance of the plain
    version."""
    q, k, v = _qkv(dev, torch.bfloat16, 2, 2 * group, 2, 1, 1000, 128,
                   seed=group)
    assert decode_attention.plan(2, 2, 1000, 128).chunk == 32
    dev_len = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    launched, memsets = decode_attention.launches, decode_attention.memsets
    host = decode_attention.decode_attention(q, k, v, kv_len, softcap=50.0)
    on_dev = decode_attention.decode_attention(q, k, v, dev_len,
                                               softcap=50.0)
    torch.cuda.synchronize()
    assert decode_attention.launches == launched + 2
    assert decode_attention.memsets == memsets + 2
    assert torch.equal(host, on_dev)
    for _ in range(3):
        assert torch.equal(decode_attention.decode_attention(
            q, k, v, dev_len, softcap=50.0), host)
    want = decode_attention.decode_attention_plain(q, k, v, kv_len,
                                                   softcap=50.0)
    assert _rel(host, want) <= TOL[torch.bfloat16]


def test_decode_device_kv_len_outside_the_cache_gives_nan(dev):
    """A device kv_len the wrapper cannot check without a sync: outside
    [1, S] the rows are NaN, never a silent answer."""
    q, k, v = _qkv(dev, torch.bfloat16, 1, 4, 2, 1, 64, 64)
    for bad in (0, 65):
        kv = torch.tensor([bad], dtype=torch.int32, device=dev)
        assert bool(torch.isnan(decode_attention.decode_attention(
            q, k, v, kv)).all())
    # the next call is right
    got = decode_attention.decode_attention(q, k, v, 40)
    assert _rel(got, decode_attention.decode_attention_plain(
        q, k, v, 40)) <= TOL[torch.bfloat16]


def test_decode_reads_cache_views_and_copies_misaligned_ones(dev):
    """The live prefix of a larger cache goes in uncopied; a cache whose
    base is off 16 bytes is copied, and counted."""
    q, k, v = _qkv(dev, torch.bfloat16, 2, 4, 2, 1, 300, 128, seed=4)
    copies = decode_attention.copies
    got = decode_attention.decode_attention(q, k[:, :, :200], v[:, :, :200],
                                            150, softcap=50.0)
    assert decode_attention.copies == copies
    assert _rel(got, decode_attention.decode_attention_plain(
        q, k, v, 150, softcap=50.0)) <= TOL[torch.bfloat16]
    raw = torch.randn(2, 2, 300, 129, device=dev, dtype=torch.bfloat16)
    km = raw[..., 1:]                         # base 2 bytes off, row 258 B
    got = decode_attention.decode_attention(q, km, v, 150, softcap=50.0)
    assert decode_attention.copies == copies + 1
    assert _rel(got, decode_attention.decode_attention_plain(
        q, km, v, 150, softcap=50.0)) <= TOL[torch.bfloat16]


def test_ops_attention_takes_the_kernels_on_the_card(dev):
    q, k, v = _qkv(dev, torch.bfloat16, 1, 4, 2, 16, 64, 64)
    flash0, dec0 = attention.launches, decode_attention.launches
    ops.attention(q, k[:, :, :16], v[:, :, :16], softcap=50.0)
    ops.attention(q[:, :, :1], k, v, kv_len=40)
    ops.attention(q[:, :, :1], k, v, kv_len=40, window=8)   # plain
    assert (attention.launches, decode_attention.launches) == \
        (flash0 + 1, dec0 + 1)


def test_cuda_tensors_raise_instead_of_falling_back(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 2, 2, 16, 16, 48)
    with pytest.raises(ValueError, match="head size"):
        attention.flash_attention(q, k, v)
    q, k, v = _qkv(dev, torch.float64, 1, 2, 2, 16, 16, 64)
    with pytest.raises(TypeError):
        attention.flash_attention(q, k, v)
    q, k, v = _qkv(dev, torch.float32, 1, 18, 2, 1, 16, 64)
    with pytest.raises(ValueError, match="at most"):
        decode_attention.decode_attention(q, k, v, 8)


def _row_rel(got, want):
    """Per query row: max|got - want| / max|want| along D, the worst row
    (chip_smoke.py's measure)."""
    g, w = got.float(), want.float()
    den = w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - w).abs().amax(-1) / den).max().item()


@pytest.mark.parametrize("d", attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_plan_path_per_dtype_and_head_size(dev, d, dtype):
    """bf16/f16 at D 64, 128, 256 take the wgmma path; float32 and D 16,
    32 the FMA path; each launch is counted on its path."""
    q, k, v = _qkv(dev, dtype, 1, 2, 1, 16, 16, d)
    want = (attention.WGMMA if dtype != torch.float32
            and d in attention.WGMMA_HEAD_DIMS else attention.FMA)
    assert attention.plan(q, k, v) == attention.Plan(want, (False,) * 3)
    before = dict(attention.launches_by_path)
    attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches_by_path[want] == before[want] + 1


@pytest.mark.parametrize("d", attention.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kw,tq,tk", [
    (dict(causal=True, softcap=50.0), 300, 300),
    (dict(causal=True, window=100, softcap=50.0), 300, 300),
    (dict(causal=False), 200, 237),          # ragged Tk without causal
    (dict(causal=True), 70, 333),            # right-aligned ragged queries
    (dict(causal=True, window=64), 256, 256),
])
def test_wgmma_path_masks_per_row(dev, d, dtype, kw, tq, tk):
    """The wgmma path per query row at ATTN_TOL (1e-2): q scaled so that
    the softcap bites, GQA group 2, ragged Tq and Tk past the 128-row and
    64-key tiles."""
    q, k, v = _qkv(dev, dtype, 2, 4, 2, tq, tk, d, seed=4)
    q = q * 8
    launched = attention.launches_by_path[attention.WGMMA]
    got = attention.flash_attention(q, k, v, **kw)
    want = attention.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attention.launches_by_path[attention.WGMMA] == launched + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert _row_rel(got, want) <= 1e-2


def test_wgmma_path_reads_views_and_copies_misaligned_ones(dev):
    """Head-transposed views of a fused qkv projection go in uncopied;
    views whose base is off 16 bytes are copied, and counted."""
    b, t, hq, hkv, d = 2, 200, 4, 2, 128
    qkv = torch.randn(b, t, (hq + 2 * hkv) * d, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(b, t, hq, d).transpose(1, 2)
    k = k.reshape(b, t, hkv, d).transpose(1, 2)
    v = v.reshape(b, t, hkv, d).transpose(1, 2)
    assert attention.plan(q, k, v) == attention.Plan(attention.WGMMA,
                                                     (False,) * 3)
    copies = attention.copies
    got = attention.flash_attention(q, k, v, softcap=50.0)
    assert attention.copies == copies
    assert _row_rel(got, attention.flash_attention_plain(
        q, k, v, softcap=50.0)) <= 1e-2
    raw = torch.randn(b, hq, t, d + 1, device=dev, dtype=torch.bfloat16)
    qm = raw[..., 1:]                         # base 2 bytes off, row 258 B
    pl = attention.plan(qm, k, v)
    assert pl == attention.Plan(attention.WGMMA, (True, False, False))
    got = attention.flash_attention(qm, k, v, softcap=50.0)
    assert attention.copies == copies + 1
    assert _row_rel(got, attention.flash_attention_plain(
        qm, k, v, softcap=50.0)) <= 1e-2

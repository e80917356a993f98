"""The flash kernel's path plan and its wgmma path's arithmetic on the CPU.

``repro_torch.kernels.attention.plan`` picks the kernel's path from the
dtype, the head size and the operands' layout: bf16/f16 at D = 64, 128 or
256 take the tensor-core (wgmma) path, which reads q, k, v through TMA
and so copies an operand off its rules; float32 and D = 16 or 32 take the
FMA path.  ``flash_tiles_plain`` is the wgmma path's arithmetic in plain
PyTorch: 128-row query blocks over 64-key tiles, the exp form of tanh, P
rounded to the 16-bit type before P.V, float32 accumulation.  These tests
feed the same numpy inputs to it, to the JAX package's interpreted
``_flash_kernel`` and to its ``ref.attention``, per query row, where the
soft-cap bites; the CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda_attention.py``, ``chip_smoke.py``).

Tolerances, on the worst row's max|port - reference| / max|reference|:
1e-2 (chip_smoke.py's ATTN_TOL) for the 16-bit types: both sides compute
in float32, then each rounds its output once (one bf16 ulp, 2^-7 of a
row's largest value, at most), and the wgmma path also rounds P (2^-9
relative per weight), which the denominator's sum of the same rounded P
cancels to first order; 1e-4 where the inputs are float32, so that P is
not rounded: online against full softmax and the exp form of tanh
(~1e-6 seen).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import attention, compat  # noqa: E402

ATTN_TOL = 1e-2
#: randn q times this: logits q.k / sqrt(D) with a standard deviation of
#: ~30, so that softcap 50 bites (chip_smoke.py's ATTN_Q_SCALE)
ATTN_Q_SCALE = 30.0
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.float32: jnp.float32}


def _qkv(seed, b, hq, hkv, tq, tk, d, dtype):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, hq, tq, d)) * ATTN_Q_SCALE,
              rng.standard_normal((b, hkv, tk, d)),
              rng.standard_normal((b, hkv, tk, d)))
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


@pytest.mark.parametrize("d", attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_plan_every_dtype_and_head_size(dtype, d):
    q = torch.zeros(2, 4, 40, d, dtype=dtype)
    k = torch.zeros(2, 2, 40, d, dtype=dtype)
    wgmma = dtype != torch.float32 and d in attention.WGMMA_HEAD_DIMS
    assert attention.plan(q, k, k) == attention.Plan(
        attention.WGMMA if wgmma else attention.FMA, (False,) * 3)


def test_plan_pins_the_fma_path_for_small_heads():
    """D = 16 and 32 are whole TMA boxes of no 128-byte row: the plan
    names the FMA kernel for them in every type, never as a fallback."""
    for d in (16, 32):
        for dtype in (torch.bfloat16, torch.float16):
            x = torch.zeros(1, 2, 8, d, dtype=dtype)
            assert attention.plan(x, x, x).path == attention.FMA
    assert set(attention.WGMMA_HEAD_DIMS) | {16, 32} == set(
        attention.HEAD_DIMS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_reads_split_projection_views_uncopied(dtype):
    """q, k, v as the model makes them (head-transposed views of (B, T,
    H, D) projections) and as a fused qkv projection split into three:
    no copies on either path."""
    b, t, hq, hkv, d = 2, 50, 4, 2, 128
    qkv = torch.zeros(b, t, (hq + 2 * hkv) * d, dtype=dtype)
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(b, t, hq, d).transpose(1, 2)
    k = k.reshape(b, t, hkv, d).transpose(1, 2)
    v = v.reshape(b, t, hkv, d).transpose(1, 2)
    assert not q.is_contiguous()
    assert attention.plan(q, k, v).copy == (False, False, False)


def test_plan_copies_views_off_the_tma_rules():
    """A base 2 bytes off 16, a row stride of 258 bytes, or no unit stride
    on D: the wgmma path copies that operand (and counts it); the FMA path
    copies only the last kind."""
    raw = torch.zeros(2, 4, 40, 129, dtype=torch.bfloat16)
    off = raw[..., 1:]                     # base +2 bytes, row 258 bytes
    ok = torch.zeros(2, 2, 40, 128, dtype=torch.bfloat16)
    wide = torch.zeros(2, 2, 40, 256, dtype=torch.bfloat16)[..., ::2]
    assert attention.plan(off, ok, ok) == attention.Plan(
        attention.WGMMA, (True, False, False))
    assert attention.plan(ok.repeat(1, 2, 1, 1), ok, wide) == \
        attention.Plan(attention.WGMMA, (False, False, True))
    f32 = torch.zeros(2, 4, 40, 65, dtype=torch.float32)[..., 1:]
    strided = torch.zeros(2, 2, 40, 128, dtype=torch.float32)[..., ::2]
    assert attention.plan(f32, strided, strided) == attention.Plan(
        attention.FMA, (False, True, True))
    assert not attention.tma_ready(off) and attention.tma_ready(ok)


def test_plan_is_fixed_by_dtype_head_size_and_layout():
    """Equal layouts give equal plans, whatever the values."""
    x = torch.randn(1, 2, 70, 64).to(torch.float16)
    y = torch.full_like(x, float("nan"))
    assert attention.plan(x, x, x) == attention.plan(y, y, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kw,tq,tk,d", [
    (dict(causal=True, softcap=50.0), 200, 200, 64),
    (dict(causal=True, window=96, softcap=50.0), 256, 256, 128),
    (dict(causal=True, softcap=50.0), 130, 300, 256),     # ragged Tq < Tk
    (dict(causal=False, softcap=50.0), 192, 192, 64),
])
def test_tiles_plain_matches_interpreted_kernel_and_ref(dtype, kw, tq, tk,
                                                        d):
    """Per query row at 1e-2 against the TPU kernel run interpreted and
    against ``ref.attention``, the soft-cap biting, GQA group 2."""
    (q, k, v), (jq, jk, jv) = _qkv(tq + d, 1, 4, 2, tq, tk, d, dtype)
    got = attention.flash_tiles_plain(q, k, v, **kw)
    assert got.dtype == dtype
    assert _row_rel(got, jflash(jq, jk, jv, bq=64, bk=64, interpret=True,
                                **kw)) <= ATTN_TOL
    assert _row_rel(got, jref.attention(jq, jk, jv, **kw)) <= ATTN_TOL


@pytest.mark.parametrize("window", [0, 4096])
def test_tiles_plain_at_serve_length(window):
    """gemma2's global and local layers at the serve prompt's 4608
    positions, past the 4096 window: per row against ``ref.attention``."""
    kw = dict(causal=True, window=window, softcap=50.0)
    (q, k, v), (jq, jk, jv) = _qkv(window, 1, 2, 1, 4608, 4608, 256,
                                   torch.bfloat16)
    got = attention.flash_tiles_plain(q, k, v, **kw)
    assert _row_rel(got, jref.attention(jq, jk, jv, **kw)) <= ATTN_TOL


def test_negative_controls_exceed_the_tolerance():
    """The per-row check can tell the soft-capped, windowed function from
    its neighbours: without the cap, or at another window, every case
    misses 1e-2."""
    kw = dict(causal=True, window=96, softcap=50.0)
    (q, k, v), (jq, jk, jv) = _qkv(9, 1, 4, 2, 256, 256, 128,
                                   torch.bfloat16)
    want = jref.attention(jq, jk, jv, **kw)
    no_cap = attention.flash_tiles_plain(q, k, v, causal=True, window=96)
    no_window = attention.flash_tiles_plain(q, k, v, causal=True,
                                            softcap=50.0)
    assert _row_rel(no_cap, want) > ATTN_TOL
    assert _row_rel(no_window, want) > ATTN_TOL


def test_p_rounding_is_the_only_departure():
    """With float32 inputs P is not rounded, and the wgmma path's order
    and its form of tanh agree with the reference to 1e-4 per row."""
    kw = dict(causal=True, window=80, softcap=50.0)
    (q, k, v), (jq, jk, jv) = _qkv(11, 2, 4, 2, 200, 260, 64, torch.float32)
    got = attention.flash_tiles_plain(q, k, v, **kw)
    assert _row_rel(got, jref.attention(jq, jk, jv, **kw)) <= 1e-4


def test_exp_form_of_tanh_error():
    """c (1 - 2 / (1 + 2^(2 y log2 e))) against c tanh(y) in float32 at
    cap 50: an absolute error of ~1e-5 on the logit at most (tanh.approx's
    ~2^-11 relative would be ~0.025)."""
    y = torch.linspace(-30, 30, 200001, dtype=torch.float32)
    e = torch.exp2(y * (2.0 * 1.4426950408889634))
    form = 50.0 * (1.0 - 2.0 / (1.0 + e))
    exact = 50.0 * torch.tanh(y.double())
    assert (form.double() - exact).abs().max().item() <= 2e-5


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/*.cuh) changes every library's
    name, so no stale build is loaded; the sources stay the .cu files."""
    for p in list(compat.CSRC.glob("*.cu")) + list(compat.CSRC.glob("*.cuh")):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(compat, "CSRC", tmp_path)
    assert sorted(compat.headers()) == ["hopper.cuh"]
    assert all(p.suffix == ".cu" for p in compat.sources().values())
    before = {name: compat.library_path(name) for name in compat.sources()}
    (tmp_path / "hopper.cuh").write_bytes(
        (tmp_path / "hopper.cuh").read_bytes() + b"\n// edited\n")
    after = {name: compat.library_path(name) for name in compat.sources()}
    assert all(before[n] != after[n] for n in before)
    assert before["gemm"].parent == compat.BUILD_DIR


def test_flash_probe_reads_d256_ptxas_lines_and_needs_a_card(capsys):
    """launch/flash_probe.py keeps the ptxas lines of the D = 256 wgmma
    kernels only, and without a CUDA card exits 2 before building."""
    from repro_torch.launch import flash_probe
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118flash_wgmma_kernelI13__nv_bfloat16Li256ELb1EEEv'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    464 bytes stack frame, 1132 bytes spill stores",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118flash_wgmma_kernelI13__nv_bfloat16Li128ELb1EEEv'"
        " for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112flash_kernelIfLi256EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 150 registers, used 1 barriers"])
    assert flash_probe.d256_lines(log) == [
        "464 bytes stack frame, 1132 bytes spill stores",
        "ptxas info    : Used 168 registers, used 16 barriers"]
    if not torch.cuda.is_available():
        assert flash_probe.main([]) == 2
        assert "no CUDA card" in capsys.readouterr().err

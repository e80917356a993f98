"""The port's kernel modules against the JAX reference on the CPU.

Same numpy inputs through ``repro.kernels`` and ``repro_torch.kernels``.
On the CPU the port's kernel wrappers take their plain versions, so these
tests hold the plain arithmetic and everything around the kernels (the
trsm recursion and variant reduction, the 4M complex split, batching) to
the reference.  The CUDA kernels themselves are compared with the same
plain versions on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.trsm import trsm as pallas_trsm  # noqa: E402
from repro_torch.kernels import compat, gemm, ops, ref, trsm  # noqa: E402

RNG = np.random.default_rng(11)
REPO = Path(__file__).resolve().parents[1]

#: tolerances, relative to max|reference|, and why:
#: f64/c128 — both sides sum in float64, in different orders: ~K*eps64
#: f32/c64  — float32 sums in different orders (XLA vs PyTorch): ~K*eps32
#: bf16     — float32 sums, then one bf16 rounding of the output (2^-8)
TOL = {"float64": 1e-12, "complex128": 1e-12, "float32": 2e-5,
       "complex64": 2e-5, "bfloat16": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, dtype_name):
    got = np.asarray(got.to(torch.float64) if got.dtype == torch.bfloat16
                     else got)
    want = np.asarray(want, dtype=got.dtype)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / scale <= TOL[dtype_name]


def _mat(shape, dtype):
    x = RNG.standard_normal(shape)
    if "complex" in dtype:
        x = x + 1j * RNG.standard_normal(shape)
    return x


def _tri(n, uplo):
    """Diagonally dominant triangle, as tests/test_kernels.py builds it."""
    a = RNG.standard_normal((n, n)) / n
    a = np.tril(a) if uplo == "L" else np.triu(a)
    np.fill_diagonal(a, 1.0 + np.abs(np.diag(a)))
    return a


def _both(x, dtype):
    """The same array for both packages (bf16 via float32)."""
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.as_tensor(np.array(jx.astype(jnp.float32)
                                  if dtype == "bfloat16" else jx))
    return jx, tx.to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64",
                                   "complex64", "complex128"])
def test_ref_matmul_matches_reference(dtype):
    ja, ta = _both(_mat((37, 53), dtype), dtype)
    jb, tb = _both(_mat((53, 29), dtype), dtype)
    got = ref.matmul(ta, tb)
    assert got.dtype == ta.dtype
    want = jref.matmul(ja, jb)
    _close(got, np.asarray(want.astype(jnp.float32) if dtype == "bfloat16"
                           else want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_gemm_cpu_route_is_plain_version(dtype):
    _, ta = _both(_mat((65, 130), dtype), dtype)
    _, tb = _both(_mat((130, 33), dtype), dtype)
    launched = gemm.launches
    assert torch.equal(gemm.gemm(ta, tb), gemm.gemm_plain(ta, tb))
    out = gemm.gemm(ta, tb, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert gemm.launches == launched        # the plain route launches nothing


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trsm_recursion_matches_reference(side, uplo, trans, diag):
    """The port's recursion and variant reduction (plain base blocks and
    plain gemm updates on the CPU) against the reference's library solve,
    at m = 200, so the recursion splits 128 + 72."""
    m, n = 200, 24
    a = _tri(m if side == "L" else n, uplo)
    # garbage in the unreferenced triangle must not leak in
    a = a + (np.triu(RNG.standard_normal(a.shape), 1) if uplo == "L"
             else np.tril(RNG.standard_normal(a.shape), -1))
    b = RNG.standard_normal((m, n))
    kw = dict(side=side, uplo=uplo, trans=trans, diag=diag)
    want = np.asarray(jref.trsm(jnp.asarray(np.triu(a) if uplo == "U"
                                            else np.tril(a)),
                                jnp.asarray(b), **kw))
    for fn in (trsm.trsm, trsm.trsm_plain, ops.trsm):
        _close(fn(torch.as_tensor(a), torch.as_tensor(b), **kw), want,
               "float64")


@pytest.mark.parametrize("trans", ["N", "C"])
def test_complex_trsm_goes_to_library(trans):
    a = _tri(40, "U") + 1j * np.triu(RNG.standard_normal((40, 40)) / 40)
    b = _mat((40, 7), "complex128")
    kw = dict(side="L", uplo="U", trans=trans, diag="N")
    want = jref.trsm(jnp.asarray(a), jnp.asarray(b), **kw)
    launched = trsm.launches
    _close(ops.trsm(torch.as_tensor(a), torch.as_tensor(b), **kw), want,
           "complex128")
    assert trsm.launches == launched


def test_trsm_batched_matches_reference():
    a = np.stack([_tri(150, "L") for _ in range(3)])
    b = RNG.standard_normal((3, 150, 20))
    want = jref.trsm(jnp.asarray(a), jnp.asarray(b), side="L", uplo="L",
                     trans="T", diag="N")
    got = trsm.trsm(torch.as_tensor(a), torch.as_tensor(b), side="L",
                    uplo="L", trans="T", diag="N")
    _close(got, want, "float64")


@pytest.mark.parametrize("side,uplo,trans,diag", [
    ("L", "L", "N", "N"), ("R", "U", "T", "U"), ("L", "U", "T", "N")])
def test_trsm_recursion_matches_interpreted_pallas(side, uplo, trans, diag,
                                                  monkeypatch):
    """Against the TPU kernel itself, run interpreted: same split rule,
    same reduction, float32 as the reference's kernel tests use it.
    JAX releases without ``pl.load``/``pl.store`` get the indexing they
    stood for, for this test only."""
    from jax.experimental import pallas as pl

    def _load(ref_, idx):
        return ref_[idx]

    def _store(ref_, idx, val):
        ref_[idx] = val
    monkeypatch.setattr(pl, "load", getattr(pl, "load", _load),
                        raising=False)
    monkeypatch.setattr(pl, "store", getattr(pl, "store", _store),
                        raising=False)
    m, n = 200, 16
    a = _tri(m if side == "L" else n, uplo).astype(np.float32)
    b = RNG.standard_normal((m, n)).astype(np.float32)
    kw = dict(side=side, uplo=uplo, trans=trans, diag=diag)
    want = pallas_trsm(jnp.asarray(a), jnp.asarray(b), interpret=True, **kw)
    _close(trsm.trsm(torch.as_tensor(a), torch.as_tensor(b), **kw), want,
           "float32")


def test_trsm_base_plain_matches_substitution():
    l = _tri(100, "L")
    b = RNG.standard_normal((100, 9))
    for unit in (False, True):
        lt = np.tril(l, -1) + np.eye(100) if unit else l
        want = np.linalg.solve(lt, b)
        got = trsm.trsm_base(torch.as_tensor(l), torch.as_tensor(b),
                             unit=unit)
        _close(got, want, "float64")


def test_split_point_matches_reference_rule():
    for m in (129, 200, 256, 257, 300, 6912):
        half = max(128, 1 << (m - 1).bit_length() - 1)
        assert trsm.split_point(m) == (m // 2 if half >= m else half)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_complex_matmul_4m_matches_reference(dtype):
    """ops.matmul splits complex products into four real ones (4M)."""
    ja, ta = _both(_mat((2, 30, 41), dtype), dtype)
    jb, tb = _both(_mat((41, 17), dtype), dtype)
    got = ops.matmul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (2, 30, 17)
    _close(got, jref.matmul(ja, jb), dtype)


def test_ops_matmul_batched_and_transposed_views():
    ja, ta = _both(_mat((4, 20, 30), "float64"), "float64")
    jb, tb = _both(_mat((30, 20), "float64"), "float64")
    _close(ops.matmul(ta, tb.mT.contiguous().mT), jref.matmul(ja, jb),
           "float64")
    _close(ops.matmul(ta.mT, ta), jref.matmul(ja.mT, ja), "float64")


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is not on the CPU launches the kernel or raises:
    there is no quiet plain route for it."""
    a = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gemm.gemm(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        trsm.trsm_base(a, a, unit=False)


def test_import_builds_nothing_and_build_dir_is_ignored():
    """Importing every port module in a fresh process loads no library
    and runs no compiler; the build goes where .gitignore covers it."""
    code = ("import pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.kernels import compat\n"
            "print(len(compat._LIBS), compat.BUILD_SECONDS, compat.BUILD_LOG)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.stdout.split() == ["0", "0.0", "{}"]
    rel = compat.BUILD_DIR.relative_to(REPO)
    assert rel.parts[0] == "build"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored and "*.so" in ignored
    assert sorted(compat.sources()) == ["decode_attention", "flash_attention",
                                        "gemm", "split_gemm", "syrk", "trsm"]


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    for name, module, func in (
            ("gemm", "gemm", "_gemm_kernel"),
            ("trsm", "trsm", "_trsm_base_kernel"),
            ("syrk", "syrk", "_syrk_kernel"),
            ("flash_attention", "attention", "_flash_kernel"),
            ("decode_attention", "decode_attention", "_decode_kernel"),
            ("split_gemm", "split_gemm", "31-63")):
        text = compat.sources()[name].read_text()
        assert f"src/repro/kernels/{module}.py:{func}" in text
        assert "What bounds it" in text and "Design" in text

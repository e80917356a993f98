"""The PARSEC proxy of the port against the reference's (paper §4.3)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402
from repro.apps import dft as jdft  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.apps import dft  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_run_mini_under_auto_precision():
    """Twin of ``tests/test_precision.py::test_dft_mini_accuracy_under_auto``,
    held to its oracle: split gemms actually run and the converged Ritz
    drift stays within the split-level tolerance (native 1e-6; split2's
    k = 512 bound is ~3e-5, amplified through Rayleigh-Ritz)."""
    cfg = OffloadConfig(policy="dfu", threshold=100, precision="auto")
    with repro_torch.session(cfg, device="cpu") as s:
        out = dft.run_mini(ngrid=512, nstates=16, scf=8, device="cpu")
        st = s.stats.per_routine
        splits = sum(r.split_calls for r in st.values())
        escs = sum(r.escalations for r in st.values())
        tags = {c.precision for c in s.trace.calls}
    # the sub-threshold products (psi @ vecs) stay native on the host path
    assert splits > 0 and tags == {"", "split2"}
    assert out["max_err_low_half"] < 1e-3
    assert escs <= splits


def test_run_mini_native_matches_reference():
    """Same seed, same numpy draws, same iteration, no split scheme: the
    same dgemm calls in both packages, and Ritz values that agree with
    each other (the summation orders differ: ~1e-13 on values ~1)."""
    kw = dict(ngrid=256, nstates=12, scf=4)
    with repro.session(JConfig(policy="dfu", threshold=100)) as s:
        want = jdft.run_mini(**kw)
        jcalls = {k: v.calls for k, v in s.stats.per_routine.items()}
    with repro_torch.session(OffloadConfig(policy="dfu", threshold=100),
                             device="cpu") as s:
        got = dft.run_mini(device="cpu", **kw)
        tcalls = {k: v.calls for k, v in s.stats.per_routine.items()}
        assert s.stats.uninstrumented_calls == 0
    assert tcalls == jcalls and tcalls["dgemm"] > 0
    assert got["exact_min"] == want["exact_min"]
    for key in ("ritz_min", "max_err_low_half"):
        assert abs(got[key] - want[key]) <= 1e-8, key


def test_production_trace_matches_reference(tmp_path):
    kw = dict(ngrid=4096, nstates=96, nblock=32, scf=1, filt_per_scf=2)
    dft.production_trace(**kw).dump(str(tmp_path / "port.json"))
    jdft.production_trace(**kw).dump(str(tmp_path / "ref.json"))
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == json.loads((tmp_path / "ref.json").read_text())
    assert len(port["calls"]) == 2 * 3 * 46
    assert dft.PROD == jdft.PROD

"""The CheFSI cell at a tiny size on the port's simulated CPU tiers: the
app against its plain reference, the reference against NumPy and SciPy,
planted faults that the checks must catch, the counts against hand
values and the cell as ``BENCHMARK.json`` names it; and LSMS under
Mem-Copy, which is not a cell yet."""
import dataclasses

import numpy as np
import pytest
import scipy.linalg
import torch

from portbench import counts, counts_chefsi, harness, readings
from portbench.apps import chefsi as app_module
from portbench.reference import chefsi
from repro_torch.core import memspace

SEED = 2 ** 31 + 77
CHEFSI = dict(ngrid=120, grid=[4, 5, 6], nstates=16, warmup_steps=2,
              trace_steps=2)
LSMS = dict(n=48, nrhs=4, atoms_per_node=2, energies=3, tpool=3, nb=16,
            warmup_steps=2, trace_steps=2)


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny factorizations run in microseconds on one thread and in
    tens of milliseconds when a pool of threads wakes for each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def tiny(workload, size, sample_steps=3):
    cell = harness.load_cell(workload)
    cfg = {**cell.config, **size}
    cfg["session"] = {**cfg["session"], "threshold": 1.0,
                      "lapack_nb": size.get("nb", 16)}
    return dataclasses.replace(cell, config=cfg, traffic={
        **cell.traffic, "sample_steps": sample_steps})


def over(cell, seed, samples):
    worst, failed = harness.check(cell, seed, "cpu", samples)
    limits = cell.config["checks"]
    return {k for k, v in worst.items() if not v <= limits[k]}, failed


def test_the_cell_loads_as_benchmark_json_names_it():
    c = harness.load_cell("chefsi.resident")
    assert c.chips == 1 and c.config["app"] == "chefsi"
    assert (c.config["ngrid"], c.config["nstates"]) == (93536, 2400)
    assert c.config["reduced"] == [] and c.config["spin_channels"] == 2
    g = c.config["grid"]
    assert g[0] * g[1] * g[2] == c.config["ngrid"]
    assert harness.session_settings(c) == {
        "policy": "dfu", "kernel_path": True, "lapack": False,
        "adaptive": False, "sync": False}
    assert {m["name"] for m in c.end_to_end} == {"step_s.parsec", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "orth_ms", "rr_ms", "trsm_ms", "blas_roofline.chefsi",
        "step_mfu.chefsi", "idle_share.chefsi",
        "dispatch_us_per_call.chefsi", "link_mb_per_step.chefsi"}


@pytest.mark.parametrize("traced", [False, True])
def test_chefsi_cell_runs_correct_and_reports_its_metrics(traced):
    cell = tiny("chefsi.resident", CHEFSI)
    r = harness.run(cell, SEED, 0.1, traced, "cpu", log=lambda m: None)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"w_err", "r_err", "psi_err"}
    names = set(r["metrics"])
    if not traced:
        assert names == {"step_s.parsec", "setup_s"}
    else:
        # the CUDA-event spans and the device trace find nothing here
        assert names == {"step_mfu.chefsi", "dispatch_us_per_call.chefsi",
                         "link_mb_per_step.chefsi"}
        # Psi and H Psi moved once in the warm-up; device-born S, R,
        # Psi_o and HPsi_o feed the later calls where they are
        assert r["metrics"]["link_mb_per_step.chefsi"]["value"] == 0.0


def test_chefsi_step_calls_each_routine_once_per_step():
    cell = tiny("chefsi.resident", CHEFSI)
    app = app_module.App(cell.config, cell.traffic, SEED, "cpu",
                         harness.Probe(False), harness.session_settings(cell))
    app.setup()
    try:
        before = {k: v.calls for k, v in app.stats().per_routine.items()}
        moved = harness.counters(app.stats())["bytes_in"]
        for _ in range(3):
            app.step()
        calls = {k: v.calls - before.get(k, 0)
                 for k, v in app.stats().per_routine.items()}
        assert harness.counters(app.stats())["bytes_in"] == moved
    finally:
        app.close()
    assert calls == {"dsyrk": 3, "dtrsm": 6, "dgemm": 6}


def _fault_trsm(monkeypatch, app):
    real = app_module.blas.trsm

    def trsm(a, b, **kw):
        if any(b is h for h in app.hpsi):
            return b                            # HPsi left unsolved
        return real(a, b, **kw)
    monkeypatch.setattr(app_module.blas, "trsm", trsm)


def _fault_hs(monkeypatch, app):
    real = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, "eigh",
                        lambda h: real(h.float().double()))


def _fault_r(monkeypatch, app):
    real = torch.linalg.cholesky

    def cholesky(s, upper=False):
        r = real(s, upper=upper)
        r[:-1, -1] = 0          # R's last column zeroed above its diagonal
        return r
    monkeypatch.setattr(torch.linalg, "cholesky", cholesky)


@pytest.mark.parametrize("plant,caught", [
    (_fault_trsm, {"w_err", "psi_err"}),
    (_fault_hs, {"w_err"}),
    (_fault_r, {"r_err", "psi_err"})])
def test_planted_faults_fail_the_checks(monkeypatch, plant, caught):
    """Each fault in the program's step, the reference left intact: HPsi
    not solved, Hs rounded to float32 before eigh, R's last column
    zeroed but for its diagonal (which keeps the solves finite)."""
    cell = tiny("chefsi.resident", CHEFSI)
    app = app_module.App(cell.config, cell.traffic, SEED, "cpu",
                         harness.Probe(False), harness.session_settings(cell))
    app.setup()
    try:
        with monkeypatch.context() as m:
            plant(m, app)
            samples = [app.step()[::2] for _ in range(2)]
    finally:
        app.close()
    bad, failed = over(cell, SEED, samples)
    assert failed == 2 and caught <= bad, bad


def test_control_fails_the_limits_the_program_passes():
    cell = tiny("chefsi.resident", CHEFSI, sample_steps=2)
    rows = readings.readings(cell, [11], [13], "cpu", emit=lambda r: 0)
    limits = cell.config["checks"]
    for r in rows:
        bad = {k for k, v in r["numbers"].items() if not v <= limits[k]}
        assert bool(bad) == (r["side"] == "control:lower"), r


def test_hamiltonian_is_the_dense_stencil():
    """The 7-point -1/2 Laplacian plus V, Dirichlet, against the dense
    matrix built from Kronecker products."""
    grid = (3, 4, 5)
    gen = torch.Generator().manual_seed(3)
    psi = torch.randn(60, 7, generator=gen, dtype=torch.float64)
    v = torch.rand(60, generator=gen, dtype=torch.float64)

    def second(n):
        return 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    eyes = [np.eye(n) for n in grid]
    lap = (np.kron(np.kron(second(grid[0]), eyes[1]), eyes[2])
           + np.kron(np.kron(eyes[0], second(grid[1])), eyes[2])
           + np.kron(np.kron(eyes[0], eyes[1]), second(grid[2])))
    h = 0.5 * lap + np.diag(v.numpy())
    got = chefsi.hamiltonian(psi, v, grid)
    np.testing.assert_allclose(got.numpy(), h @ psi.numpy(), atol=1e-13)


def test_reference_against_scipy():
    """Ritz values are the eigenvalues of the pencil (Psi^T H Psi,
    Psi^T Psi); Psi_new spans Psi's columns, is orthonormal and turns
    Psi^T H Psi diagonal; R^T R = Psi^T Psi."""
    cfg = {**harness.load_cell("chefsi.resident").config, **CHEFSI}
    inputs = chefsi.make_inputs(cfg, {}, SEED, "cpu")
    for step in range(3):
        ch = step % 2
        psi = inputs["psi"][ch].numpy()
        hpsi = inputs["hpsi"][ch].numpy()
        got = chefsi.reference(cfg, {}, inputs, step)
        a, b = psi.T @ hpsi, psi.T @ psi
        np.testing.assert_allclose(got["w"].numpy(),
                                   scipy.linalg.eigh(a, b, eigvals_only=True),
                                   rtol=0, atol=1e-12)
        r = got["r"].numpy()
        assert np.all(np.diag(r) > 0) and np.allclose(np.tril(r, -1), 0)
        np.testing.assert_allclose(r.T @ r, b, rtol=1e-13, atol=1e-10)
        new = got["psi"].numpy()
        np.testing.assert_allclose(new.T @ new, np.eye(16), atol=1e-13)
        # Psi_new = Psi C, so H Psi_new = (H Psi) C
        c = np.linalg.lstsq(psi, new, rcond=None)[0]
        np.testing.assert_allclose(psi @ c, new, atol=1e-13)
        np.testing.assert_allclose(new.T @ hpsi @ c,
                                   np.diag(got["w"].numpy()), atol=1e-12)
        assert np.diff(got["w"].numpy()).min() > 0


def test_inputs_follow_the_seed():
    cfg = {**harness.load_cell("chefsi.resident").config, **CHEFSI}
    a = chefsi.make_inputs(cfg, {}, SEED, "cpu")
    b = chefsi.make_inputs(cfg, {}, SEED, "cpu", steps=[5])
    c = chefsi.make_inputs(cfg, {}, SEED + 1, "cpu")
    for name in ("psi", "hpsi"):
        for ch in range(2):
            assert torch.equal(a[name][ch], b[name][ch])
            assert not torch.equal(a[name][ch], c[name][ch])
    assert not torch.equal(a["psi"][0], a["psi"][1])
    with pytest.raises(ValueError):
        chefsi.make_inputs({**cfg, "grid": [4, 5, 5]}, {}, SEED, "cpu")


def test_compare_matches_signs_and_reads_each_output():
    cfg = {**harness.load_cell("chefsi.resident").config, **CHEFSI}
    inputs = chefsi.make_inputs(cfg, {}, SEED, "cpu")
    want = chefsi.reference(cfg, {}, inputs, 0)
    flipped = dict(want, psi=want["psi"] * torch.where(
        torch.arange(16) % 3 == 0, -1.0, 1.0).double())
    assert chefsi.compare(flipped, want) == {"w_err": 0.0, "r_err": 0.0,
                                             "psi_err": 0.0}
    off = dict(want, w=want["w"].clone())
    off["w"][4] += 1e-3 * want["w"].abs().max()
    assert chefsi.compare(off, want)["w_err"] == pytest.approx(1e-3)


def test_counts_at_the_paper_shape():
    k, n, dt = 93536, 2400, "float64"
    flops, nbytes = counts_chefsi.trsm(k, n, dt)
    assert flops == k * n * n == pytest.approx(5.38767e11, rel=1e-5)
    assert nbytes == 8 * (n * (n + 1) // 2 + 2 * k * n)
    assert counts.bound_s(flops, nbytes) * 1e3 == \
        pytest.approx(8.0413, rel=1e-4)
    assert counts_chefsi.potrf(n, dt) == n ** 3 / 3
    assert counts_chefsi.eigh(n, dt) == pytest.approx(10 * n ** 3 / 3)
    step = counts_chefsi.step(k, n, dt)
    hand = (n * (n + 1) * k + n ** 3 / 3 + 2 * k * n * n
            + 2 * (2 * n * n * k) + 10 * n ** 3 / 3)
    assert step == pytest.approx(hand) == pytest.approx(3.8223e12, rel=1e-4)
    assert step / counts.F64_PEAK * 1e3 == pytest.approx(
        57.04, rel=1e-3)
    # a 3 x 2 side-R solve: 2 multiply-adds a row, 3 rows, 2 operations
    # each; complex: 4 real operations a complex one
    assert counts_chefsi.trsm(3, 2, dt)[0] == 12.0
    assert counts_chefsi.trsm(3, 2, "complex128")[0] == 48.0
    with pytest.raises(ValueError):
        counts_chefsi.potrf(2, "bfloat16")


def test_memcopy_moves_every_call_in_and_out():
    """LSMS under Mem-Copy (the paper's Table 3 baseline, not yet a
    cell): the zgemm takes G in and gives tG back on every step, the
    solver tier's trsm and trailing updates send their outputs out and
    take them in again, so the bytes a step are those shapes' (n 48, nb
    16, 4 right-hand sides); and tau comes back on the host tier, where
    a run on the card cannot compare it with the reference's as
    ``reference/lsms.py`` does today."""
    cell = tiny("lsms.resident", LSMS)
    cell.traffic = {**cell.traffic, "session": {"policy": "memcopy"}}
    cell.per_layer = [m for m in cell.per_layer
                      if m["name"] == "link_mb_per_step.lsms"]
    r = harness.run(cell, SEED, 0.1, True, "cpu", log=lambda m: None)
    assert r["correct"], r["checks"]
    n, nb, nrhs, z = 48, 16, 4, 16
    rest = [n - j - nb for j in range(0, n, nb) if j + nb < n]
    per_step = (2 * n * n + sum(2 * nb * x + x * x for x in rest)
                + 3 * n * nrhs) * z
    assert r["metrics"]["link_mb_per_step.lsms"]["value"] == \
        pytest.approx(per_step / 1e6)
    app = harness.app_module(cell.config).App(
        cell.config, cell.traffic, SEED, "cpu", harness.Probe(False),
        harness.session_settings(cell))
    app.setup()
    try:
        assert memspace.tier_of(app.step()[2]["tau"]) == memspace.HOST
    finally:
        app.close()

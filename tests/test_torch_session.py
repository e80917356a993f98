"""Sessions of the port against the reference: the quickstart workload
twin (counters and trace equal), the device rule of the entry points,
nesting, the atexit dump, and the import rule of the port."""
import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core.config import OffloadConfig as JConfig  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.apps import lsms  # noqa: E402
from repro_torch.core import host_array  # noqa: E402
from repro_torch.core import session as tses  # noqa: E402
from repro_torch.core.config import OffloadConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _jax_application(a, b, x):
    """examples/quickstart.py's application_code.  The gemv's vector is
    passed in: a column of a host array is itself host memory on JAX
    releases with host memory kinds, while the simulated tier counts a
    fresh slice as device-born, so the twins take a device-born vector."""
    c = jnp.matmul(a, b)
    for _ in range(5):
        c = jnp.matmul(a, c)
    d = jnp.einsum("ij,kj->ik", c, b)
    small = jnp.dot(a[:64, :64], b[:64, :64])
    y = jnp.matmul(a, x)
    return c, d, small, y


def _torch_application(a, b, x):
    """The same application in PyTorch, with torch.mm in jnp.dot's role."""
    c = torch.matmul(a, b)
    for _ in range(5):
        c = a @ c
    d = torch.einsum("ij,kj->ik", c, b)
    small = torch.mm(a[:64, :64], b[:64, :64])
    y = torch.matmul(a, x)
    return c, d, small, y


def _strip(path):
    data = json.loads(Path(path).read_text())
    for call in data["calls"]:
        del call["callsite_id"], call["seconds"]
    return data


def test_quickstart_twin_counts_and_traces_like_reference(tmp_path):
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((768, 768)).astype("float32")
    b_np = rng.standard_normal((768, 768)).astype("float32")
    jpath, tpath = str(tmp_path / "ref.json"), str(tmp_path / "port.json")

    ja, jb = jcore.host_array(a_np), jcore.host_array(b_np)
    with repro.session(JConfig(policy="dfu", threshold=500.0,
                               trace_path=jpath)) as s:
        jres = _jax_application(ja, jb, jnp.asarray(b_np[:, 0]))
        s.sync()
        jstats = {k: dataclasses.asdict(v)
                  for k, v in s.stats.per_routine.items()}
        jreport = s.report().splitlines()
    ta, tb = host_array(a_np), host_array(b_np)
    with repro_torch.session(OffloadConfig(policy="dfu", threshold=500.0,
                                           trace_path=tpath),
                             device="cpu") as s:
        tres = _torch_application(ta, tb, torch.as_tensor(b_np[:, 0]))
        s.sync()
        tstats = {k: dataclasses.asdict(v)
                  for k, v in s.stats.per_routine.items()}
        treport = s.report().splitlines()
        reuse = s.runtime.mean_buffer_reuse()
        assert s.stats.uninstrumented_calls == 0

    assert tstats.keys() == jstats.keys() == {"sgemm", "sgemv"}
    for name, st in tstats.items():
        for field, value in st.items():
            if field not in ("seconds", "flops"):
                assert value == jstats[name][field], (name, field)
    assert (tstats["sgemm"]["offloaded"], tstats["sgemm"]["on_host"]) == (7, 1)
    assert reuse > 1.0
    # the report has the reference's layout (times and sites aside)
    assert treport[:2] == jreport[:2]
    assert [ln.split()[:4] for ln in treport[2:4]] == \
        [ln.split()[:4] for ln in jreport[2:4]]
    assert _strip(tpath) == _strip(jpath)
    # results: float32 sums in different orders over K = 768, chained 6x
    for got, want in zip(tres, jres):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 2e-4 * np.abs(want).max()


def test_entry_points_run_on_the_card_or_raise(monkeypatch):
    """Without CUDA, session() and run_mini() refuse to start unless the
    CPU is asked for; they never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.session()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.session(OffloadConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lsms.run_mini(atoms=1, energies=1, scf=1, n=8)
    with repro_torch.session(device="cpu") as s:
        assert s.runtime.device == torch.device("cpu")
        assert s.runtime.memspace.simulated
    out = lsms.run_mini(atoms=1, energies=1, scf=1, n=8, device="cpu")
    assert out["n_solves"] == 1


def test_sessions_nest_and_restore():
    orig = torch.matmul
    outer = repro_torch.session(OffloadConfig(threshold=10.0), device="cpu")
    try:
        with repro_torch.session(OffloadConfig(threshold=1e9),
                                 device="cpu") as inner:
            assert repro_torch.active_session() is inner
            a = torch.ones((32, 32))
            torch.matmul(a, a)
            assert inner.stats.per_routine["sgemm"].on_host == 1
        assert repro_torch.active_session() is outer
        torch.matmul(a, a)
        assert outer.stats.per_routine["sgemm"].offloaded == 1
        assert torch.matmul is not orig
    finally:
        outer.close()
    assert torch.matmul is orig and repro_torch.active_session() is None
    assert outer.close() is None          # idempotent


def test_reconfigure_and_atexit_dump(tmp_path):
    path = tmp_path / "atexit.json"
    s = repro_torch.session(OffloadConfig(trace_path=str(path)),
                            device="cpu")
    try:
        s.reconfigure(threshold=10.0, device_bytes=1 << 20, evict="lfu")
        assert s.runtime.threshold == 10.0
        assert s.runtime.placements.cap == 1 << 20
        a = torch.ones((32, 32))
        a @ a
        tses._atexit_dump()
        assert json.loads(path.read_text())["calls"][0]["routine"] == "sgemm"
        path.unlink()
    finally:
        s.close()
    assert not path.exists()              # dumped once, not again on close


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(ast.parse(path.read_text())):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)

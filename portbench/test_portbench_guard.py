"""No module the benchmark runs imports JAX or the JAX package: the
top-level name of each import is compared whole (``repro_torch`` starts
with ``repro`` and is the program under test)."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parent


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py")]
    assert len(files) > 10
    for p in files:
        assert not _imports(p) & set(harness.FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        assert _imports(p) <= {"__future__", "math", "torch"}, p
    assert _imports(HERE / "counts.py") <= {"__future__"}


def test_forbidden_names_compare_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "repro_torch.fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib", "repro"]


def test_a_run_loads_neither():
    """A run in a fresh process (pytest's may hold the JAX package from
    other tests) loads none of them, traced steps included."""
    code = (
        "import sys, dataclasses\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('lsms.resident')\n"
        "cfg = {**cell.config, 'n': 32, 'nrhs': 4, 'atoms_per_node': 2,\n"
        "       'tpool': 2, 'warmup_steps': 2}\n"
        "cfg['session'] = {**cfg['session'], 'threshold': 1.0,\n"
        "                  'lapack_nb': 8}\n"
        "cell = dataclasses.replace(cell, config=cfg)\n"
        "r = harness.run(cell, 3, 0.1, True, 'cpu', log=print)\n"
        "assert r['correct'], r\n"
        "print('LOADED', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout

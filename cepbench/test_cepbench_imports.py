"""Nothing the benchmark runs loads JAX or the JAX package (``repro``;
top-level names compared whole: ``repro_torch`` is the port), and the
plain reference loads nothing of the program."""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "cepbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# The reference and what it reads, which may not load the program.
PLAIN = ["cepbench.reference.arith", "cepbench.reference.patterns",
         "cepbench.reference.engine", "cepbench.reference.model",
         "cepbench.check", "cepbench.traffic", "cepbench.control"]


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of every module the file imports, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("mod", PLAIN)
def test_plain_reference_imports_no_program(mod):
    path = ROOT / (mod.replace(".", "/") + ".py")
    assert not _imports(path) & ({"repro_torch", "torch"} | FORBIDDEN)


def _loaded(code: str) -> set[str]:
    res = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    return set(res.stdout.split())


def test_a_run_loads_no_jax():
    """What a run loads: the harness, the program's runtime and kernels,
    the profiler."""
    got = _loaded("from cepbench import harness, tracing, roofline\n"
                  "from repro_torch import runtime\n"
                  "from repro_torch.cep import runner\n"
                  "from repro_torch.kernels import ops, _build\n"
                  "import torch.profiler\n"
                  "print(harness.forbidden_modules())")
    assert "repro_torch" in got and not got & FORBIDDEN


def test_the_reference_loads_no_program():
    got = _loaded("import " + ", ".join(PLAIN))
    assert not got & ({"repro_torch", "torch"} | FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types

    from cepbench import harness
    for name in ("repro_torch_probe", "repro.cepbench_probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert "repro.cepbench_probe" in found
    assert "repro_torch_probe" not in found

"""The port imports nothing of JAX or of the JAX package.

Checked twice: by importing every module of ``lda_thesis_tpu_torch`` and
``chip_smoke`` in a fresh interpreter (this test process has imported jax
already, through tests/conftest.py), and by scanning their source for
import statements.  Module names are compared whole, since
``lda_thesis_tpu_torch`` itself begins with ``lda_thesis_tpu``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "lda_thesis_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lda_thesis_tpu")


def _modules():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r}))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_hslda_modules_are_scanned():
    """HSLDA's modules are among those imported and scanned above."""
    names = _modules()
    for mod in ("ops.hslda_gibbs", "models.hslda", "cli.evaluate_hslda"):
        assert f"lda_thesis_tpu_torch.{mod}" in names


def test_parallel_modules_are_scanned():
    """The parallel layer's modules are among those imported and scanned."""
    names = _modules()
    for mod in ("_util", "bootstrap", "sharded", "fused_sharded", "fused_sharded_buckets",
                "vocab_sharded", "trainer", "sharded_io", "launch", "jobs", "hslda_sharded",
                "hslda_trainer"):
        assert f"lda_thesis_tpu_torch.parallel.{mod}" in names


def test_spawned_worker_loads_no_jax():
    """A spawned rank runs without jax (this test process has it loaded),
    and the launcher refuses a worker that loads it."""
    from lda_thesis_tpu_torch.parallel.launch import spawn

    out = spawn("lda_thesis_tpu_torch.parallel.jobs:mesh_job", 2,
                {"shapes": [(1, 2)]}, device="cpu", timeout=120)
    assert [r["meshes"][0]["row_sum"] for r in out] == [1.0, 1.0]
    with pytest.raises(RuntimeError, match="loaded .*jax"):
        spawn("jax.numpy:dtype", 1, "float32", device="cpu", timeout=120)  # imports jax

"""What the harness loads: no JAX and no JAX package; the references load
nothing of the program.  Module names are compared by their top-level
name, whole, since the port's name begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

import portbench_tiny as tiny

JAX = ("jax", "jaxlib", "flax", "lda_thesis_tpu")
REFERENCES = sorted((tiny.PORTBENCH / "reference").glob("*.py"))


def _loaded(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                           "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                          cwd=tiny.CHECKOUT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax(tmp_path):
    cells = [w["name"] for w in tiny.bench()["workloads"]]
    code = (f"import sys; sys.path.insert(0, {str(tiny.HERE)!r})\n"
            "import portbench_tiny as tiny\n"
            "from portbench import control\n"
            f"base = tiny.copy({str(tmp_path)!r})\n"
            f"for cell in {cells!r}:\n"
            "    tiny.run(base, cell, trace=True)\n")
    assert not _loaded(code) & set(JAX)


def test_the_references_load_nothing_of_the_program():
    code = "\n".join(f"import portbench.reference.{p.stem}" for p in REFERENCES
                     if p.stem != "__init__")
    loaded = _loaded(code)
    assert "lda_thesis_tpu_torch" not in loaded and not loaded & set(JAX)


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else ["relative"]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in JAX + ("lda_thesis_tpu_torch", "relative"), name

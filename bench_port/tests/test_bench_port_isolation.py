"""Nothing of the benchmark loads the JAX stack, the JAX package ``xgan``
or ``bench.py``, and the reference loads nothing of the program; module
names are compared by their whole top-level name, so ``xgan_torch`` is
not taken for ``xgan``."""
import ast
import subprocess
import sys

import pytest

from bench_port import catalog, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "xgan", "bench"}
FILES = sorted(p for p in catalog.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def imported_top_names(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_whole_names_are_compared():
    assert "xgan_torch".split(".")[0] not in FORBIDDEN
    assert "xgan.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(catalog.HERE)))
def test_no_module_imports_jax_or_xgan(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (catalog.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_names(path)
    assert "xgan_torch" not in names
    assert names <= {"__future__", "torch", "math", "contextlib",
                     "dataclasses"}


REHEARSAL = """
import sys
sys.path[0] = "."
from bench_port import rehearse
rc = rehearse.main(["--cells", "dcgan224-b128-k4,wgan224-b64-n5,dcgan224-b128-dp1-k4"])
loaded = {m.split(".")[0] for m in sys.modules}
print("program", "xgan_torch" in loaded)
print("forbidden", sorted(loaded & %r))
sys.exit(rc)
"""


def test_a_cpu_rehearsal_loads_none_of_them():
    proc = subprocess.run([sys.executable, "-c", REHEARSAL % FORBIDDEN],
                          cwd=catalog.ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-2:] == ["program True",
                                                     "forbidden []"]
    assert set(harness.FORBIDDEN) == FORBIDDEN - {"bench"}

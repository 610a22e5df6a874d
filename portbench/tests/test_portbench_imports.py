"""The import boundary: nothing under portbench/ imports JAX or the JAX
package, compared by the top-level name whole (the port's own name,
tpu_msm_torch, begins with the JAX package's), and the reference
imports nothing of the program."""

import ast
import glob
import os

from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_msm"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    return sorted(glob.glob(os.path.join(BENCH_DIR, "**", "*.py"),
                            recursive=True))


def test_no_module_imports_jax_or_the_jax_package():
    assert len(sources()) > 10
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_whole_name_comparison():
    # tpu_msm_torch is the port and allowed; tpu_msm is not
    assert "tpu_msm_torch".split(".")[0] not in FORBIDDEN
    assert "tpu_msm.cuzk".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "work.py"):
        names = top_level_imports(os.path.join(BENCH_DIR, name))
        assert names <= {"__future__", "dataclasses", "typing", "numpy"}, \
            (name, names)


def test_run_py_checks_loaded_modules_by_whole_name(monkeypatch):
    import sys

    import run
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "tpu_msm_torch_fake", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert set(run.forbidden_modules()) - before == {"jax.numpy"}

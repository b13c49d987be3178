"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's, so a
prefix match would be wrong); the references import nothing of the
port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT

JAX_NAMES = {"jax", "jaxlib", "flax", "generative_physics_informed_pde_tpu"}
PORT = "generative_physics_informed_pde_tpu_torch"

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests import tiny
_, _, out = tiny.execute({cell!r})
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps({{"correct": out["correct"], "tops": tops}}))
"""


@pytest.mark.parametrize("cell", ["c5-sweep", "c3-label", "c3-train"])
def test_a_run_loads_no_jax(cell):
    env_cmd = [sys.executable, "-c", CHILD.format(root=str(ROOT), cell=cell)]
    res = subprocess.run(env_cmd, capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not JAX_NAMES & set(got["tops"])
    assert PORT in got["tops"]


def test_whole_name_comparison():
    from portbench import run

    assert run.forbidden_modules([PORT, PORT + ".fem", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", PORT]) == ["jax"]
    assert run.forbidden_modules(
        ["generative_physics_informed_pde_tpu.fem"]) == [
        "generative_physics_informed_pde_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & (JAX_NAMES | {PORT}), tops


def test_references_load_no_port_module():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference.fem, portbench.reference.vae; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(JAX_NAMES | {PORT})!r}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_no_harness_file_names_the_old_benchmark():
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & JAX_NAMES, path
        text = path.read_text()
        for old in ("bench.py", "BENCH_r", "MULTICHIP_r", "benchmarks/"):
            assert old not in text, (path, old)

"""No module the benchmark runs is JAX's or the JAX package's, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tinybench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: the yardstick: imports neither the program nor JAX
PLAIN = ["reference", "qir", "counts", "loadgen", "trace", "layout",
         "graphs.ic_cnn", "graphs.cnv"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, f"{path.name} imports {bad}"


def test_only_the_harness_imports_the_program():
    users = {p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")
             if "repro_torch" in set(_imports(p))
             and not p.name.startswith("test_")}
    assert users == {"harness.py"}


def test_names_compare_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.deploy",
                              "jaxtyping", "reproducible"]) == []
    assert forbidden_modules(["repro", "repro.core", "jax.numpy", "jaxlib",
                              "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def _child(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(CHECKOUT), str(CHECKOUT / "src")]), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_neither_the_program_nor_jax():
    mods = _child("import json, sys\n" + "".join(
        f"import tinybench.{m}\n" for m in PLAIN)
        + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(mods) & (set(FORBIDDEN) | {"repro_torch"})


@pytest.mark.parametrize("cell", ["cnv_w1a1.singlestream"])
def test_a_run_loads_no_jax(cell):
    got = _child(
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from tinybench import harness\n"
        "from tinybench.run import forbidden_modules\n"
        f"r = harness.run_cell({cell!r}, 7, 0.05, False, device='cpu',\n"
        "    traffic_override={'pool_samples': 4, 'warmup_calls': 1,\n"
        "                      'check_calls': 2})\n"
        "print(json.dumps({'bad': forbidden_modules(),\n"
        "                  'port': 'repro_torch' in sys.modules,\n"
        "                  'correct': r['correct']}))")
    assert got == {"bad": [], "port": True, "correct": True}

"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``),
and nothing reads the JAX package's ``benchmarks/``."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
FILES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_path_into_benchmarks(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks/" not in node.value.replace("\\", "/") \
                or path.parent.name == "tests", path.name


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


RUN_AND_LIST = """
import dataclasses, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness
man = harness.manifest()
for w in man["workloads"]:
    c = harness.cell(man, w["name"])
    small = {{"fem_p1": {{"n": 4}}, "ransparse": {{"siz": 100}}}}
    c = dataclasses.replace(
        c, config={{**c.config, **small[c.config["generator"]]}})
    for trace in (0, 1):
        assert harness.run_cell(c, 3, 0.02, trace, device="cpu")["correct"]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_forbidden_module():
    code = RUN_AND_LIST.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN


def test_run_py_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fem_p1_1999.assemble", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=_env(),
        timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_only_the_benchmark_files_run_nothing(tmp_path):
    """A checkout that holds only ``BENCHMARK.json`` and ``portbench/``
    has no port to run: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [{root!r}, {root!r} + '/src']\n"
            "from portbench import harness\n"
            "c = harness.cell(harness.manifest(), 'fem_p1_1999.assemble')\n"
            "print(harness.run_cell(c, 1, 0.01, 0, device='cpu'))\n"
            ).format(root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "No module named 'repro_torch'" in out.stderr

"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and
``kernel_times.py`` import nothing of JAX, nothing of the JAX package
``repro`` and not ``ml_dtypes``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]
#: ``ml_dtypes`` (the reference checkpoint's bfloat16) is not installed on
#: the card's machine
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("chip_smoke.py", "kernel_times.py",
                 "src/repro_torch/sparse/matlab.py",
                 "src/repro_torch/models/model.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/configs/olmoe_1b_7b.py",
                 "src/repro_torch/train/sparse_grads.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/train/optimizer.py",
                 "src/repro_torch/train/train_step.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/ckpt/checkpoint.py",
                 "src/repro_torch/serve/__init__.py",
                 "src/repro_torch/kernels/radix_sort/radix_sort.py",
                 "src/repro_torch/kernels/segment_sum/segment_sum.py"):
        assert must in names


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"

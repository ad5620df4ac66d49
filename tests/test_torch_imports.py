"""Guards of the port's boundaries.

* No file of ``src/repro_torch`` and not ``chip_smoke.py`` imports ``jax``
  or the JAX package ``repro`` (an AST scan of every import statement).
* The entry points default to the CUDA device and raise where there is no
  card, instead of running on the CPU.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "solver.py", "ops.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _entry_points():
    import repro_torch.core as tc
    X = np.random.default_rng(0).standard_normal((20, 10))
    y = X[:, 0]
    return {
        "solve": lambda: tc.solve(X, y, tc.Quadratic(), tc.L1(0.1)),
        "make_engine": lambda: tc.make_engine(tc.L1(0.1), tc.Quadratic()),
        "lambda_max": lambda: tc.lambda_max(X, y),
        "Lasso.fit": lambda: tc.Lasso(alpha=0.1).fit(X, y),
        "LinearSVC.fit": lambda: tc.LinearSVC().fit(X, np.sign(y)),
    }


@pytest.mark.parametrize("name", ["solve", "make_engine", "lambda_max",
                                  "Lasso.fit", "LinearSVC.fit"])
def test_default_device_is_cuda_and_raises_without_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()

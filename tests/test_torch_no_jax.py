"""The port and its smoke script import neither JAX, flax nor the JAX
package, nor OpenCV, PIL, pandas, tensorboardX or tensorboard, nor the
checkpoint libraries tensorstore, zstandard, zarr or numcodecs: they run on
machines that have only PyTorch, numpy and scipy."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tecogan_tpu",
             "cv2", "PIL", "pandas", "tensorboardX", "tensorboard",
             "tensorstore", "zstandard", "zarr", "numcodecs"}
PACKAGE = REPO / "tecogan_tpu_torch"
SOURCES = sorted(p for p in PACKAGE.rglob("*.py")
                 if "_build" not in p.relative_to(PACKAGE).parts)  # build output
SOURCES.append(REPO / "chip_smoke.py")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_found():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"

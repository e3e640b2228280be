"""The port stands alone: it imports no JAX, no Flax and nothing of the JAX
package, and it imports without OpenCV."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "video_desensitization_torch"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["cv2"] = None  # any `import cv2` now raises ImportError
import video_desensitization_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from video_desensitization_torch.ops.image import cv2_resize_formula
assert cv2_resize_formula((96, 160), (76, 128)) is None
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "video_desensitization_tpu"))
print(len(names), bad)
"""


def test_package_imports_without_jax_or_cv2():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 50
    assert bad == "[]"


SOURCES = sorted(
    str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py") if "_build" not in p.parts
)


@pytest.mark.parametrize("path", SOURCES)
def test_source_never_names_the_jax_package(path):
    text = (REPO / path).read_text()
    assert "video_desensitization_tpu" not in text
    assert "import jax" not in text and "from jax" not in text


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py names the TPU kernel it replaces, but imports none of it."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "video_desensitization_tpu"}
    assert "video_desensitization_torch" in roots

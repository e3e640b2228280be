"""Every public name of the JAX package has its counterpart in the port.

Both packages are parsed with ``ast`` (nothing of JAX is imported). For
each public top-level function, class, public method (and a Flax module's
``__call__``) and UPPER_CASE constant of
``video_desensitization_tpu/<path>.py``, the port's
``video_desensitization_torch/<path>.py`` defines the same name, unless
``DEPARTURES`` lists it with its counterpart and its reason. That table is
the port's record of what it left out or moved on purpose. Each package's
``__all__`` equals the JAX one and resolves in the port, and each ``vdt-*``
console script has a ``vdt-torch-*`` counterpart whose target resolves.
"""

import ast
import importlib
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "video_desensitization_tpu"
PORT_PKG = REPO / "video_desensitization_torch"

# JAX module -> the port's module, where the file moved.
MODULES = {"ops/pallas_mosaic.py": "ops/cuda_mosaic.py"}

# "JAX module::name" -> ("port module::name" or None, the reason).
DEPARTURES = {
    "ops/pallas_mosaic.py::mosaic_boxes_batch_pallas": (
        "ops/cuda_mosaic.py::mosaic_boxes_batch_cuda_",
        "the kernel's wrapper, in place on (B, H, W, C) frames"),
    "ops/pallas_mosaic.py::mosaic_boxes_batch_pallas_flat": (
        "ops/cuda_mosaic.py::mosaic_boxes_batch_cuda_",
        "the flat (B, H, W*C) operand is a TPU lane layout; the CUDA kernel reads NHWC"),
    "ops/pallas_mosaic.py::mosaic_i420_batch_pallas": (
        "ops/cuda_mosaic.py::mosaic_i420_batch_cuda_",
        "the I420 wrapper: two kernel calls on views of the buffer"),
    "ops/pallas_mosaic.py::pallas_mosaic_supported": (
        None, "the CUDA kernel takes every shape, channel count and level"),
    "ops/pallas_mosaic.py::STRIP": (None, "TPU tiling: rows of a VMEM window"),
    "ops/pallas_mosaic.py::PAD": (None, "TPU tiling: the row lookback above a strip"),
    "ops/pallas_mosaic.py::OUT_ROWS": (None, "TPU tiling: output rows of a strip"),
    "models/common.py::leaky_relu": (
        "models/common.py::ConvBN", "torch's own nn.LeakyReLU and nn.ReLU, in ConvBN"),
    "train/step.py::param_partition_spec": (
        "parallel/tensor.py::param_partition_spec", "the model axis lives in parallel/tensor.py"),
    "train/step.py::make_sharding_rules": (
        "parallel/tensor.py::make_sharding_rules", "the model axis lives in parallel/tensor.py"),
    "pipeline/throughput.py::DEFAULT_STREAM_DEPTH": (
        "pipeline/throughput.py::STREAM_DEPTH", "the same 5; no argument takes it as a default"),
    "pipeline/throughput.py::DEFAULT_TRANSFER_WORKERS": (
        "pipeline/throughput.py::TieredPipeline.dispatch",
        "the JAX default 0 (copies in the dispatch thread) is the port's only way: "
        "non-blocking copies from pinned memory on the pipeline's stream"),
    "video/av.py::_LIB_PATH": (
        "utils/native.py::build_library", "built at first use into _build/, keyed by the source hash"),
    "video/av.py::_NATIVE_DIR": ("utils/native.py::BUILD_DIR", "the port's sources are in csrc/"),
    "record/lz4block.py::_LIB_PATH": (
        "utils/native.py::build_library", "built at first use into _build/, keyed by the source hash"),
    "record/lz4block.py::_NATIVE_DIR": ("utils/native.py::BUILD_DIR", "the port's sources are in csrc/"),
    "train/checkpoint.py::_checkpointer": (
        None, "orbax's checkpointer; the port's checkpoints are torch.save files"),
}


def _defined(path: Path) -> set:
    """Top-level functions, classes and UPPER_CASE constants of a module,
    and each class's methods as ``Class.method``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names |= {f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name) and e.id.isupper():
                        names.add(e.id)
    return names


def _torch_forward(path: Path) -> set:
    """``Class.__call__`` for each class of a port module that defines
    ``forward`` or is an ``nn.Sequential`` (torch runs its layers in order):
    a Flax module's ``__call__`` is a torch module's forward."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef) and (
                any(isinstance(m, ast.FunctionDef) and m.name == "forward" for m in node.body)
                or any(ast.unparse(b) == "nn.Sequential" for b in node.bases)):
            names.add(f"{node.name}.__call__")
    return names


def _public(names: set) -> set:
    """The names a user of the module can rely on: no leading underscore
    in any part, except a Flax module's ``__call__``."""
    return {n for n in names
            if all(not p.startswith("_") or p == "__call__" for p in n.split("."))}


def _port_module(jax_rel: str) -> str:
    return MODULES.get(jax_rel, jax_rel)


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = PORT_PKG / _port_module(module)
    assert port.is_file(), f"no port module for {module}"
    theirs = _public(_defined(JAX_PKG / module))
    mine = _defined(port) | _torch_forward(port)
    missing = [n for n in sorted(theirs - mine) if f"{module}::{n}" not in DEPARTURES]
    assert not missing, f"{module}: no counterpart and no departure for {missing}"


@pytest.mark.parametrize("entry", sorted(DEPARTURES))
def test_departure_names_a_jax_name_and_its_counterpart(entry):
    """Each row names something the JAX module defines, that the port
    does not define under the same name, and a port counterpart that
    exists."""
    module, name = entry.split("::")
    assert name in _defined(JAX_PKG / module)
    assert name not in _defined(PORT_PKG / _port_module(module))
    counterpart, reason = DEPARTURES[entry]
    assert reason
    if counterpart is not None:
        port_module, port_name = counterpart.split("::")
        assert port_name in _defined(PORT_PKG / port_module), counterpart


def _all_of(init: Path):
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


PACKAGES = sorted(str(p.parent.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("__init__.py")
                  if p.parent != JAX_PKG)


@pytest.mark.parametrize("package", PACKAGES)
def test_package_all_matches(package):
    want = _all_of(JAX_PKG / package / "__init__.py")
    assert _all_of(PORT_PKG / package / "__init__.py") == want
    if want:
        mod = importlib.import_module(f"video_desensitization_torch.{package.replace('/', '.')}")
        assert all(hasattr(mod, name) for name in want)


def _scripts():
    return tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]


@pytest.mark.parametrize("script", sorted(s for s in _scripts() if not s.startswith("vdt-torch")))
def test_console_script_has_a_port_counterpart(script):
    scripts = _scripts()
    mine = "vdt-torch" + script[len("vdt"):]
    assert mine in scripts, f"{script} has no {mine}"
    module, func = scripts[mine].split(":")
    assert module.startswith("video_desensitization_torch.")
    assert callable(getattr(importlib.import_module(module), func))
    jax_module = scripts[script].split(":")[0]
    assert module.split(".", 1)[1] == jax_module.split(".", 1)[1]

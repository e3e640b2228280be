"""Weights between the JAX package's Flax variables and this port.

The port's modules carry the reference torch checkpoints' names, so a
reference ``.pth``/``.pt`` state_dict loads with ``load_state_dict`` as it
is (``load_torch_checkpoint``). ``from_jax_variables`` turns the JAX
package's ``{"params", "batch_stats"}`` tree (numpy arrays) into such a
state_dict, for RetinaFace (resnet50 or mobilenet) and YOLOv8 alike:
conv kernels go from (kh, kw, I, O) to (O, I, kh, kw), BN scale/bias/mean/var
become weight/bias/running_mean/running_var. ``to_jax_variables`` is the
way back.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_CONV_LEAVES = {"kernel": "weight", "bias": "bias"}
_YOLO_DETECT_RE = re.compile(r"(cv[23])_(\d+)_(\d+)")


def _retinaface_module(path: Tuple[str, ...]) -> str:
    """Flax module path of RetinaFace -> torch module name."""
    top = path[0]
    if top == "body":
        name = path[1]
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m:
            sub = path[2]
            if sub == "downsample_conv":
                sub = "downsample.0"
            elif sub == "downsample_bn":
                sub = "downsample.1"
            return f"body.layer{m.group(1)}.{m.group(2)}.{sub}"
        if name == "stage1_conv":
            return f"body.stage1.0.{'1' if path[2] == 'bn' else '0'}"
        m = re.fullmatch(r"stage(\d)_(\d+)", name)
        if m:
            stage, block = int(m.group(1)), int(m.group(2))
            block += 1 if stage == 1 else 0  # stage1.0 is the stem
            idx = {("dw", "conv"): 0, ("dw", "bn"): 1, ("pw", "conv"): 3, ("pw", "bn"): 4}
            return f"body.stage{stage}.{block}.{idx[(path[2], path[3])]}"
        return f"body.{name}"  # conv1 / bn1
    m = re.fullmatch(r"(ClassHead|BboxHead|LandmarkHead)_(\d+)", top)
    if m:
        return f"{m.group(1)}.{m.group(2)}.{path[1]}"
    # fpn.* / ssh*.*: ConvBN Sequential (0 conv, 1 bn)
    return f"{top}.{path[1]}.{'1' if path[2] == 'bn' else '0'}"


def _yolo_module(path: Tuple[str, ...]) -> str:
    """Flax module path of YoloV8 -> torch module name."""
    parts = ["model", path[0][1:]]
    for p in path[1:]:
        m = _YOLO_DETECT_RE.fullmatch(p)
        if m:
            parts += [m.group(1), m.group(2), m.group(3)]
        elif p.startswith("m_"):
            parts += ["m", p[2:]]
        else:
            parts.append(p)
    return ".".join(parts)


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` of RetinaFace or YoloV8 -> a
    state_dict for the port's ``RetinaFace`` / ``YoloV8``."""
    params = variables["params"]
    yolo = "m0" in params
    module_name = _yolo_module if yolo else _retinaface_module
    bn_modules = {path[:-1] for path, _ in _leaves(variables.get("batch_stats", {}))}
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            module, leaf = path[:-1], path[-1]
            arr = np.array(value, dtype=np.float32)
            if module in bn_modules:
                key = _BN_LEAVES[leaf]
            else:
                key = _CONV_LEAVES[leaf]
                if leaf == "kernel":
                    arr = arr.transpose(3, 2, 0, 1)
            state[f"{module_name(module)}.{key}"] = torch.from_numpy(
                np.ascontiguousarray(arr)
            )
    for module in bn_modules:
        state[f"{module_name(module)}.num_batches_tracked"] = torch.tensor(0)
    if yolo:
        state["model.22.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(
            1, 16, 1, 1
        )
    return state


def _retinaface_path(name: str) -> Tuple[str, ...]:
    """Torch module name of RetinaFace -> Flax module path (inverse of
    ``_retinaface_module``)."""
    p = name.split(".")
    if p[0] == "body":
        if p[1].startswith("layer"):
            sub = p[3] if p[3] != "downsample" else ("downsample_conv", "downsample_bn")[int(p[4])]
            return ("body", f"{p[1]}_{p[2]}", sub)
        if p[1].startswith("stage"):
            stage, block, idx = int(p[1][5:]), int(p[2]), int(p[3])
            if stage == 1 and block == 0:
                return ("body", "stage1_conv", ("conv", "bn")[idx])
            block -= 1 if stage == 1 else 0
            half, sub = {0: ("dw", "conv"), 1: ("dw", "bn"), 3: ("pw", "conv"), 4: ("pw", "bn")}[idx]
            return ("body", f"{p[1]}_{block}", half, sub)
        return ("body", p[1])
    if p[0].endswith("Head"):
        return (f"{p[0]}_{p[1]}", p[2])
    return (p[0], p[1], ("conv", "bn")[int(p[2])])


def _yolo_path(name: str) -> Tuple[str, ...]:
    """Torch module name of YoloV8 -> Flax module path (inverse of
    ``_yolo_module``)."""
    p = name.split(".")[1:]
    path, i = [f"m{p[0]}"], 1
    while i < len(p):
        if p[i] in ("cv2", "cv3") and p[0] == "22":
            path.append(f"{p[i]}_{p[i + 1]}_{p[i + 2]}")
            i += 3
        elif p[i] == "m":
            path.append(f"m_{p[i + 1]}")
            i += 2
        else:
            path.append(p[i])
            i += 1
    return tuple(path)


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """A port (or reference) state_dict of RetinaFace or YoloV8 -> the JAX
    package's ``{"params", "batch_stats"}`` tree of numpy arrays."""
    yolo = any(k.startswith("model.") for k in state_dict)
    module_path = _yolo_path if yolo else _retinaface_path
    bn_modules = {k.rsplit(".", 1)[0] for k in state_dict if k.endswith(".running_mean")}
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    bn_leaf = {v: k for k, v in _BN_LEAVES.items()}
    for key, value in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked" or ".dfl." in key:
            continue
        arr = value.detach().cpu().to(torch.float32).numpy()
        if module in bn_modules:
            name = bn_leaf[leaf]
            collection = "batch_stats" if name in ("mean", "var") else "params"
        else:
            name, collection = ("kernel", "params") if leaf == "weight" else ("bias", "params")
            if leaf == "weight":
                arr = arr.transpose(2, 3, 1, 0)
        node = out[collection]
        for part in module_path(module):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth``/``.pt`` state_dict (on the CPU), dropping
    a ``module.`` prefix from DataParallel checkpoints."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in obj.items()}

"""Weights between reference checkpoints, the JAX package's Flax variables
and this port.

The port's modules carry the reference torch checkpoints' names, so a
reference ``.pth``/``.pt`` state_dict loads as it is once
``reference_state_dict`` has applied the JAX converters' key rules (a
``module.`` prefix dropped, ``body.fc.*`` and ``num_batches_tracked``
skipped, any other key outside the network's layout refused).
``from_jax_variables`` turns the JAX package's ``{"params", "batch_stats"}``
tree (numpy arrays) into such a state_dict, for RetinaFace (resnet50 or
mobilenet) and YOLOv8 alike: conv kernels go from (kh, kw, I, O) to
(O, I, kh, kw), BN scale/bias/mean/var become
weight/bias/running_mean/running_var. ``to_jax_variables`` is the way back,
and ``convert_retinaface_state_dict`` / ``convert_yolo_state_dict`` give the
JAX converters' trees from a reference checkpoint.

``save_variables`` / ``load_variables`` write and read that tree as the
JAX package's ``.msgpack`` files (``flax.serialization.msgpack_serialize``)
with a codec of their own, no Flax and no ``msgpack`` package: it reads
the subset Flax writes (maps, arrays, strings, ints, floats, ``bin``, ext
type 1, an ndarray as a packed ``(shape, dtype name, bytes)``, and ext
type 3, a numpy scalar packed the same way) and writes maps of arrays.

The offline converter (``main``) reads a reference checkpoint and writes
that msgpack file:

    python -m video_desensitization_torch.models.convert \
        Retinaface_resnet50.pth face.msgpack [--arch retinaface|yolo]
"""

from __future__ import annotations

import re
import struct
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

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
            if torch.is_tensor(value):  # bfloat16 leaves of load_variables
                t = value.to(torch.float32)
            else:
                t = torch.from_numpy(np.array(value, dtype=np.float32))
            if module in bn_modules:
                key = _BN_LEAVES[leaf]
            else:
                key = _CONV_LEAVES[leaf]
                if leaf == "kernel":
                    t = t.permute(3, 2, 0, 1)
            state[f"{module_name(module)}.{key}"] = t.contiguous()
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


# Every module a reference checkpoint of each network holds, under its
# torch name, and the leaves of a conv or BN module.
_RETINAFACE_MODULE = re.compile(
    r"body\.(conv1|bn1|layer[1-4]\.\d+\.(conv[1-3]|bn[1-3]|downsample\.[01])"
    r"|stage[1-3]\.\d+\.[0134])"
    r"|fpn\.(output[1-3]|merge[12])\.[01]"
    r"|ssh[1-3]\.(conv3X3|conv5X5_[12]|conv7X7_2|conv7x7_3)\.[01]"
    r"|(Class|Bbox|Landmark)Head\.\d+\.conv1x1"
)
_YOLO_MODULE = re.compile(
    r"model\.((0|1|3|5|7|16|19)\.(conv|bn)"
    r"|(2|4|6|8|9|12|15|18|21)\.(m\.\d+\.)?cv[12]\.(conv|bn)"
    r"|22\.cv[23]\.\d+\.([01]\.(conv|bn)|2)"
    r"|22\.dfl\.conv)"
)
_LEAVES = ("weight", "bias", "running_mean", "running_var")
# A torchvision ResNet-50's classifier, which RetinaFace never runs.
_RETINAFACE_DROPPED = ("body.fc.weight", "body.fc.bias")


def _unprefixed(key: str) -> str:
    """A DataParallel checkpoint's key without its ``module.`` prefix."""
    return key[len("module."):] if key.startswith("module.") else key


def reference_state_dict(state_dict: Mapping[str, Any], yolo: bool) -> Dict[str, torch.Tensor]:
    """A reference state_dict of RetinaFace (``yolo`` false) or YOLOv8 under
    the JAX converters' key rules, as tensors (numpy values are taken too).

    A ``module.`` prefix is dropped; ``body.fc.weight`` and ``body.fc.bias``
    (RetinaFace) and every ``num_batches_tracked`` are skipped; any other key
    outside the network's layout raises ``ValueError("Unmapped checkpoint
    keys: [...]")`` (YOLO: ``"Unmapped YOLO keys: [...]"``) with the first
    ten, as the JAX converters do. The loader and the converter both take
    their keys from here."""
    module_re = _YOLO_MODULE if yolo else _RETINAFACE_MODULE
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for key, value in state_dict.items():
        k = _unprefixed(key)
        if k.endswith(".num_batches_tracked") or (not yolo and k in _RETINAFACE_DROPPED):
            continue
        module, _, leaf = k.rpartition(".")
        if leaf not in _LEAVES or not module_re.fullmatch(module):
            unmapped.append(k)
            continue
        out[k] = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    if unmapped:
        raise unmapped_keys_error(unmapped, yolo)
    return out


def unmapped_keys_error(keys, yolo: bool) -> ValueError:
    """The JAX converters' error for keys they cannot map (the first ten)."""
    return ValueError(f"Unmapped {'YOLO' if yolo else 'checkpoint'} keys: {list(keys)[:10]}")


def to_jax_variables(state_dict: Mapping[str, Any], yolo: Optional[bool] = None) -> Dict[str, Dict]:
    """A port (or reference) state_dict of RetinaFace or YoloV8 -> the JAX
    package's ``{"params", "batch_stats"}`` tree of float32 numpy arrays.
    The keys are taken under ``reference_state_dict``'s rules; ``yolo``
    defaults to whether a key starts with ``model.``."""
    if yolo is None:
        yolo = any(_unprefixed(k).startswith("model.") for k in state_dict)
    state = reference_state_dict(state_dict, yolo)
    module_path = _yolo_path if yolo else _retinaface_path
    bn_modules = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    bn_leaf = {v: k for k, v in _BN_LEAVES.items()}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        if ".dfl." in key:
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


def convert_retinaface_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """A reference RetinaFace state_dict (resnet50 or mobilenet layout) ->
    the JAX package's variables, as its converter of the same name gives
    them."""
    return to_jax_variables(state_dict, yolo=False)


def convert_yolo_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """An ultralytics YOLOv8 state_dict -> the JAX package's variables (the
    DFL projection is fixed and left out, as there)."""
    return to_jax_variables(state_dict, yolo=True)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth``/``.pt`` state_dict (on the CPU); a
    checkpoint that wraps it under ``state_dict`` is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


# -- msgpack, as flax.serialization writes it ----------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _pack(obj, out: List[bytes]) -> None:
    """Append the msgpack bytes of a tree of maps, strings and ndarrays (and,
    inside an array's ext payload, its shape, dtype name and bytes)."""
    if isinstance(obj, Mapping):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n < 16 else struct.pack(">BI", 0xDF, n))
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, list):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n < 16 else struct.pack(">BI", 0xDD, n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(bytes([0xA0 | len(b)]) if len(b) < 32 else struct.pack(">BI", 0xDB, len(b)))
        out.append(b)
    elif isinstance(obj, bytes):
        out.append(struct.pack(">BI", 0xC6, len(obj)))
        out.append(obj)
    elif isinstance(obj, int) and obj >= 0:
        out.append(struct.pack(">BQ", 0xCF, obj))
    elif isinstance(obj, np.ndarray):
        payload: List[bytes] = []
        _pack([list(obj.shape), obj.dtype.name, obj.tobytes("C")], payload)
        data = b"".join(payload)
        out.append(struct.pack(">BIb", 0xC9, len(data), _EXT_NDARRAY))
        out.append(data)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as msgpack variables")


def _array_from_ext(data: bytes):
    shape, dtype, buf = _Unpacker(data).read()
    if dtype == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(tuple(shape))


class _Unpacker:
    """Reads one msgpack object from ``data``."""

    _FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
              0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.read_map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        if t in self._FIXED:
            return self.unpack(self._FIXED[t])
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if t in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(">" + "BHI"[t - 0xC4]))
        if t in (0xD9, 0xDA, 0xDB):
            return self.take(self.unpack(">" + "BHI"[t - 0xD9])).decode()
        if t in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">" + "HI"[t - 0xDC]))]
        if t in (0xDE, 0xDF):
            return self.read_map(self.unpack(">" + "HI"[t - 0xDE]))
        if 0xD4 <= t <= 0xD8 or t in (0xC7, 0xC8, 0xC9):
            n = 1 << (t - 0xD4) if t >= 0xD4 else self.unpack(">" + "BHI"[t - 0xC7])
            code = self.unpack(">b")
            data = self.take(n)
            if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
                raise ValueError(f"msgpack ext type {code} is not a Flax array")
            arr = _array_from_ext(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")

    def read_map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _CHUNKED in out:
            raise ValueError("chunked msgpack arrays (leaves of 2**30 bytes or more) are not supported")
        return out


def save_variables(variables: Mapping, path: str) -> None:
    """Write a ``{"params", "batch_stats"}`` tree of numpy arrays as the JAX
    package's msgpack variables file."""
    out: List[bytes] = []
    _pack(variables, out)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def load_variables(path: str) -> Dict:
    """Read a msgpack variables file written by the JAX package (or by
    ``save_variables``): the tree with numpy leaves (torch for bfloat16)."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Unpacker(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def main(argv: Optional[List[str]] = None) -> int:
    """The offline converter: a reference ``.pth``/``.pt`` checkpoint ->
    the JAX package's msgpack variables file, which ``Retinaface`` /
    ``PlateDetector`` (``model_path``) of either package load. It works on
    the CPU and touches no device."""
    import argparse

    p = argparse.ArgumentParser(description="torch checkpoint -> Flax msgpack")
    p.add_argument("src", help=".pth/.pt torch checkpoint")
    p.add_argument("dst", help="output .msgpack path")
    p.add_argument("--arch", choices=("retinaface", "yolo"), default="retinaface")
    args = p.parse_args(argv)

    state = load_torch_checkpoint(args.src)
    if args.arch == "retinaface":
        variables = convert_retinaface_state_dict(state)
    else:
        variables = convert_yolo_state_dict(state)
    save_variables(variables, args.dst)
    n = sum(v.size for _, v in _leaves(variables))
    print(f"wrote {args.dst}: {n:,} parameters")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))

"""The port's checkpoint converter and loader against the JAX package's.

Reference-layout checkpoints come from ``tests/torch_oracle.py`` (R50,
MobileNet-0.25 and YOLOv8n, seeded weights, BN statistics randomised),
saved with ``torch.save`` as a reference ``.pth``/``.pt``. Both packages'
offline converters run on the same file, each package's detectors load the
other's msgpack file, and the key rules (``body.fc.*`` dropped, a
``module.`` prefix dropped, any other unknown key refused) hold in both.
Detections are compared in float32 at rtol/atol 1e-4, as
``tests/test_torch_models.py`` compares the networks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.models import convert as jax_convert

from torch_oracle import TRetinaFaceOracle, TYoloV8Oracle, _randomize_bn_stats

from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models import convert

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["resnet50", "mobilenet", "yolo"]
SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are tiny and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _oracle_state(arch):
    """A seeded reference-layout state_dict of ``arch``."""
    torch.manual_seed(ARCHS.index(arch))
    oracle = TYoloV8Oracle() if arch == "yolo" else TRetinaFaceOracle(backbone=arch)
    with torch.no_grad():
        _randomize_bn_stats(oracle, torch.Generator().manual_seed(7))
    return oracle.eval().state_dict()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """arch -> (state_dict, path of its torch.save file)."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for arch in ARCHS:
        state = _oracle_state(arch)
        path = root / (f"{arch}.pt" if arch == "yolo" else f"{arch}.pth")
        torch.save(state, path)
        out[arch] = (state, str(path))
    return out


def _arch_flag(arch):
    return ["--arch", "yolo" if arch == "yolo" else "retinaface"]


@pytest.fixture(scope="module")
def msgpacks(checkpoints, tmp_path_factory):
    """arch -> (JAX converter's file, port converter's file, the two printed
    lines)."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("msgpack")
    out = {}
    for arch, (_, src) in checkpoints.items():
        files, lines = [], []
        for name, fn in (("jax", jax_convert.main), ("port", convert.main)):
            dst = str(root / f"{arch}_{name}.msgpack")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert fn([src, dst, *_arch_flag(arch)]) == 0
            files.append(dst)
            lines.append(buf.getvalue().strip().replace(dst, "<dst>"))
        out[arch] = (*files, lines)
    return out


def _jax_detector(arch, **kwargs):
    if arch == "yolo":
        return JaxPlateDetector(input_shape=(SIZE, SIZE), dtype=jnp.float32, **kwargs)
    return JaxRetinaface(backbone=arch, input_shape=[SIZE, SIZE, 3], max_detections=32,
                         dtype=jnp.float32, **kwargs)


def _port_detector(arch, **kwargs):
    if arch == "yolo":
        return PlateDetector(input_shape=(SIZE, SIZE), dtype=torch.float32, device="cpu", **kwargs)
    return Retinaface(backbone=arch, input_shape=[SIZE, SIZE, 3], max_detections=32,
                      dtype=torch.float32, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)


def _detections(det, frames):
    """(normalised dets or plate pixel dets, keep) as numpy: the first and
    last outputs of ``detect_padded`` in both packages."""
    out = det.detect_padded(frames)
    return np.asarray(out[0]), np.asarray(out[-1])


def _assert_same_detections(a, b):
    (da, ka), (db, kb) = a, b
    np.testing.assert_array_equal(ka, kb)
    assert ka.any()
    np.testing.assert_allclose(da, db, **TOL)


def _assert_same_tree(a, b):
    """Same keys at every level and bitwise-equal float32 leaves."""
    la, lb = dict(convert._leaves(a)), dict(convert._leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype == np.float32, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_write_the_same_tree(arch, msgpacks):
    """``vdt-convert`` and the port's ``main`` on the same checkpoint: each
    file read by each package's reader gives one tree, key for key and bit
    for bit, and both print the same line."""
    from flax import serialization

    jax_file, port_file, lines = msgpacks[arch]
    assert lines[0] == lines[1]
    assert lines[0].startswith("wrote <dst>: ") and lines[0].endswith(" parameters")
    with open(jax_file, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    with open(port_file, "rb") as f:
        _assert_same_tree(serialization.msgpack_restore(f.read()), want)
    _assert_same_tree(convert.load_variables(jax_file), want)
    _assert_same_tree(convert.load_variables(port_file), want)
    n = sum(np.asarray(v).size for v in jax.tree.leaves(want))
    assert lines[0] == f"wrote <dst>: {n:,} parameters"


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_functions_match_jax(arch, checkpoints):
    state, _ = checkpoints[arch]
    if arch == "yolo":
        mine, want = convert.convert_yolo_state_dict(state), jax_convert.convert_yolo_state_dict(state)
    else:
        mine = convert.convert_retinaface_state_dict(state)
        want = jax_convert.convert_retinaface_state_dict(state)
    _assert_same_tree(mine, want)
    # numpy values, as the JAX package's load_torch_checkpoint hands them over
    numpy_state = {k: v.numpy() for k, v in state.items()}
    _assert_same_tree(convert.to_jax_variables(numpy_state), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_package_loads_the_others_file(arch, msgpacks, frames):
    jax_file, port_file, _ = msgpacks[arch]
    _assert_same_detections(
        _detections(_port_detector(arch, model_path=jax_file), frames),
        _detections(_jax_detector(arch, model_path=port_file), frames),
    )


@pytest.mark.parametrize("backbone", ["resnet50", "mobilenet"])
def test_body_fc_checkpoint_loads_in_both(backbone, checkpoints, tmp_path, frames):
    """A torchvision-derived checkpoint carries the ResNet classifier
    ``body.fc.*``: the JAX converter drops it, and so does the port."""
    state, _ = checkpoints[backbone]
    width = 2048 if backbone == "resnet50" else 256
    gen = torch.Generator().manual_seed(1)
    with_fc = {**state, "body.fc.weight": torch.randn(1000, width, generator=gen),
               "body.fc.bias": torch.randn(1000, generator=gen)}
    path = str(tmp_path / "fc.pth")
    torch.save(with_fc, path)
    _assert_same_detections(
        _detections(_port_detector(backbone, model_path=path), frames),
        _detections(_jax_detector(backbone, model_path=path), frames),
    )
    _assert_same_tree(convert.convert_retinaface_state_dict(with_fc),
                      jax_convert.convert_retinaface_state_dict(with_fc))


@pytest.mark.parametrize("arch,key", [
    ("resnet50", "head.weight"),
    ("mobilenet", "body.classifier.weight"),
    ("yolo", "model.23.conv.weight"),
    ("yolo", "extra.weight"),
])
def test_unknown_key_raises_as_in_jax(arch, key, checkpoints, tmp_path):
    state, _ = checkpoints[arch]
    bad = {**state, key: torch.zeros(4)}
    jax_fn = jax_convert.convert_yolo_state_dict if arch == "yolo" else \
        jax_convert.convert_retinaface_state_dict
    port_fn = convert.convert_yolo_state_dict if arch == "yolo" else \
        convert.convert_retinaface_state_dict
    with pytest.raises(ValueError) as want:
        jax_fn(bad)
    prefix = "Unmapped YOLO keys: " if arch == "yolo" else "Unmapped checkpoint keys: "
    assert str(want.value) == f"{prefix}['{key}']"
    with pytest.raises(ValueError) as got:
        port_fn(bad)
    assert str(got.value) == str(want.value)
    path = str(tmp_path / "bad.pth")
    torch.save(bad, path)
    with pytest.raises(ValueError) as loaded:
        _port_detector(arch, model_path=path)
    assert str(loaded.value) == str(want.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_module_prefixed_checkpoint_loads_in_both(arch, checkpoints, tmp_path, frames):
    """An ``nn.DataParallel`` checkpoint (every key under ``module.``)."""
    state, _ = checkpoints[arch]
    path = str(tmp_path / "dp.pth")
    torch.save({f"module.{k}": v for k, v in state.items()}, path)
    port = _port_detector(arch, model_path=path)
    plain = _port_detector(arch, state_dict=state)
    for k, v in plain.net.state_dict().items():
        torch.testing.assert_close(port.net.state_dict()[k], v, rtol=0, atol=0, msg=k)
    _assert_same_detections(_detections(port, frames),
                            _detections(_jax_detector(arch, model_path=path), frames))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_path_equals_the_state_dict(arch, checkpoints, frames):
    """``model_path="x.pth"`` through ``load_weights`` gives the detections
    of the same state_dict handed in, bit for bit."""
    state, path = checkpoints[arch]
    a = _detections(_port_detector(arch, model_path=path), frames)
    b = _detections(_port_detector(arch, state_dict=state), frames)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_missing_key_still_raises(checkpoints):
    state, _ = checkpoints["mobilenet"]
    short = {k: v for k, v in state.items() if k != "fpn.output1.0.weight"}
    with pytest.raises(ValueError, match=r"Missing checkpoint keys: \['fpn.output1.0.weight'\]"):
        _port_detector("mobilenet", state_dict=short)

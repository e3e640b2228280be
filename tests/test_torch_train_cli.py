"""The port's training CLI (``cli/train.py``) over a synthetic labelled
set, on the CPU, beside the JAX package's, and the weights files between
the two packages: the JAX trainer's msgpack export in the port's
detectors, the port's export in the JAX package's, and the detectors'
evaluation hooks (``get_map_txt``, ``get_FPS``, ``benchmarks/map_eval.py``).

MobileNet-0.25 at 64x64, batch 4, ``max_gt`` 8, float32.
"""

import importlib.util
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.models.convert import load_variables as jax_load_variables
from video_desensitization_tpu.models.convert import save_variables as jax_save_variables

from video_desensitization_torch.cli.train import main, parse_args, train
from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables, to_jax_variables

HW = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACE = dict(backbone="mobilenet", input_shape=[HW, HW, 3], confidence=0.01, max_detections=8)
PLATE = dict(variant="n", input_shape=(HW, HW), confidence=0.01, max_detections=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's trainer at these sizes runs no slower on one thread, and
    on a loaded CPU (the suite's workers) each of torch's parallel regions
    waits on threads that have no core: a resumed CLI run took 9x longer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _square(i):
    img = np.zeros((80, 96, 3), np.uint8)
    x0, y0 = 10 + 5 * i, 18
    img[y0:y0 + 26, x0:x0 + 26] = 255
    return img, (x0, y0)


@pytest.fixture()
def synthetic_set(tmp_path):
    """Eight white squares on black, box = the square (as the JAX
    package's trainer test builds it)."""
    import cv2

    lines = []
    for i in range(8):
        img, (x0, y0) = _square(i)
        cv2.imwrite(str(tmp_path / f"im{i}.jpg"), img)
        lines.append(f"# im{i}.jpg\n{x0} {y0} 26 26\n")
    (tmp_path / "label.txt").write_text("".join(lines))
    return tmp_path


def _argv(root, device="cpu", **over):
    base = {
        "--labels": str(root / "label.txt"),
        "--images": str(root),
        "--backbone": "mobilenet",
        "--input-size": str(HW),
        "--epochs": "2",
        "--batch-size": "4",
        "--max-gt": "8",
        "--lr": "1e-3",
        "--milestones": "100",
        "--warmup-epochs": "0.5",
        "--log-every": "1",
        "--device": device,
    }
    base.update(over)
    argv = []
    for k, v in base.items():
        if v is not None:
            argv += [k, v]
    return argv


def _face_dets(face, img):
    """(rows, keep) of one frame, numpy, from either package's detector."""
    _, dets_px, keep = face.detect_padded(img[None])
    return np.asarray(dets_px.cpu() if torch.is_tensor(dets_px) else dets_px), \
        np.asarray(keep.cpu() if torch.is_tensor(keep) else keep)


def _assert_same_detections(mine, theirs):
    np.testing.assert_array_equal(mine[1], theirs[1])
    np.testing.assert_allclose(mine[0], theirs[0], rtol=0, atol=1e-3)


def test_train_cli_end_to_end(synthetic_set, tmp_path):
    """Two epochs of two steps, a checkpoint each, the export: it loads in
    the port's Retinaface and in the JAX package's, which find the same
    boxes, and its weights are the final state's bit for bit."""
    ckpt_dir = tmp_path / "ckpts"
    export = tmp_path / "face.msgpack"
    state = train(parse_args(_argv(synthetic_set, **{
        "--ckpt-dir": str(ckpt_dir), "--save-every": "1", "--export": str(export)})))
    assert state.step == 4  # 8 images / batch 4 = 2 steps/epoch * 2 epochs
    assert sorted(os.listdir(ckpt_dir)) == ["ep0001", "ep0002"]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())

    face = Retinaface(model_path=str(export), dtype=torch.float32, device="cpu", **FACE)
    jface = JaxRetinaface(model_path=str(export), dtype=jnp.float32, **FACE)
    img, _ = _square(3)
    _assert_same_detections(_face_dets(face, img), _face_dets(jface, img))
    want = state.model.state_dict()
    for k, v in face.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k


def test_train_cli_resume_continues_step_count(synthetic_set, tmp_path):
    ckpt_dir = tmp_path / "ck"
    first = train(parse_args(_argv(synthetic_set, **{"--epochs": "1", "--ckpt-dir": str(ckpt_dir)})))
    momentum = {k: v["momentum_buffer"].clone() for k, v in first.optimizer.state.items()}
    saved = torch.load(ckpt_dir / "ep0001", weights_only=True)
    assert saved["step"] == 2 and len(saved["optimizer"]["state"]) == len(momentum)
    state = train(parse_args(_argv(synthetic_set, **{
        "--epochs": "2", "--ckpt-dir": str(ckpt_dir), "--resume": str(ckpt_dir / "ep0001")})))
    assert state.step == 4  # resumed at 2, ran epoch 2 only
    assert sorted(os.listdir(ckpt_dir)) == ["ep0001", "ep0002"]


@pytest.mark.parametrize(
    "flags",
    [[], ["--milestones", "1.5,2.5", "--warmup-epochs", "0.5", "--lr", "0.01",
          "--momentum", "0.5", "--weight-decay", "0.5", "--gamma", "0.5"],
     ["--milestones", "", "--warmup-epochs", "0", "--weight-decay", "0"]],
    ids=["defaults", "fractional-epochs", "no-decay"],
)
def test_build_optimizer_matches_jax(flags):
    """Both CLIs' ``build_optimizer`` on the same flags, 3 steps an epoch:
    the schedule equal at every step of 100 epochs (warmup and milestones
    turned into steps alike); the port's SGD is plain heavy-ball momentum
    (no dampening, no Nesterov) with the flags' momentum and weight decay;
    and 12 updates of float64 parameters by random gradients, each at the
    schedule's lr as the train step sets it: how far each tensor has moved
    within 1e-6 of optax's, relative (optax's lr is a float32 scalar)."""
    from video_desensitization_tpu.cli import train as jax_cli

    from video_desensitization_torch.cli.train import build_optimizer

    argv = ["--labels", "label.txt", "--images", "."] + flags
    args, jax_args = parse_args(argv), jax_cli.parse_args(argv)
    assert {k: v for k, v in vars(args).items() if k != "device"} == vars(jax_args)
    steps_per_epoch = 3
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.normal(0, 1, s) for s in shapes]
    net = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    optimizer, schedule = build_optimizer(args, steps_per_epoch, net)
    tx, jax_schedule = jax_cli.build_optimizer(jax_args, steps_per_epoch)
    lrs = np.array([schedule(s) for s in range(100 * steps_per_epoch)])
    np.testing.assert_allclose(lrs, [float(jax_schedule(s)) for s in range(len(lrs))],
                               rtol=1e-6, atol=0)
    (group,) = optimizer.param_groups
    assert (group["momentum"], group["weight_decay"]) == (args.momentum, args.weight_decay)
    assert group["dampening"] == 0 and not group["nesterov"] and not group["maximize"]
    with jax.enable_x64():
        jparams = [jnp.asarray(p) for p in params]
        opt_state = tx.init(jparams)
        for step in range(12):
            grads = [rng.normal(0, 1, s) for s in shapes]
            for p, g in zip(net, grads):
                p.grad = torch.from_numpy(g)
            group["lr"] = schedule(step)
            optimizer.step()
            updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jparams)
            jparams = [p + u for p, u in zip(jparams, updates)]
            for mine, theirs, start in zip(net, jparams, params):
                moved, want = mine.detach().numpy() - start, np.asarray(theirs) - start
                assert np.linalg.norm(moved - want) <= 1e-6 * np.linalg.norm(want), step


def test_train_cli_rejects_empty_labels(tmp_path):
    (tmp_path / "label.txt").write_text("")
    with pytest.raises(ValueError, match="no annotations"):
        train(parse_args(_argv(tmp_path)))


@pytest.mark.parametrize(
    "mesh, n_devices, batch, error",
    [(("2", "1"), 2, "4", None),
     (("1", "2"), 1, "4", "mesh 1x2 != 1 devices"),
     (("0", "4"), 8, "3", "batch 3 not divisible by data axis 2")],
    ids=["data2", "model2", "model4"])
def test_train_cli_refuses_a_mesh(synthetic_set, tmp_path, monkeypatch, mesh, n_devices, batch,
                                  error):
    """``--mesh-data`` / ``--mesh-model`` take the JAX CLI's rules, with the
    device list patched to ``n_devices`` CPU devices. data2: two processes
    (this one and a spawned rank) train one epoch of two steps, rank 0
    writes the checkpoint and the export, and the weights equal one
    device's run to float32 rounding. model2 on one device and model4 (data
    2 over 8 devices) with a batch of 3: the JAX CLI's ValueError, the
    latter word for word as the JAX CLI gives it on its 8 devices."""
    from video_desensitization_tpu.cli import train as jax_train_cli

    from video_desensitization_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(mesh_lib, "local_devices", lambda kind="cuda": [torch.device(kind)] * n_devices)
    over = {"--mesh-data": mesh[0], "--mesh-model": mesh[1], "--batch-size": batch, "--epochs": "1"}
    if error:
        with pytest.raises(ValueError, match=error):
            train(parse_args(_argv(synthetic_set, **over)))
        if n_devices == 8:
            with pytest.raises(ValueError) as theirs:
                jax_train_cli.train(jax_train_cli.parse_args(_argv(synthetic_set, device=None, **over)))
            assert str(theirs.value) == error
        return
    export = tmp_path / "face.msgpack"
    state = train(parse_args(_argv(synthetic_set, **over, **{
        "--ckpt-dir": str(tmp_path / "ck"), "--export": str(export)})))
    assert state.step == 2 and state.mesh.shape == {"data": 2, "model": 1}
    assert os.listdir(tmp_path / "ck") == ["ep0001"] and export.stat().st_size > 0
    one = train(parse_args(_argv(synthetic_set, **{**over, "--mesh-data": "1"})))
    mine, theirs = to_jax_variables(state.model.state_dict()), to_jax_variables(one.model.state_dict())
    for kind in ("params", "batch_stats"):
        for path, a in jax.tree_util.tree_flatten_with_path(mine[kind])[0]:
            b = theirs[kind]
            for key in path:
                b = b[key.key]
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=str(path))


def test_train_cli_main_on_one_device(synthetic_set):
    """main() at --mesh-data 0 (all devices: one here) runs one epoch."""
    assert main(_argv(synthetic_set, **{"--epochs": "1", "--mesh-data": "0"})) == 0


def test_train_cli_needs_cuda_or_device_cpu(synthetic_set, monkeypatch):
    """No fallback: without a CUDA device and without --device cpu it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(parse_args(_argv(synthetic_set, device=None)))


def test_train_cli_validation_split(synthetic_set):
    """--val-frac 0.5: the JAX package's numpy split, one train step, the
    validation loss logged; --val-frac 1.0 leaves no train data."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("VideoProcessor.train")
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    try:
        state = train(parse_args(_argv(synthetic_set, **{"--epochs": "1", "--val-frac": "0.5"})))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    assert state.step == 1  # 8 images, half held out
    assert any("validation: loss" in m for m in records), records
    assert any("4 annotated images" in m for m in records), records
    with pytest.raises(ValueError, match="leaves no train data"):
        train(parse_args(_argv(synthetic_set, **{"--val-frac": "1.0"})))


# -- weights between the packages ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_detectors():
    return (JaxRetinaface(dtype=jnp.float32, **FACE), JaxPlateDetector(dtype=jnp.float32, **PLATE))


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


def test_jax_msgpack_loads_in_the_port(jax_detectors, tmp_path):
    """A file of the JAX package's ``save_variables`` (the JAX trainer's
    export format) as ``model_path`` of the port's Retinaface and
    PlateDetector: the same state as ``from_jax_variables`` and the same
    detections as the JAX detector on that file."""
    jface, jplate = jax_detectors
    face_file, plate_file = str(tmp_path / "face.msgpack"), str(tmp_path / "plate.msgpack")
    jax_save_variables(_numpy_tree(jface.variables), face_file)
    jax_save_variables(_numpy_tree(jplate.variables), plate_file)
    face = Retinaface(model_path=face_file, dtype=torch.float32, device="cpu", **FACE)
    plate = PlateDetector(model_path=plate_file, dtype=torch.float32, device="cpu", **PLATE)
    for net, variables in ((face.net, jface.variables), (plate.net, jplate.variables)):
        want = from_jax_variables(_numpy_tree(variables))
        assert all(torch.equal(v, want[k]) for k, v in net.state_dict().items())
    img, _ = _square(2)
    _assert_same_detections(_face_dets(face, img),
                            _face_dets(JaxRetinaface(model_path=face_file, dtype=jnp.float32, **FACE), img))
    np.testing.assert_allclose(plate.get_map_txt(img), jplate.get_map_txt(img), rtol=0, atol=1e-3)


def test_port_export_loads_in_jax(jax_detectors, tmp_path):
    """The port's ``export_inference_variables`` read by the JAX package's
    ``load_variables``: the same tree as ``to_jax_variables``, and the JAX
    Retinaface on it finds what the port's does."""
    from video_desensitization_torch.models.configs import cfg_mnet
    from video_desensitization_torch.models.retinaface import RetinaFace
    from video_desensitization_torch.train.checkpoint import export_inference_variables
    from video_desensitization_torch.train.step import create_train_state

    jface, _ = jax_detectors
    net = RetinaFace(cfg_mnet, mode="train")
    net.load_state_dict(from_jax_variables(_numpy_tree(jface.variables)))
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.01)  # weights of its own, not the file's source
    state = create_train_state(net, torch.optim.SGD(net.parameters(), lr=1e-3),
                               lambda step: 1e-3, device="cpu")
    path = export_inference_variables(str(tmp_path / "port.msgpack"), state)
    tree = jax_load_variables(path)
    want = to_jax_variables(net.state_dict())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    img, _ = _square(5)
    face = Retinaface(model_path=path, dtype=torch.float32, device="cpu", **FACE)
    _assert_same_detections(_face_dets(face, img),
                            _face_dets(JaxRetinaface(model_path=path, dtype=jnp.float32, **FACE), img))


def test_detector_hooks_match_jax(jax_detectors, synthetic_set):
    """get_map_txt of both detectors against the JAX package's on the same
    weights ((M, 15) and (M, 6) rows to 1e-3 px), get_FPS, and
    ``benchmarks/map_eval.py::evaluate_detector`` on the port's face
    detector over the synthetic set, equal to the JAX detector's scores."""
    jface, jplate = jax_detectors
    face = Retinaface(state_dict=from_jax_variables(_numpy_tree(jface.variables)),
                      dtype=torch.float32, device="cpu", **FACE)
    plate = PlateDetector(state_dict=from_jax_variables(_numpy_tree(jplate.variables)),
                          dtype=torch.float32, device="cpu", **PLATE)
    img, _ = _square(4)
    rows = face.get_map_txt(img)
    assert rows.shape[1] == 15 and len(rows) > 0
    np.testing.assert_allclose(rows, jface.get_map_txt(img), rtol=0, atol=1e-3)
    rows = plate.get_map_txt(img)
    assert rows.shape[1] == 6
    np.testing.assert_allclose(rows, jplate.get_map_txt(img), rtol=0, atol=1e-3)
    seconds = face.get_FPS(img, test_interval=2)
    assert np.isfinite(seconds) and seconds > 0

    spec = importlib.util.spec_from_file_location(
        "map_eval_of_port", os.path.join(REPO, "benchmarks", "map_eval.py"))
    map_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(map_eval)
    keys = [f"im{i}.jpg" for i in range(8)]
    paths = [str(synthetic_set / k) for k in keys]
    gt = {k: np.array([[10 + 5 * i, 18, 36 + 5 * i, 44]], np.float64) for i, k in enumerate(keys)}
    mine = map_eval.evaluate_detector(face, paths, gt, keys)
    theirs = map_eval.evaluate_detector(jface, paths, gt, keys)
    assert mine["n_gt"] == 8 and mine["n_det"] == theirs["n_det"] > 0
    for k in ("ap", "precision", "recall"):
        np.testing.assert_allclose(mine[k], theirs[k], rtol=0, atol=1e-6, err_msg=k)


def test_msgpack_codec_reads_what_flax_writes(tmp_path):
    """The port's codec on flax.serialization's output: nested maps, long
    keys, float32 / int32 / bfloat16 arrays, a numpy scalar, Python ints
    and a float; its own output (maps and arrays) read back by Flax; a
    chunked leaf (written only for leaves of 2**30 bytes or more) refused."""
    from flax import serialization

    from video_desensitization_torch.models.convert import load_variables, save_variables

    rng = np.random.default_rng(0)
    tree = {
        "params": {"a_rather_long_module_name_of_more_than_31_chars": {
            "kernel": rng.normal(0, 1, (3, 3, 4, 40)).astype(np.float32),
            "count": np.arange(70000, dtype=np.int32)}},
        "batch_stats": {f"bn{i}": {"mean": np.full(i + 1, i, np.float32)} for i in range(20)},
    }
    path = tmp_path / "flax.msgpack"
    extra = {"bf": jnp.full((2, 3), 1.5, jnp.bfloat16), "scalar": np.float32(2.5), "step": 7,
             "lr": 1e-3, "neg": -300}
    path.write_bytes(serialization.msgpack_serialize(dict(tree, **extra)))
    got = load_variables(str(path))
    assert got.pop("bf").equal(torch.full((2, 3), 1.5, dtype=torch.bfloat16))
    assert [got.pop(k) for k in ("scalar", "step", "lr", "neg")] == [2.5, 7, 1e-3, -300]
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(tree)]
    for (_, a), (_, b) in zip(flat(got), flat(tree)):
        np.testing.assert_array_equal(a, b)
    mine = tmp_path / "port.msgpack"
    save_variables(tree, str(mine))
    back = serialization.msgpack_restore(mine.read_bytes())
    for (_, a), (_, b) in zip(flat(back), flat(tree)):
        np.testing.assert_array_equal(a, b)
    chunked = tmp_path / "chunked.msgpack"
    chunked.write_bytes(serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}, "chunks": {"0": np.zeros(2)}}}))
    with pytest.raises(ValueError, match="chunked"):
        load_variables(str(chunked))

"""The port's RT-DETR plate detector on the CPU, against the plain oracle
(``tests/rtdetr_oracle.py``) at a tiny size: a ResNet-vd of one block a
stage, hidden width 64, 8 heads, 20 queries, 2 decoder layers, 128 x 128
input, seeded weights in float32. Then the plain deformable attention, the
anchors' valid mask, the vd block, the benchmark's reference, and the CLI's
``[TPU] plate_arch = rtdetr-r50vd``: the fused engine with RT-DETR in the
plate slot, and the tiered engine refusing it.

Tolerance against the oracle: 1e-4 on logits and boxes (O(1) values). The
port's attention is ``F.scaled_dot_product_attention`` and the oracle's is
written out, the port projects only the selected tokens' boxes, and the
same float32 products are blocked differently: each rounds differently,
by about 1e-6 here. The selected token indices must agree exactly.
"""

import numpy as np
import pytest
import torch

import rtdetr_oracle as oracle
from video_desensitization_torch.models.common import init_weights
from video_desensitization_torch.models.rtdetr import RTDETR, make_anchors
from video_desensitization_torch.models.resnet import Bottleneck, ResNet50VdFeatures
from video_desensitization_torch.ops.msda import msda_plain

TINY = dict(num_classes=1, blocks=(1, 1, 1, 1), hidden_dim=64, nhead=8, num_queries=20,
            num_decoder_layers=2)
TINY_ORACLE = dict(nc=1, blocks=(1, 1, 1, 1), hidden=64, heads=8, ffn=1024, queries=20,
                   dec_layers=2)
TOL = 1e-4


def _pair(seed=3):
    port = RTDETR(**TINY).eval()
    init_weights(port, torch.Generator().manual_seed(seed))
    ref = oracle.TRTDETR(**TINY_ORACLE).eval()
    ref.load_state_dict(port.state_dict())
    return port, ref


@pytest.mark.parametrize("seed", [3, 4])
def test_rtdetr_matches_the_oracle(seed):
    port, ref = _pair(seed)
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        logits, boxes, index = port(x)
        want_logits, want_boxes, want_index = ref(x)
    assert torch.equal(index, want_index)
    torch.testing.assert_close(logits, want_logits, atol=TOL, rtol=0)
    torch.testing.assert_close(boxes, want_boxes, atol=TOL, rtol=0)
    assert logits.shape == (2, 20, 1) and boxes.shape == (2, 20, 4)


def _msda_case(case, seed=0):
    """(value, shapes, offsets, logits, ref): ``case`` places the points
    inside the maps, on their edges and sample centres, or outside."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(5, 7), (3, 4), (2, 2)]
    b, q, heads, d, points = 2, 6, 4, 8, 3
    value = torch.randn(b, sum(h * w for h, w in shapes), heads, d, generator=g)
    logits = torch.randn(b, q, heads, len(shapes) * points, generator=g)
    offsets = torch.randn(b, q, heads, len(shapes), points, 2, generator=g)
    ref = torch.rand(b, q, 4, generator=g) * 0.5 + 0.25
    if case == "edges":
        xy = torch.tensor([0.0, 1.0, 0.5 / 7, 1 - 0.5 / 7, 0.5, 1 / 3])
        ref = torch.stack([xy, xy.flip(0), torch.zeros(q), torch.zeros(q)], -1).expand(b, -1, -1)
    elif case == "outside":
        offsets = offsets * 20
        ref[..., 2:] = 1.0
    return value, shapes, offsets, logits, ref.contiguous()


@pytest.mark.parametrize("case", ["inside", "edges", "outside"])
def test_msda_plain_matches_grid_sample(case):
    value, shapes, offsets, logits, ref = _msda_case(case)
    got = msda_plain(value, shapes, offsets, logits, ref)
    b, q, heads = logits.shape[:3]
    weights = torch.softmax(logits, -1).view(b, q, heads, len(shapes), -1)
    loc = ref[:, :, None, None, None, :2] + offsets / offsets.shape[-2] * ref[
        :, :, None, None, None, 2:] * 0.5
    want = oracle.msda_grid_sample(value, shapes, loc, weights)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    if case == "outside":  # some points leave every map and add nothing
        assert bool((loc.abs() > 1.5).any())


def test_msda_plain_keeps_the_value_dtype():
    value, shapes, offsets, logits, ref = _msda_case("inside")
    got = msda_plain(value.to(torch.bfloat16), shapes, offsets, logits, ref)
    want = msda_plain(value.to(torch.bfloat16).float(), shapes, offsets, logits, ref)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16))


def test_anchors_valid_mask_at_0_01_and_0_99():
    """A 50-wide level puts centres at exactly 0.01 and 0.99: both invalid,
    the next ones in; the port's anchors equal the oracle's bitwise."""
    shapes = ((50, 50), (25, 25), (2, 3))
    anchors, valid = make_anchors(shapes)
    want_anchors, want_valid = oracle.anchors_and_mask(shapes)
    assert torch.equal(valid, want_valid) and torch.equal(anchors, want_anchors)
    grid = valid[0, :2500, 0].view(50, 50)
    assert not grid[0].any() and not grid[-1].any() and not grid[:, 0].any()
    assert not grid[:, -1].any() and grid[1:-1, 1:-1].all()
    assert torch.isinf(anchors[0, :2500][~valid[0, :2500, 0]]).all()
    # level 2's sides are 0.2: valid wherever the centres are
    assert valid[0, 2500 + 625:, 0].all()


@pytest.mark.parametrize("hw", [(64, 64), (66, 70)])
def test_vd_backbone_and_bottleneck_match_the_oracle(hw):
    """The deep stem, the average-pool shortcut (ceil mode on odd maps) and
    the shared ``Bottleneck``."""
    port = ResNet50VdFeatures(blocks=(1, 2, 1, 1)).eval()
    init_weights(port, torch.Generator().manual_seed(5))
    ref = oracle.TPResNetVd(blocks=(1, 2, 1, 1)).eval()
    ref.load_state_dict(port.state_dict())
    x = torch.randn(2, 3, *hw, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        for got, want in zip(port(x), ref(x)):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert isinstance(port.layer2[0], Bottleneck)
    assert isinstance(port.layer2[0].downsample[0], torch.nn.AvgPool2d)
    assert port.layer1[0].downsample[0].stride == (1, 1)


def test_the_benchmark_reference_equals_the_oracle_bitwise():
    from portbench.reference import rtdetr as bench_ref

    port, ref = _pair()
    bench = bench_ref.RTDETR(**TINY_ORACLE).eval()
    bench.load_state_dict(port.state_dict())
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(9))
    record = []
    bench_ref.record_locations(bench, record)
    with torch.no_grad():
        for got, want in zip(bench(x), ref(x)):
            assert torch.equal(got, want)
    assert len(record) == 2 and record[0].shape == (2, 20, 8, 3, 4, 2)


# ---- the CLI's plate_arch


H, W = 96, 192


def _ini(tmp_path, engine="fused", arch="rtdetr-r50vd"):
    ini = tmp_path / "c.ini"
    ini.write_text(
        "[PATHS]\nmodel_path = random\nmodel_weights = random\n"
        f"[TPU]\ndtype = float32\nengine = {engine}\ninput_size = 128\nplate_arch = {arch}\n"
        "max_detections = 16\n")
    return str(ini)


@pytest.fixture
def tiny_detr(monkeypatch):
    """The CLI's RT-DETR at the tiny size, and a MobileNet face."""
    from video_desensitization_torch.cli import main as cli
    from video_desensitization_torch.detect import detr, face

    monkeypatch.setattr(detr, "PUBLISHED", {**detr.PUBLISHED, **TINY, "num_classes": 80})
    real = face.Retinaface

    def mobilenet_face(**kw):
        return real(**dict(kw, backbone="mobilenet"))

    monkeypatch.setattr(face, "Retinaface", mobilenet_face)
    return cli


def test_build_engine_puts_rtdetr_in_the_fused_engine(tmp_path, tiny_detr):
    from video_desensitization_torch.api.config import load_config
    from video_desensitization_torch.detect.detr import RtDetrPlateDetector
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine
    from video_desensitization_torch.utils.timers import StageTimer, activate

    cfg = load_config(_ini(tmp_path), strict=False)
    assert cfg.plate_arch == "rtdetr-r50vd"
    engine = tiny_detr.build_engine(cfg, allow_random=True, device="cpu")
    assert isinstance(engine, DesensitizationEngine)
    plate = engine.plate
    assert isinstance(plate, RtDetrPlateDetector) and plate.net.decoder.num_queries == 20
    seen = {}
    for det, name in ((engine.face, "face"), (plate, "plate")):
        program = det._detect_program

        def spy(frames, shapes, program=program, name=name):
            seen[name] = tuple(frames.shape)
            return program(frames, shapes)

        det._detect_program = spy
    frames = np.random.default_rng(0).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    timer = StageTimer()
    with activate(timer):
        res = engine.process_batch(frames.copy())
    # the face reads the shared canvas, RT-DETR the whole frames it stretches
    assert seen == {"face": (2, 128, 128, 3), "plate": (2, H, W, 3)}
    assert engine.last_letterbox.startswith("shared-")
    dets, keep = plate.detect_padded(frames)
    assert res.plate_boxes == [dets[i][keep[i]][:, :4].tolist() for i in range(2)]
    assert res.num_plates == int(keep.sum()) > 0
    assert timer.counts["plate.program"] == 1 and timer.counts["detr.decoder"] == 1
    plate_only = StageTimer()
    with activate(plate_only):
        plate.detect_padded(frames)
    assert "nms.flag_read" not in plate_only.counts  # no NMS: no convergence read
    rows = dets[keep]
    assert bool((rows[:, 4] >= 0.5).all()) and bool((rows[:, [0, 2]] <= W).all())


def test_build_engine_refuses_rtdetr_on_the_tiered_engine(tmp_path, tiny_detr):
    from video_desensitization_torch.api.config import load_config

    cfg = load_config(_ini(tmp_path, engine="tiered"), strict=False)
    with pytest.raises(ValueError, match="plate_arch = rtdetr-r50vd needs engine = fused"):
        tiny_detr.build_engine(cfg, allow_random=True, device="cpu")
    with pytest.raises(ValueError, match="plate_arch"):
        load_config(_ini(tmp_path, arch="rtdetr"), strict=False)
    cfg = load_config(_ini(tmp_path, engine="tiered", arch="yolov8n"), strict=False)
    assert tiny_detr.build_engine(cfg, allow_random=True, device="cpu") is not None


def test_rtdetr_refuses_a_letterboxed_canvas_and_a_checkpoint_file():
    from video_desensitization_torch.detect.detr import RtDetrPlateDetector

    det = RtDetrPlateDetector(input_shape=(128, 128), max_detections=8, dtype=torch.float32,
                              device="cpu", **{k: v for k, v in TINY.items() if k != "num_classes"})
    assert det.takes_letterbox is False and det.top_k == 8
    with pytest.raises(NotImplementedError):
        det._detect_letterboxed_program(None, None, None)
    with pytest.raises(ValueError, match="no RT-DETR checkpoint loader"):
        RtDetrPlateDetector(model_path="plate.pt", device="cpu")

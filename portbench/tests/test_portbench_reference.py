"""The plain reference against itself across seeds, and its mosaic
against OpenCV's recipe."""

import numpy as np
import pytest
import torch

from portbench import common, traffic
from portbench.common import subseed
from portbench.drivers import fused_stream as fs
from portbench.reference import detect
from portbench.tests.tiny import TINY

CELL = "r50y8n-fused-stream-1080p"


def _setup(seed):
    cfg = dict(common.load_config("retinaface-r50_yolov8n-640"), **TINY[CELL]["config"])
    tp = dict(common.load_workload(CELL)["traffic"], **TINY[CELL]["traffic"])
    pool = traffic.frame_pool(tp, subseed(seed, "frames"), "cpu")
    cfg["calibration_traffic"] = dict(cfg["calibration_traffic"], **{
        k: v for k, v in TINY[CELL]["traffic"].items() if k in cfg["calibration_traffic"]})
    return cfg, tp, pool, fs._seeded(cfg, "cpu", torch.float32)


def _kept(ref):
    return [[d["kept"] for d in side] for batch in ref for side in batch]


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_the_reference_repeats_itself_and_judges_itself_exact(seed):
    cfg, tp, pool, seeded = _setup(seed)
    a = fs.reference_detections(cfg, seeded, pool, "cpu")
    b = fs.reference_detections(cfg, fs._seeded(cfg, "cpu", torch.float32), pool, "cpu")
    for x, y in zip(_kept(a), _kept(b)):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    boxes = [([f["kept"][:, :4].tolist() for f in faces], [p["kept"][:, :4].tolist() for p in plates])
             for faces, plates in a]
    held = {j: [detect.mosaic_(torch.tensor(pool[j][i]), fs._frame_boxes(boxes[j][0][i], boxes[j][1][i]),
                               cfg["mosaic_level"]).numpy() for i in range(len(pool[j]))]
            for j in range(len(pool))}
    numbers = fs.judge(boxes, a, pool, held, cfg["mosaic_level"], "cpu", cfg)
    numbers.pop("_worst")
    assert numbers == {"box_err": 0.0, "box_err_mean": 0.0, "score_gap": 0.0, "score_gap_widest": 0.0,
                       "count_gap": 0.0, "set_gap": 0.0, "mosaic_px": 0}


def test_seeds_give_other_frames_of_the_same_sizes_to_one_model():
    cfg, _, pool_a, (face_a, plate_a) = _setup(5)
    _, _, pool_b, (face_b, plate_b) = _setup(6)
    assert [p.shape for p in pool_a] == [p.shape for p in pool_b]
    assert not np.array_equal(pool_a[0], pool_b[0])
    for a, b in ((face_a, face_b), (plate_a, plate_b)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    other = fs._seeded(dict(cfg, weights_seed=cfg["weights_seed"] + 1), "cpu", torch.float32)[0]
    assert not torch.equal(other["body.conv1.weight"], face_a["body.conv1.weight"])


def test_the_mosaic_is_opencvs_recipe():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
    boxes = np.array([[5.7, 3.2, 50.9, 41.0], [30, 20, 89, 59], [-4, -3, 12, 9], [70, 50, 71, 52]])
    want = frame.copy()
    for x1, y1, x2, y2 in np.trunc(boxes).astype(int):
        x1, y1, x2, y2 = max(x1, 0), max(y1, 0), min(x2, 90), min(y2, 60)
        roi = want[y1:y2, x1:x2]
        small = cv2.resize(roi, (max(1, (x2 - x1) // 8), max(1, (y2 - y1) // 8)),
                           interpolation=cv2.INTER_NEAREST)
        want[y1:y2, x1:x2] = cv2.resize(small, (x2 - x1, y2 - y1), interpolation=cv2.INTER_NEAREST)
    got = detect.mosaic_(torch.from_numpy(frame.copy()), boxes, 8).numpy()
    np.testing.assert_array_equal(got, want)

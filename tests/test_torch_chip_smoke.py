"""The memory bound that ``chip_smoke.py`` reports for the mosaic kernel,
counted on the CPU against boxes whose traffic is known by hand."""

import importlib.util
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py"
)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _bound_bytes(boxes, valid, level, shape=(1, 64, 128, 3)):
    frames = torch.zeros(shape, dtype=torch.uint8)
    ms = chip_smoke.mosaic_bound_ms(
        frames, torch.tensor(boxes, dtype=torch.int32), torch.tensor(valid), level
    )
    return round(ms * 1e-3 * chip_smoke.HBM_BYTES_PER_S)


def test_one_box_reads_one_row_in_level():
    """A 64x64 box at level 8 maps offset t to 8 * (t // 8). Its 64 rows of
    192 bytes are written (6 sectors each; the pixels that are their own
    source share those sectors); 8 source rows are read, and their sources
    (every 8th pixel, 24 bytes apart) touch 6 sectors each."""
    assert _bound_bytes([[[0, 0, 64, 64]]], [[True]], 8) == 32 * (64 * 6 + 8 * 6)


@pytest.mark.parametrize(
    "boxes, valid",
    [
        ([[[0, 0, 64, 64], [0, 0, 64, 64]]], [[True, True]]),  # repeat: idempotent
        ([[[0, 0, 64, 64], [-9, -9, 300, 300]]], [[True, False]]),  # invalid
        ([[[0, 0, 64, 64], [128, 0, 200, 64]]], [[True, True]]),  # outside
    ],
    ids=["repeat", "invalid", "outside"],
)
def test_boxes_that_move_nothing_add_nothing(boxes, valid):
    assert _bound_bytes(boxes, valid, 8) == _bound_bytes([[[0, 0, 64, 64]]], [[True]], 8)


def test_level_one_is_the_identity():
    assert _bound_bytes([[[3, 5, 60, 40]]], [[True]], 1) == 0


class _Event:
    """One key-average row of a device kernel, as torch.profiler gives it."""

    def __init__(self, count, us):
        self.key, self.count, self.self_device_time_total = "kernel", count, us
        self.device_type = torch.autograd.DeviceType.CUDA


GOOD = [_Event(100, 1650.0)]


@pytest.mark.parametrize(
    "sessions, want",
    [
        ([[], GOOD, GOOD], (0.033, 2.0)),  # a session with no device event
        ([[_Event(100, 660.0)], GOOD, GOOD], (0.033, 2.0)),  # lost time
        ([[_Event(66, 900.0)], GOOD, GOOD], (0.033, 2.0)),  # lost kernels
        ([GOOD, [_Event(100, 1600.0)]], (0.032, 2.0)),  # two agree within 20%
        ([[]] * 6, (None, 0.0)),  # never two that agree
    ],
    ids=["empty", "lost-time", "lost-kernels", "agree", "never"],
)
def test_profiled_device_ms_takes_two_agreeing_sessions(monkeypatch, sessions, want):
    """The device time ``chip_smoke.py`` reports comes from two profiler
    sessions that saw whole kernels per call and agree; sessions that lost
    events are run again."""
    import torch.profiler

    from video_desensitization_torch import bench_util

    queue = list(sessions)

    class FakeProfile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return queue.pop(0)

    monkeypatch.setattr(torch.profiler, "profile", lambda **kwargs: FakeProfile())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    ms, kernels = bench_util.profiled_device_ms(lambda: None, reps=50)
    assert (ms if ms is None else round(ms, 6), kernels) == want


def test_check_final_record_holds_a_repack_to_its_source(tmp_path):
    """The record phase's check of a repacked record, on the committed
    1080p fixture repacked with its own streams as the processed videos:
    the camera topics keep their messages from the first keyframe on, the
    chatter passes; a record that lost a camera message or changed a
    chatter payload fails."""
    import shutil

    from video_desensitization_torch.record.reader import RecordReader
    from video_desensitization_torch.record.repack import write_allH265_record_all
    from video_desensitization_torch.record.unpack import read_record2h265_all
    from video_desensitization_torch.record.writer import RecordWriter
    from video_desensitization_torch.video import av

    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")
    (tmp_path / "in").mkdir()
    src = shutil.copy(chip_smoke.RECORD_FIXTURE, tmp_path / "in")
    processed = tmp_path / "processed"
    processed.mkdir()
    for path in read_record2h265_all(str(src), str(tmp_path / "h265")).values():
        name = Path(path).name.replace(".h265", "_processed.h265")
        shutil.copy(path, processed / name)
    final = write_allH265_record_all(str(src), str(processed), str(tmp_path / "out"))
    counts = chip_smoke.check_final_record(str(src), final)
    assert sorted(counts.values()) == [16, 16, 19]

    reader = RecordReader(final)
    messages = list(reader.read_messages())
    for drop, topic in (("camera", "/drivers/camera/rear/compressed/image"),
                        ("chatter", "/misc/chatter")):
        bad = str(tmp_path / f"{drop}.record")
        with RecordWriter(bad) as w:
            for name, ch in reader.channels.items():
                w.write_channel(name, ch.message_type)
            last = max(i for i, (t, _, _) in enumerate(messages) if t == topic)
            for i, (t, m, ts) in enumerate(messages):
                if i == last:
                    if drop == "camera":
                        continue
                    m = b"changed"
                w.write_message(t, m, ts)
        with pytest.raises(RuntimeError, match=topic):
            chip_smoke.check_final_record(str(src), bad)


def test_stream_stage_ms_times_each_stage_and_unwraps():
    """The tiered phase's per-stage times inside ``process_stream``: one
    median per stage, every batch still comes back, and the pipeline's own
    methods are restored after the timed stream."""
    import numpy as np

    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.pipeline.throughput import TieredPipeline

    face = Retinaface(backbone="mobilenet", input_shape=[64, 64, 3], max_detections=4,
                      dtype=torch.float32, device="cpu")
    pipe = TieredPipeline(face, None)
    batches = [np.random.default_rng(i).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
               for i in range(3)]
    times = chip_smoke.stream_stage_ms(pipe, batches)
    assert set(times) == {"letterbox", "dispatch", "finalize"}
    assert all(ms > 0 for ms in times.values())
    assert not {"letterbox_batch", "dispatch", "finalize"} & set(vars(pipe))
    assert len(list(pipe.process_stream(iter(batches)))) == 3

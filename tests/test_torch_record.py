"""The port's record layer and record job against the JAX package's: the
LZ4 block codec, the writer's bytes, the reader, unpack (keyframe gating,
multi-segment sets), repack (pairing, dropping), the committed 1080p
fixture, and the whole job (unpack -> detect -> mosaic -> repack) with the
tiered and the fused engine, plus one CLI run of the port alone.

The engines are the stream tests' small ones: 96x160 frames,
RetinaFace-mobilenet + YOLOv8n at 128 in float32, the JAX package's
weights carried across. Tests that encode or demux HEVC need the native
libav layer and skip without it.

The fixture ``tests/fixtures/torch_record_1080p.record`` is made by
``build_fixture_record`` (needs libav with libx265):

    PYTHONPATH=. python tests/test_torch_record.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.api.config import load_config as jax_load_config
from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.pipeline.engine import DesensitizationEngine as JaxEngine
from video_desensitization_tpu.pipeline.throughput import TieredPipeline as JaxTiered
from video_desensitization_tpu.pipeline.video_pipeline import process_record_job as jax_record_job
from video_desensitization_tpu.record import lz4block as jax_lz4
from video_desensitization_tpu.record.reader import RecordReader as JaxRecordReader
from video_desensitization_tpu.record.repack import write_allH265_record_all as jax_repack
from video_desensitization_tpu.record.unpack import read_record2h265_all as jax_unpack
from video_desensitization_tpu.record.writer import RecordWriter as JaxRecordWriter
from video_desensitization_tpu.video import nal as jax_nal

from video_desensitization_torch.api.config import load_config
from video_desensitization_torch.cli.main import main
from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.pipeline.throughput import TieredPipeline
from video_desensitization_torch.pipeline.video_pipeline import process_record_job
from video_desensitization_torch.record import lz4block
from video_desensitization_torch.record.proto import cyber_record_pb2 as rp
from video_desensitization_torch.record.proto import sensor_image_pb2 as sp
from video_desensitization_torch.record.reader import RecordReader
from video_desensitization_torch.record.repack import write_allH265_record_all
from video_desensitization_torch.record.topics import CAMERA_TOPICS, COMPRESSED_IMAGE_TYPE
from video_desensitization_torch.record.unpack import read_record2h265_all
from video_desensitization_torch.record.writer import RecordWriter
from video_desensitization_torch.video import av
from video_desensitization_torch.video import nal
from video_desensitization_torch.video.nal import is_hevc_keyframe

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
FIXTURE_1080P = os.path.join(FIXTURES, "torch_record_1080p.record")
# The 1080p fixture: two camera topics of FIXTURE_FRAMES HEVC frames each;
# the first topic starts with FIXTURE_PREKEY messages before its keyframe
# (the tail of its own stream); one non-camera channel; LZ4 chunks.
FIXTURE_TOPICS = (CAMERA_TOPICS[0], CAMERA_TOPICS[5])
FIXTURE_FRAMES = 16
FIXTURE_PREKEY = 3
CHATTER = "/misc/chatter"
H, W = 96, 160


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def native():
    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")


def hevc_packets(n, h, w, level, path, moving=True):
    """``n`` HEVC packets (libx265 ultrafast, one keyframe first) of flat
    frames at gray ``level``, with a bright square moving across them."""
    with av.VideoEncoder(path, w, h, fps=30, codec="libx265", bitrate=200_000,
                         preset="ultrafast") as enc:
        for i in range(n):
            frame = np.full((h, w, 3), level, np.uint8)
            if moving:
                s = h // 4
                x = (i * w // n) % (w - s)
                frame[s : 2 * s, x : x + s] = 230
            enc.write(frame)
    with av.PacketDemuxer(path) as dm:
        return dm.read_packets()


def write_camera_record(path, streams, chatter=True, compress=rp.COMPRESS_NONE,
                        chunk_message_limit=500, writer=RecordWriter, image=sp.CompressedImage):
    """A record of camera ``streams`` ({topic: [payload bytes]}) sent in
    turn one message per topic per tick (sequence numbers per topic, 33 ms
    ticks), plus a ``/misc/chatter`` message per tick."""
    ticks = max(len(p) for p in streams.values())
    with writer(path, chunk_message_limit=chunk_message_limit, compress=compress) as w:
        for topic in streams:
            w.write_channel(topic, COMPRESSED_IMAGE_TYPE)
        if chatter:
            w.write_channel(CHATTER, "some.Type")
        for i in range(ticks):
            t = 1_000_000_000 + i * 33_000_000
            for k, (topic, payloads) in enumerate(streams.items()):
                if i < len(payloads):
                    img = image(format="h265", data=payloads[i], measurement_time=i / 30)
                    img.header.sequence_num = i
                    w.write_message(topic, img, t + k * 1000)
            if chatter:
                w.write_message(CHATTER, b"chatter-%d" % i, t + 500)


def build_fixture_record(path=FIXTURE_1080P, tmp_dir=None):
    """Make the committed 1080p fixture with the port's native libx265."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        streams = {}
        for k, topic in enumerate(FIXTURE_TOPICS):
            pkts = hevc_packets(FIXTURE_FRAMES, 1080, 1920, 60 + 80 * k, f"{tmp}/{k}.h265")
            data = [bytes(p.data) for p in pkts]
            streams[topic] = data[-FIXTURE_PREKEY:] + data if k == 0 else data
    write_camera_record(path, streams, compress=rp.COMPRESS_LZ4, chunk_message_limit=8)
    return path


# -- LZ4 ------------------------------------------------------------------------


def _lz4_cases():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "one": b"x",
        "repeat": b"abcd" * 2000,
        "random": bytes(rng.integers(0, 256, 50000, dtype=np.uint8)),
        "zeros": b"\x00" * 70000,
        "four-symbols": bytes(rng.integers(0, 4, 100000, dtype=np.uint8)),
        "ramp": bytes(range(256)) * 100,
    }


@pytest.mark.parametrize("case", list(_lz4_cases()))
def test_lz4_native_python_and_jax_agree(case):
    """The port's native codec, its Python codecs and the JAX package's
    module: the same compressed bytes, and each decoder reads every
    encoding."""
    data = _lz4_cases()[case]
    assert lz4block.native_available(), lz4block._load_error
    c = lz4block.compress(data)
    assert c == jax_lz4.compress(data)
    literal = lz4block._compress_literal_py(data)
    assert literal == jax_lz4._compress_literal_py(data)
    for blob in (c, literal):
        assert lz4block.decompress(blob) == data
        assert lz4block.decompress(blob, size_hint=len(data)) == data
        assert lz4block._decompress_py(blob) == data
        assert jax_lz4.decompress(blob) == data
    if case in ("repeat", "zeros", "ramp"):
        assert len(c) < len(data) // 4
    with pytest.raises(ValueError):
        lz4block.decompress(bytes([0xF0, 255, 255]))  # truncated length
    with pytest.raises(ValueError):
        lz4block._decompress_py(bytes([0xF0, 255, 255]))


# -- writer and reader -------------------------------------------------------------


@pytest.mark.parametrize("compress", ["NONE", "BZ2", "LZ4"])
def test_writer_bytes_equal_jax_writer(tmp_path, compress):
    code = getattr(rp, f"COMPRESS_{compress}")
    rng = np.random.default_rng(1)
    payloads = [bytes(rng.integers(0, 4, 3000, dtype=np.uint8)) for _ in range(10)]
    streams = {CAMERA_TOPICS[0]: payloads, CAMERA_TOPICS[3]: payloads[::-1]}
    mine, theirs = str(tmp_path / "mine.record"), str(tmp_path / "theirs.record")
    write_camera_record(mine, streams, compress=code, chunk_message_limit=6)
    write_camera_record(theirs, streams, compress=code, chunk_message_limit=6,
                        writer=JaxRecordWriter)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    r = RecordReader(mine)
    assert r.header.compress == code and r.header.is_complete
    assert r.header.message_number == 30 and len(r.channels) == 3
    got = [(t, bytes(m.data) if t != CHATTER else m, ts) for t, m, ts in r.read_messages()]
    want = [(t, bytes(m.data) if t != CHATTER else m, ts)
            for t, m, ts in JaxRecordReader(theirs).read_messages()]
    assert got == want


def test_reader_on_golden_apollo_record():
    """The spec-built golden record (tests/test_record_interop.py): the
    same header, channels and messages as the JAX reader."""
    path = os.path.join(FIXTURES, "golden_apollo.record")
    mine, theirs = RecordReader(path), JaxRecordReader(path)
    assert mine.header.SerializeToString() == theirs.header.SerializeToString()
    assert {k: v.SerializeToString() for k, v in mine.channels.items()} == {
        k: v.SerializeToString() for k, v in theirs.channels.items()
    }
    got = [(t, m.SerializeToString(), ts) for t, m, ts in mine.read_messages()]
    want = [(t, m.SerializeToString(), ts) for t, m, ts in theirs.read_messages()]
    assert len(got) == 4 and got == want
    assert [ts for _, _, ts in mine.read_messages(CAMERA_TOPICS[5])] == [1_500, 2_500]


# -- unpack and repack ---------------------------------------------------------------


@pytest.fixture(scope="module")
def packets(native, tmp_path_factory):
    """Ten 96x160 HEVC packets; the stream's only keyframe is the first."""
    d = tmp_path_factory.mktemp("hevc")
    pkts = hevc_packets(10, H, W, 100, str(d / "src.h265"))
    assert pkts[0].is_key and not any(p.is_key for p in pkts[1:])
    return [bytes(p.data) for p in pkts]


def _read_tree(path):
    return {
        os.path.relpath(os.path.join(root, f), path): open(os.path.join(root, f), "rb").read()
        for root, _, files in os.walk(path) for f in files
    }


def test_unpack_gates_keyframes_across_segments(tmp_path, packets):
    """A two-segment LZ4 set that starts mid-GOP: each topic's stream is
    its payloads from the first keyframe on, across the segment boundary,
    byte for byte as the JAX unpack writes it; no staging copy is left."""
    rotated = packets[3:] + packets[:3]  # seven non-key packets lead
    key = next(i for i, p in enumerate(rotated) if is_hevc_keyframe(p))
    assert key == 7
    recdir = tmp_path / "recs"
    recdir.mkdir()
    topics = CAMERA_TOPICS[:2]
    for seg, part in enumerate((rotated[:8], rotated[8:])):
        write_camera_record(str(recdir / f"s.record.{seg:05d}"), {t: part for t in topics},
                            compress=rp.COMPRESS_LZ4)
    out = read_record2h265_all(str(recdir), str(tmp_path / "mine"))
    jax_unpack(str(recdir), str(tmp_path / "theirs"))
    assert set(out) == set(topics)
    expect = b"".join(rotated[key:])
    for path in out.values():
        assert open(path, "rb").read() == expect
    assert _read_tree(tmp_path / "mine") == _read_tree(tmp_path / "theirs")
    assert sorted(os.listdir(recdir)) == ["s.record.00000", "s.record.00001"]


def test_repack_pairs_gated_messages_and_drops_unmatched_cameras(tmp_path, packets):
    """A record starting mid-GOP for one camera, with a second camera that
    has no processed video: the first camera's surviving messages take the
    processed packets in order (pre-keyframe messages dropped), the second
    camera is dropped, never copied raw, the chatter passes through; the
    final record is byte for byte the JAX repack's."""
    topics = CAMERA_TOPICS[:2]
    streams = {topics[0]: packets[-2:] + packets, topics[1]: packets}
    rec = str(tmp_path / "t.record")
    write_camera_record(rec, streams)
    out = read_record2h265_all(rec, str(tmp_path / "h"))
    processed = tmp_path / "processed"
    processed.mkdir()
    (processed / "topic_front_narrow_processed.h265").write_bytes(open(out[topics[0]], "rb").read())
    mine = write_allH265_record_all(rec, str(processed), str(tmp_path / "mine"))
    theirs = jax_repack(rec, str(processed), str(tmp_path / "theirs"))
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    r = RecordReader(mine)
    msgs = list(r.read_messages(topics[0]))
    assert [bytes(m.data) for _, m, _ in msgs] == packets
    assert [m.header.sequence_num for _, m, _ in msgs] == list(range(2, 12))
    assert list(r.read_messages(topics[1])) == []
    assert [m for _, m, _ in r.read_messages(CHATTER)] == [b"chatter-%d" % i for i in range(12)]


def test_packet_repair_matches_jax(tmp_path, packets):
    """ReadPacket against the JAX package's: the demuxed packets of a
    stream that starts mid-GOP (leading non-keyframes dropped), the pts
    repair, and pairing packets with record messages (keyframe gating,
    truncation to the shorter side, headers and times kept)."""
    from video_desensitization_tpu.record.packets import FramePacket as JaxFramePacket
    from video_desensitization_tpu.record.packets import ReadPacket as JaxReadPacket
    from video_desensitization_torch.record.packets import FramePacket, ReadPacket

    mine, theirs = ReadPacket(), JaxReadPacket()
    src = tmp_path / "x.h265"
    src.write_bytes(b"".join(packets))
    got, want = mine.read_packet(str(src)), theirs.read_packet(str(src))
    assert [(p.data, p.is_key_frame) for p in got] == [(p.data, p.is_key_frame) for p in want]
    assert len(got) == 10 and mine.read_packet(str(tmp_path / "missing.h265")) == []
    pts = [(0, 2), (None, 2), (None, 2), (2, 2), (None, 0)]
    fixed = mine.fix_missing_pts([FramePacket(b"%d" % i, pts=p, duration=d) for i, (p, d) in enumerate(pts)])
    jfixed = theirs.fix_missing_pts([JaxFramePacket(b"%d" % i, pts=p, duration=d) for i, (p, d) in enumerate(pts)])
    assert [(p.data, p.pts) for p in fixed] == [(p.data, p.pts) for p in jfixed]
    messages = []
    for i, data in enumerate(packets[-3:] + packets):
        img = sp.CompressedImage(format="h265", data=data)
        img.header.sequence_num = i
        messages.append((img, 1000 + i))
    stream, frames = mine.process_frames_reader(messages)
    jstream, jframes = theirs.process_frames_reader(messages)
    assert stream == jstream == b"".join(packets)
    assert [(f.sequence_num, f.time, f.is_key_frame) for f in frames] == [
        (f.sequence_num, f.time, f.is_key_frame) for f in jframes]
    new = [FramePacket(b"new%d" % i) for i in range(5)]
    out = mine.process_frames_write(messages[3:], new)
    jout = theirs.process_frames_write(messages[3:], [JaxFramePacket(p.data) for p in new])
    assert [(m.SerializeToString(), t) for m, t in out] == [(m.SerializeToString(), t) for m, t in jout]
    assert [bytes(m.data) for m, _ in out] == [p.data for p in new]
    assert [m.header.sequence_num for m, _ in out] == [3, 4, 5, 6, 7]


def test_fixture_1080p_structure(tmp_path):
    """The committed fixture: LZ4 chunks, three channels, the first camera
    leading with FIXTURE_PREKEY non-key messages, and each camera's
    unpacked stream decoding to FIXTURE_FRAMES 1080x1920 frames (through
    whichever codec path this machine has)."""
    r = RecordReader(FIXTURE_1080P)
    assert r.header.compress == rp.COMPRESS_LZ4 and r.header.chunk_number > 1
    assert set(r.channels) == {*FIXTURE_TOPICS, CHATTER}
    data = {t: [bytes(m.data) for _, m, _ in r.read_messages(t)] for t in FIXTURE_TOPICS}
    assert [len(d) for d in data.values()] == [FIXTURE_FRAMES + FIXTURE_PREKEY, FIXTURE_FRAMES]
    assert r.message_count(CHATTER) == FIXTURE_FRAMES + FIXTURE_PREKEY
    first = data[FIXTURE_TOPICS[0]]
    assert not any(is_hevc_keyframe(p) for p in first[:FIXTURE_PREKEY])
    assert is_hevc_keyframe(first[FIXTURE_PREKEY]) and is_hevc_keyframe(data[FIXTURE_TOPICS[1]][0])
    assert os.path.getsize(FIXTURE_1080P) < 200_000
    out = read_record2h265_all(FIXTURE_1080P, str(tmp_path))
    for topic, payloads in data.items():
        gated = payloads[FIXTURE_PREKEY:] if topic == FIXTURE_TOPICS[0] else payloads
        assert open(out[topic], "rb").read() == b"".join(gated)
        with av.VideoDecoder(out[topic]) as dec:
            assert [f.shape for f in dec] == [(1080, 1920, 3)] * FIXTURE_FRAMES


# -- the record job ---------------------------------------------------------------


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8)


@pytest.fixture(scope="module")
def detectors():
    jface = JaxRetinaface(dtype=jnp.float32, **FACE)
    jplate = JaxPlateDetector(dtype=jnp.float32, **PLATE)
    tree = lambda v: jax.tree.map(np.asarray, dict(v))  # noqa: E731
    face = Retinaface(state_dict=from_jax_variables(tree(jface.variables)),
                      dtype=torch.float32, device="cpu", **FACE)
    plate = PlateDetector(state_dict=from_jax_variables(tree(jplate.variables)),
                          dtype=torch.float32, device="cpu", **PLATE)
    return jface, jplate, face, plate


def _job_config(tmp_path, name, record_dir):
    root = tmp_path / name
    ini = tmp_path / f"{name}.ini"
    ini.write_text(
        f"[PATHS]\nmodel_path=random\nmodel_weights=random\nrecord_dir={record_dir}\n"
        f"output_h265_dir={root / 'h265'}\noutput_videos_dir={root / 'videos'}\n"
        f"temp_directory_base={root / 'tmp'}\nrecord_output_dir={root / 'out'}\n"
        "[SETTINGS]\nbatch_size=4\nencode_preset=ultrafast\n"
        "[TPU]\ninput_size=128\nmax_detections=8\ndtype=float32\nconfidence=0.01\n"
        "output_fps=30\n"
    )
    return str(ini)


@pytest.fixture(scope="module")
def job_record(native, tmp_path_factory):
    """Two 96x160 cameras, the first starting with two pre-keyframe
    messages, and the chatter channel, in LZ4 chunks."""
    d = tmp_path_factory.mktemp("job")
    a = [bytes(p.data) for p in hevc_packets(8, H, W, 90, str(d / "a.h265"))]
    b = [bytes(p.data) for p in hevc_packets(8, H, W, 160, str(d / "b.h265"))]
    (d / "in").mkdir()
    write_camera_record(str(d / "in" / "job.record"),
                        {CAMERA_TOPICS[0]: a[-2:] + a, CAMERA_TOPICS[1]: b},
                        compress=rp.COMPRESS_LZ4, chunk_message_limit=8)
    return str(d / "in")


def _decode_payloads(messages, path):
    with open(path, "wb") as f:
        for _, m, _ in messages:
            f.write(bytes(m.data))
    with av.VideoDecoder(path) as dec:
        return [np.array(f) for f in dec]


def _recording_encoder(encoder_class, written):
    """``encoder_class`` that also keeps a copy of every frame it is handed,
    with how it was handed (under the output file's name), and then encodes
    it as before."""

    class Recording(encoder_class):
        def __init__(self, path, *args, **kwargs):
            super().__init__(path, *args, **kwargs)
            self.frames = written.setdefault(os.path.basename(path), [])

        def write(self, frame):
            self.frames.append(("rgb", np.array(frame)))
            super().write(frame)

        def write_i420(self, frame):
            self.frames.append(("i420", np.array(frame)))
            super().write_i420(frame)

    return Recording


@pytest.mark.parametrize("kind", ["tiered", "fused"])
def test_record_job_matches_jax(tmp_path, detectors, job_record, monkeypatch, kind):
    """process_record_job in both packages on the same record and weights:
    each camera's encoder is handed bitwise the same frames in the same
    form; the same channels, per-topic message counts after gating, times
    and sequence numbers; the chatter byte for byte; every camera payload
    decodes to its 8 frames. (The HEVC bytes themselves are not compared:
    x265's frame-threaded rate control is not deterministic under load.)"""
    from video_desensitization_torch.pipeline import streaming
    from video_desensitization_tpu.pipeline import streaming as jax_streaming

    jface, jplate, face, plate = detectors
    if kind == "tiered":
        engine, jax_engine = TieredPipeline(face, plate), JaxTiered(jface, jplate)
    else:
        engine, jax_engine = DesensitizationEngine(face, plate), JaxEngine(jface, jplate)
    handed = {"mine": {}, "theirs": {}}
    monkeypatch.setattr(streaming, "VideoEncoder",
                        _recording_encoder(streaming.VideoEncoder, handed["mine"]))
    monkeypatch.setattr(jax_streaming, "VideoEncoder",
                        _recording_encoder(jax_streaming.VideoEncoder, handed["theirs"]))
    mine = process_record_job(load_config(_job_config(tmp_path, "mine", job_record)), engine)
    theirs = jax_record_job(jax_load_config(_job_config(tmp_path, "theirs", job_record)), jax_engine)
    assert (mine.videos_processed, mine.videos_failed) == (2, 0)
    assert dataclasses.astuple(mine)[:6] == dataclasses.astuple(theirs)[:6]
    assert mine.faces + mine.plates > 0
    assert sorted(handed["mine"]) == sorted(handed["theirs"]) and len(handed["mine"]) == 2
    for name, frames in handed["mine"].items():
        assert len(frames) == len(handed["theirs"][name]) == 8
        for (k1, a), (k2, b) in zip(frames, handed["theirs"][name]):
            assert k1 == k2
            np.testing.assert_array_equal(a, b)
    a, b = RecordReader(mine.record_path), JaxRecordReader(theirs.record_path)
    assert set(a.channels) == set(b.channels) == {*CAMERA_TOPICS[:2], CHATTER}
    assert a.message_count(CHATTER) == 10
    assert [m for _, m, _ in a.read_messages(CHATTER)] == [m for _, m, _ in b.read_messages(CHATTER)]
    for k, topic in enumerate(CAMERA_TOPICS[:2]):
        ma, mb = list(a.read_messages(topic)), list(b.read_messages(topic))
        assert len(ma) == len(mb) == 8
        assert [(ts, m.header.sequence_num) for _, m, ts in ma] == [
            (ts, m.header.sequence_num) for _, m, ts in mb]
        assert ma[0][1].header.sequence_num == (2 if k == 0 else 0)
        fa = _decode_payloads(ma, str(tmp_path / f"a{k}.h265"))
        fb = _decode_payloads(mb, str(tmp_path / f"b{k}.h265"))
        assert [f.shape for f in fa] == [f.shape for f in fb] == [(H, W, 3)] * 8


def test_cli_record_job_default_engine(tmp_path, job_record):
    """``main([config.ini])``: the CLI's default run, the tiered engine (its
    own ResNet-50 at 128) on the CPU, unpack to repack; a config missing a
    [PATHS] key is refused in this mode."""
    ini = _job_config(tmp_path, "cli", job_record)
    assert load_config(ini).engine == "tiered"
    assert main([ini, "--device", "cpu", "--no-plates"]) == 0
    final = RecordReader(str(tmp_path / "cli" / "out" / "job.record"))
    assert [final.message_count(t) for t in CAMERA_TOPICS[:2]] == [8, 8]
    assert final.message_count(CHATTER) == 10
    bad = tmp_path / "bad.ini"
    bad.write_text(open(ini).read().replace("record_output_dir", "record_out"))
    with pytest.raises(ValueError, match="record_output_dir"):
        main([str(bad), "--device", "cpu", "--no-plates"])


if __name__ == "__main__":
    if not av.native_available():
        sys.exit(f"the fixture needs the native libav layer: {av.codec_path()}")
    print(build_fixture_record(), os.path.getsize(FIXTURE_1080P), "bytes")


def _annex_b(rng, header_bytes):
    """An Annex-B access unit: each NAL header after a 3- or 4-byte start
    code, then a few seeded payload bytes."""
    out = bytearray()
    for header in header_bytes:
        out += b"\x00\x00\x00\x01" if rng.random() < 0.5 else b"\x00\x00\x01"
        out += bytes(header) + bytes(rng.integers(1, 256, int(rng.integers(1, 9)), dtype=np.uint8))
    return bytes(out)


# NAL headers: H.264 is one byte (type in bits 0-4), HEVC two (type in bits 1-6).
H264_UNITS = {"sps_pps_idr": [[0x67], [0x68], [0x65]], "non_idr": [[0x41]],
              "sps_pps_only": [[0x67], [0x68]], "sei_then_idr": [[0x06], [0x25]]}
HEVC_UNITS = {"vps_sps_pps_idr": [[0x40, 1], [0x42, 1], [0x44, 1], [0x26, 1]],
              "trail": [[0x02, 1]], "cra": [[0x2A, 1]], "params_only": [[0x40, 1], [0x42, 1]]}


@pytest.mark.parametrize("name", sorted(H264_UNITS) + sorted(HEVC_UNITS))
def test_keyframe_tests_match_jax(name):
    """``is_keyframe`` under every codec name and ``is_h264_keyframe`` on
    seeded payloads with IDR, non-IDR and parameter-set NAL units."""
    units = H264_UNITS.get(name) or HEVC_UNITS[name]
    payload = _annex_b(np.random.default_rng(len(name)), units)
    assert nal.is_h264_keyframe(payload) == jax_nal.is_h264_keyframe(payload)
    for codec in ("hevc", "h265", "h264", "avc"):
        assert nal.is_keyframe(payload, codec) == jax_nal.is_keyframe(payload, codec)
    assert nal.is_keyframe(payload) == jax_nal.is_keyframe(payload)
    key = name in ("sps_pps_idr", "sei_then_idr", "vps_sps_pps_idr", "cra")
    assert nal.is_keyframe(payload, "h264" if name in H264_UNITS else "hevc") == key


def test_keyframe_constants_and_unknown_codec_match_jax():
    for name in ("HEVC_IRAP_TYPES", "HEVC_IDR_TYPES", "HEVC_PARAM_TYPES", "H264_IDR", "H264_PARAM"):
        assert getattr(nal, name) == getattr(jax_nal, name)
    with pytest.raises(ValueError) as want:
        jax_nal.is_keyframe(b"", "vp9")
    with pytest.raises(ValueError) as got:
        nal.is_keyframe(b"", "vp9")
    assert str(got.value) == str(want.value)

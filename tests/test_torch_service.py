"""The port's resident service (``pipeline/service.py``, ``cli/serve.py``)
and ``cli/doctor.py`` against the JAX package's.

``group_inbox`` and ``load_service_config`` on the same inputs in both
packages; the claim, lock, recovery, journal and stability cases of
``tests/test_service.py`` run on both services (the same outcome from
each); one video job and one record job through the port's service on the
CPU, the video job's journal entry against the JAX service's on the same
weights; the serve CLI with ``--device cpu``; the HTTP endpoint; and
``doctor.collect()`` on a machine without CUDA."""

import dataclasses
import json
import os
import subprocess
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.api.config import load_config as jax_load_config
from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.pipeline import service as jax_service
from video_desensitization_tpu.pipeline.engine import DesensitizationEngine as JaxEngine

from video_desensitization_torch.api.config import load_config
from video_desensitization_torch.cli import doctor
from video_desensitization_torch.cli.serve import main as serve_main
from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.pipeline import service
from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.video import av

FORMATS = ["h265", "hevc", "265", "mp4", "mov", "avi"]
PACKAGES = {"port": (service, load_config), "jax": (jax_service, jax_load_config)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    """(service module, load_config) of the port, then of the JAX package."""
    return PACKAGES[request.param]


@pytest.fixture(scope="module")
def native():
    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")


def _pcfg(tmp, load):
    ini = tmp / "pipe.ini"
    ini.write_text(
        "[PATHS]\nmodel_path=random\nmodel_weights=random\n"
        "record_dir=\noutput_h265_dir=\noutput_videos_dir=\n"
        "temp_directory_base=\nrecord_output_dir=\n"
        "[SETTINGS]\nbatch_size=4\n[TPU]\noutput_fps=30\n"
    )
    return load(str(ini), strict=False)


def _service(tmp, pkg, engine=None, **kw):
    mod, load = pkg
    tmp.mkdir(parents=True, exist_ok=True)
    kw = {"poll_interval_s": 0.05, "stable_polls": 0, **kw}
    scfg = mod.ServiceConfig(inbox_dir=str(tmp / "inbox"), output_dir=str(tmp / "out"), **kw)
    return mod.DesensitizationService(scfg, _pcfg(tmp, load), engine)


def _write_video(path, frames=6, w=160, h=96):
    rng = np.random.default_rng(0)
    with av.VideoEncoder(str(path), w, h, fps=10, codec="mpeg4") as e:
        for _ in range(frames):
            e.write(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


# -- inbox grouping and the [SERVICE] section ---------------------------------------


LISTINGS = {
    "mixed": ["b.record.00001", "a.record", "b.record.00000", "cam.mp4", "notes.txt",
              ".hidden.mp4", ".claim.b.record.lock", "c.record.1", "c.record.0"],
    "markers": ["x.record.00000", "x.record.00001", "x.record.complete", "cam.MP4",
                "cam.MP4.complete", "orphan.complete", "v.h265"],
    "empty": [],
}


@pytest.mark.parametrize("listing", list(LISTINGS))
def test_group_inbox_equals_jax(listing):
    names = LISTINGS[listing]
    mine = service.group_inbox(names, FORMATS)
    theirs = jax_service.group_inbox(names, FORMATS)
    assert [dataclasses.astuple(j) for j in mine] == [dataclasses.astuple(j) for j in theirs]
    if listing == "mixed":
        by_name = {j.name: j for j in mine}
        assert set(by_name) == {"a.record", "b.record", "c.record", "cam.mp4"}
        assert by_name["c.record"].members == ["c.record.0", "c.record.1"]


def test_load_service_config_equals_jax(tmp_path):
    ini = tmp_path / "svc.ini"
    ini.write_text(
        "[PATHS]\nmodel_path=x\n"
        "[SERVICE]\ninbox_dir=/data/in\noutput_dir=/data/out\npoll_interval=0.5\n"
        "stable_polls=2\nhttp_port=0\ndelete_inputs=true\nheartbeat_interval=7\n"
        "journal_max_bytes=100\nnfs_safe_locks=yes\n"
    )
    for over in ({}, {"inbox_dir": "/mnt/in2", "output_dir": "/mnt/o2"}):
        mine = service.load_service_config(str(ini), **over)
        theirs = jax_service.load_service_config(str(ini), **over)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.work_dir == "/mnt/in2/.work" and mine.heartbeat_interval_s == 7.0
    bad = tmp_path / "bad.ini"
    bad.write_text("[SERVICE]\npoll_interval=1.5\n")
    for load in (service.load_service_config, jax_service.load_service_config):
        with pytest.raises(ValueError, match="requires"):
            load(str(bad))
        bad.write_text("[PATHS]\nmodel_path=x\n")
        with pytest.raises(ValueError, match="SERVICE"):
            load(str(bad))
        bad.write_text("[SERVICE]\npoll_interval=1.5\n")


# -- claims, locks, recovery, journal: both services, one outcome --------------------------


def _dead_pid():
    proc = subprocess.Popen(["true"])
    proc.wait()
    return proc.pid


def test_segment_set_claim_is_serialized_by_lock(tmp_path, pkg):
    """A held set lock makes claim() back off; a fresh lock of a dead owner
    is kept (mid-write guard); an old one is broken, and the next claim
    takes the whole set."""
    svc = _service(tmp_path, pkg)
    inbox = tmp_path / "inbox"
    (inbox / "x.record.00000").write_bytes(b"a")
    (inbox / "x.record.00001").write_bytes(b"b")
    jobs = svc.scan()
    assert len(jobs) == 1 and jobs[0].members == ["x.record.00000", "x.record.00001"]
    lock = inbox / ".claim.x.record.lock"
    lock.write_text(f"{os.uname().nodename}:{_dead_pid()}\n")
    assert svc.claim(jobs[0]) is None and (inbox / "x.record.00000").exists()
    old = time.time() - 120
    os.utime(lock, (old, old))
    assert svc.claim(jobs[0]) is None and not lock.exists()
    d = svc.claim(jobs[0])
    assert d is not None and not lock.exists()
    assert sorted(os.listdir(os.path.join(d, "in"))) == ["x.record.00000", "x.record.00001"]


def test_live_and_foreign_locks(tmp_path, pkg):
    """A live same-host owner's lock survives any age and a lost claim
    leaks no work dir; a foreign owner's lock is broken only past
    orphan_grace_s."""
    svc = _service(tmp_path, pkg, orphan_grace_s=100.0)
    inbox = tmp_path / "inbox"
    (inbox / "y.record.00000").write_bytes(b"a")
    jobs = svc.scan()
    lock = inbox / ".claim.y.record.lock"
    lock.write_text(f"{os.uname().nodename}:{os.getpid()}\n")
    old = time.time() - 7200
    os.utime(lock, (old, old))
    for _ in range(3):
        assert svc.claim(jobs[0]) is None
    assert lock.exists() and os.listdir(svc.cfg.work_dir) == []
    lock.write_text("some-other-host:12345\n")
    for age, kept in ((90, True), (200, False)):
        old = time.time() - age
        os.utime(lock, (old, old))
        assert svc.claim(jobs[0]) is None and lock.exists() == kept
    assert svc.claim(jobs[0]) is not None


def test_nfs_safe_link_lock_claims_exactly_once(tmp_path, pkg):
    s1 = _service(tmp_path, pkg, nfs_safe_locks=True)
    s2 = _service(tmp_path, pkg, nfs_safe_locks=True)
    inbox = tmp_path / "inbox"
    (inbox / "w.record.00000").write_bytes(b"a")
    (inbox / "w.record.00001").write_bytes(b"b")
    j1, j2 = s1.scan(), s2.scan()
    d1, d2 = s1.claim(j1[0]), s2.claim(j2[0])
    assert (d1 is None) != (d2 is None)
    assert sorted(os.listdir(os.path.join(d1 or d2, "in"))) == ["w.record.00000", "w.record.00001"]
    assert not [n for n in os.listdir(inbox) if n.endswith(".lock") or ".lock." in n]


def test_claim_is_atomic_across_workers(tmp_path, pkg):
    mod, _ = pkg
    s1 = _service(tmp_path, pkg)
    s2 = mod.DesensitizationService(
        mod.ServiceConfig(inbox_dir=str(tmp_path / "inbox"), output_dir=str(tmp_path / "out2"),
                          work_dir=str(tmp_path / "work2"), stable_polls=0),
        s1.pcfg, None)
    (tmp_path / "inbox" / "x.mp4").write_bytes(b"\x00" * 64)
    jobs1, jobs2 = s1.scan(), s2.scan()
    assert (s1.claim(jobs1[0]) is None) != (s2.claim(jobs2[0]) is None)


def test_stability_gates(tmp_path, pkg):
    """A growing file waits a full poll; a new segment resets a set's
    membership clock; a .complete marker bypasses both and is consumed;
    back-to-back scans prove nothing."""
    svc = _service(tmp_path, pkg, stable_polls=1, poll_interval_s=0.0)
    inbox = tmp_path / "inbox"
    f = inbox / "up.mp4"
    f.write_bytes(b"a" * 10)
    assert svc.scan() == []
    f.write_bytes(b"a" * 20)
    os.utime(f, (1, 1))
    assert svc.scan() == [] and [j.name for j in svc.scan()] == ["up.mp4"]
    f.unlink()
    (inbox / "x.record.00000").write_bytes(b"a")
    assert svc.scan() == [] and svc.scan() == [] and len(svc.scan()) == 1
    (inbox / "x.record.00001").write_bytes(b"b")
    assert svc.scan() == [] and svc.scan() == [] and len(svc.scan()) == 1
    slow = _service(tmp_path / "slow", pkg, stable_polls=3, poll_interval_s=60.0)
    sin = tmp_path / "slow" / "inbox"
    (sin / "z.record.00000").write_bytes(b"a")
    for _ in range(5):
        assert slow.scan() == []
    (sin / "z.record.complete").write_bytes(b"")
    jobs = slow.scan()
    assert len(jobs) == 1 and jobs[0].complete
    assert slow.claim(jobs[0]) is not None and not (sin / "z.record.complete").exists()


def test_recover_orphans_dead_worker_only(tmp_path, pkg):
    svc = _service(tmp_path, pkg)
    work = tmp_path / "inbox" / ".work"

    def claimed(name, host, pid):
        d = work / f"{name}.1.1"
        (d / "in").mkdir(parents=True)
        (d / "in" / name).write_bytes(b"x")
        (d / "job.json").write_text(json.dumps(
            {"name": name, "kind": "video", "members": [name], "host": host, "pid": pid}))
        return d

    claimed("dead.mp4", os.uname().nodename, _dead_pid())
    live = claimed("live.mp4", os.uname().nodename, os.getpid())
    far = claimed("far.mp4", "other-host", 1)
    assert svc.recover_orphans() == 1
    assert (tmp_path / "inbox" / "dead.mp4").exists()
    assert (live / "in" / "live.mp4").exists() and (far / "in" / "far.mp4").exists()
    old = time.time() - svc.cfg.orphan_grace_s - 10
    os.utime(far / "job.json", (old, old))
    assert svc.recover_orphans() == 1 and (tmp_path / "inbox" / "far.mp4").exists()


def test_journal_rotation_and_heartbeat(tmp_path, pkg):
    mod, _ = pkg
    svc = _service(tmp_path, pkg, journal_max_bytes=200, heartbeat_interval_s=0.05)
    for i in range(50):
        svc._journal({"ts": i, "job": "x", "ok": True})
    rotated = tmp_path / "out" / (mod.JOURNAL_NAME + ".1")
    live = tmp_path / "out" / mod.JOURNAL_NAME
    assert rotated.exists() and live.stat().st_size <= 300
    for p in (rotated, live):
        for line in p.read_text().splitlines():
            json.loads(line)
    job_dir = tmp_path / "inbox" / ".work" / "j"
    job_dir.mkdir(parents=True)
    meta = job_dir / "job.json"
    meta.write_text("{}")
    old = time.time() - 3600
    os.utime(meta, (old, old))
    stop = svc._start_heartbeat(str(job_dir))
    try:
        deadline = time.time() + 5.0
        while os.stat(meta).st_mtime < time.time() - 10 and time.time() < deadline:
            time.sleep(0.05)
        assert os.stat(meta).st_mtime > time.time() - 10
    finally:
        stop.set()


def test_http_status_endpoint(tmp_path, pkg):
    svc = _service(tmp_path, pkg, http_port=0)
    try:
        base = f"http://127.0.0.1:{svc.http_port}"
        assert urllib.request.urlopen(f"{base}/healthz").read() == b"ok\n"
        status = json.loads(urllib.request.urlopen(f"{base}/status").read())
        assert status["jobs_done"] == 0 and "uptime_s" in status
        metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "# TYPE vdt_jobs_done counter" in metrics and "vdt_busy 0" in metrics
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope")
    finally:
        svc.shutdown()
    stop_now = threading.Event()
    stop_now.set()
    assert _service(tmp_path / "stopped", pkg).run(stop_now) == 0


# -- jobs through the service ------------------------------------------------------------


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=8, confidence=0.01)


@pytest.fixture(scope="module")
def engines():
    """The JAX fused engine (random init, faces only) and the port's on the
    same weights, on the CPU."""
    jface = JaxRetinaface(dtype=jnp.float32, **FACE)
    tree = lambda v: jax.tree.map(np.asarray, dict(v))  # noqa: E731
    face = Retinaface(state_dict=from_jax_variables(tree(jface.variables)),
                      dtype=torch.float32, device="cpu", **FACE)
    return JaxEngine(jface, None), DesensitizationEngine(face, None)


def test_video_job_journal_equals_jax(native, tmp_path, engines):
    """One 6-frame video job through each service: the output decodes to 6
    frames, the input is archived, and the journal entry has the same keys
    and counts as the JAX service's."""
    entries = []
    for (name, pkg), engine in zip(PACKAGES.items(), engines[::-1]):
        root = tmp_path / name
        svc = _service(root, pkg, engine)
        _write_video(root / "inbox" / "cam.mp4")
        assert svc.run(max_jobs=1) == 1
        with av.VideoDecoder(str(root / "out" / "cam_processed.mp4")) as dec:
            assert sum(1 for _ in dec) == 6
        assert (root / "inbox" / ".done" / "cam.mp4").exists()
        lines = (root / "out" / service.JOURNAL_NAME).read_text().splitlines()
        assert len(lines) == 1
        entries.append(json.loads(lines[0]))
        assert svc.status["jobs_done"] == 1 and svc.status["frames"] == 6
    mine, theirs = entries
    assert sorted(mine) == sorted(theirs)
    drop = ("ts", "wall_s")
    assert {k: v for k, v in mine.items() if k not in drop} == {
        k: v for k, v in theirs.items() if k not in drop}
    assert mine["ok"] and mine["frames"] == 6 and mine["faces"] > 0


def test_record_job_and_failed_job(native, tmp_path, engines):
    """A record job through the port's service (repacked record with every
    message), then a broken video quarantined with its error beside a good
    one."""
    from video_desensitization_torch.record.proto import sensor_image_pb2 as sp
    from video_desensitization_torch.record.reader import RecordReader
    from video_desensitization_torch.record.topics import CAMERA_TOPICS, COMPRESSED_IMAGE_TYPE
    from video_desensitization_torch.record.writer import RecordWriter

    h265 = str(tmp_path / "src.h265")
    with av.VideoEncoder(h265, 64, 64, fps=30, codec="libx265", bitrate=200000,
                         preset="ultrafast") as e:
        for i in range(6):
            e.write(np.full((64, 64, 3), i * 30, np.uint8))
    with av.PacketDemuxer(h265) as dm:
        pkts = dm.read_packets()
    svc = _service(tmp_path, PACKAGES["port"], engines[1])
    topic = CAMERA_TOPICS[0]
    with RecordWriter(str(tmp_path / "inbox" / "drive.record")) as w:
        w.write_channel(topic, COMPRESSED_IMAGE_TYPE)
        for i, p in enumerate(pkts):
            img = sp.CompressedImage(format="h265", data=p.data)
            img.header.sequence_num = i
            w.write_message(topic, img, 10**9 + i * 33_000_000)
    assert svc.run(max_jobs=1) == 1
    out_rec = tmp_path / "out" / "drive.record" / "record" / "drive.record"
    assert len(list(RecordReader(str(out_rec)).read_messages(topic))) == len(pkts)
    assert (tmp_path / "inbox" / ".done" / "drive.record").exists()
    assert os.listdir(tmp_path / "inbox" / ".work") == []
    (tmp_path / "inbox" / "broken.mp4").write_bytes(b"not a video at all")
    _write_video(tmp_path / "inbox" / "good.mp4")
    assert svc.run(max_jobs=2) == 2
    assert (tmp_path / "inbox" / ".failed" / "broken.mp4.error.txt").exists()
    assert (tmp_path / "out" / "good_processed.mp4").exists()
    assert svc.status["jobs_failed"] == 1 and svc.status["jobs_done"] == 2


def test_serve_cli_end_to_end(native, tmp_path):
    """``python -m video_desensitization_torch.cli.serve`` with ``--device
    cpu``: config and flags, the engine built once, one job served."""
    ini = tmp_path / "config.ini"
    ini.write_text(
        "[PATHS]\nmodel_path=random\nmodel_weights=random\nrecord_dir=\n"
        "output_h265_dir=\noutput_videos_dir=\ntemp_directory_base=\nrecord_output_dir=\n"
        "[SETTINGS]\nbatch_size=4\n"
        "[TPU]\ninput_size=64\nmax_detections=8\ndtype=float32\nconfidence=0.01\noutput_fps=30\n"
        f"[SERVICE]\ninbox_dir={tmp_path / 'inbox'}\noutput_dir={tmp_path / 'out'}\n"
        "poll_interval=0.05\nstable_polls=0\n"
    )
    os.makedirs(tmp_path / "inbox")
    _write_video(tmp_path / "inbox" / "cam.mp4")
    assert serve_main([str(ini), "--no-plates", "--max-jobs", "1", "--device", "cpu"]) == 0
    assert (tmp_path / "out" / "cam_processed.mp4").exists()


def test_doctor_without_cuda(monkeypatch):
    """No CUDA device: reported absent, ``ok`` false with that reason, the
    codec and toolchain fields present, no crash; main returns 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = doctor.collect(probe_link=True)
    assert report["cuda_available"] is False and report["device_name"] is None
    assert report["ok"] is False and "no CUDA device" in report["reasons"]
    assert report["codec_path"] == av.codec_path() and report["link_h2d_gib_s"] is None
    assert set(report["codecs"]) == {"libx265", "libx264", "mpeg4", "mjpeg"}
    assert isinstance(report["native_lz4"], bool) and report["torch_version"] == torch.__version__
    if report["nvcc"] is None:
        assert report["mosaic_kernel"] is None and "nvcc" in report["mosaic_kernel_error"]
    assert doctor.main([]) == 1

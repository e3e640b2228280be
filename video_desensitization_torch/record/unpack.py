"""Record unpack: extract camera topics as .h265 elementary streams.

The reference's ``recordDeal.read_record2h265_all``: enumerate ``.record``
files (including multi-segment ``.record.0000N`` sets, in segment order),
stage a ``.tmp_record`` copy, iterate messages, gate each camera topic on
its first keyframe (``video_states`` / ``key_frame_written``), and write
per-topic Annex-B streams to ``<output_h265_dir>/hevcs/topic_<camera>.h265``.

Per-topic work is fanned out across writer threads *during* record
iteration: the reader thread parses protos and routes payloads through
bounded per-topic queues; each topic's thread gates on its first keyframe
and appends straight to its output file. Payloads stream to disk, so peak
RAM is bounded by queue depth, not record size.
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading
from typing import Dict, List, Sequence

from google.protobuf.message import DecodeError

from video_desensitization_torch.record.reader import RecordReader
from video_desensitization_torch.record.topics import (
    CAMERA_TOPICS,
    HEVC_SUBDIR,
    hevc_filename_for_topic,
)
from video_desensitization_torch.utils.logging import get_logger
from video_desensitization_torch.video.nal import is_hevc_keyframe

_DONE = object()


def get_tmp_record_path(record_path: str) -> str:
    """'Generate intermediate record file': <name>.tmp_record staging path."""
    if record_path.endswith(".record"):
        return record_path[: -len(".record")] + ".tmp_record"
    return record_path + ".tmp_record"


def _segment_sort_key(name: str):
    """Order multi-segment sets numerically: x.record.00002 < x.record.00010,
    and x.record.2 < x.record.10 even without zero padding."""
    m = re.match(r"^(.*\.record)\.(\d+)$", name)
    if m:
        return (m.group(1), 1, int(m.group(2)))
    return (name, 0, 0)


def _list_records(record_dir: str) -> List[str]:
    if os.path.isfile(record_dir):
        return [record_dir]
    names = [
        n
        for n in os.listdir(record_dir)
        if ".record" in n and not n.endswith(".tmp_record")
    ]
    return [os.path.join(record_dir, n) for n in sorted(names, key=_segment_sort_key)]


class _TopicSink:
    """Keyframe-gated streaming writer for one camera topic."""

    def __init__(self, topic: str, path: str, depth: int):
        self.topic = topic
        self.path = path
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.bytes_written = 0
        self.error = None
        self.key_frame_written = False

    def run(self, log):
        f = None
        try:
            while True:
                data = self.q.get()
                if data is _DONE:
                    return
                if not self.key_frame_written:
                    if not is_hevc_keyframe(data):
                        continue
                    self.key_frame_written = True
                if f is None:
                    f = open(self.path, "wb")
                f.write(data)
                self.bytes_written += len(data)
        except Exception as e:  # noqa: BLE001
            self.error = e
            log.error("Error processing topic %s is exception: %s", self.topic, e)
            while self.q.get() is not _DONE:  # drain; reader must not block
                pass
        finally:
            if f is not None:
                f.close()


def read_record2h265_all(
    record_dir: str,
    output_h265_dir: str,
    topics: Sequence[str] = CAMERA_TOPICS,
    use_tmp_copy: bool = True,
    queue_depth: int = 64,
) -> Dict[str, str]:
    """Extract every camera topic of every record to .h265 files.

    Returns {topic: h265_path} for topics that had data. Keyframe gating
    state spans segment boundaries (a topic whose keyframe arrived in
    segment 0 keeps appending through segment N).
    """
    log = get_logger("recordDeal")
    hevc_dir = os.path.join(output_h265_dir, HEVC_SUBDIR)
    os.makedirs(hevc_dir, exist_ok=True)
    records = _list_records(record_dir)
    if not records:
        log.warning("no .record files under %s", record_dir)
        return {}

    sinks = {
        t: _TopicSink(
            t, os.path.join(hevc_dir, hevc_filename_for_topic(t)), queue_depth
        )
        for t in topics
    }
    threads = [
        threading.Thread(target=s.run, args=(log,), daemon=True)
        for s in sinks.values()
    ]
    log.info("Extract the camera topic from the record file as H265 file")
    log.info("Start concurrent record to video!")
    for t in threads:
        t.start()

    try:
        for record_path in records:
            work_path = record_path
            tmp_path = None
            if use_tmp_copy:
                tmp_path = get_tmp_record_path(record_path)
                log.info("Generate intermediate record file: %s", tmp_path)
                shutil.copyfile(record_path, tmp_path)
                work_path = tmp_path
            try:
                reader = RecordReader(work_path)
                for topic, msg, _t in reader.read_messages(list(topics)):
                    try:
                        data = bytes(msg.data)
                    except (AttributeError, DecodeError) as e:
                        log.error(
                            "The record %s data exception: %s", record_path, e
                        )
                        continue
                    sink = sinks[topic]
                    if sink.error is None:
                        sink.q.put(data)
            finally:
                if tmp_path and os.path.exists(tmp_path):
                    os.remove(tmp_path)
    finally:
        for s in sinks.values():
            s.q.put(_DONE)
        for t in threads:
            t.join()

    return {
        t: s.path
        for t, s in sinks.items()
        if s.bytes_written > 0 and s.error is None
    }

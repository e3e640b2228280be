"""Resident serving daemon: a watch-folder desensitization service.

The reference is a one-shot batch script (run.sh -> combine_detect.py
__main__, combine_detect.py:786-990): every run loads the models anew. This
service keeps one engine (its detectors on the card, the mosaic kernel
loaded) across jobs:

* **Inbox watching**: `.record` jobs (and `.record.0000N` segment sets,
  claimed as one unit) and plain video files dropped into ``inbox_dir`` are
  picked up. A file is claimed only once its (size, mtime) is unchanged
  across ``stable_polls`` spaced polls, so uploads in progress are never
  half-read; an uploader's ``<name>.complete`` marker makes that exact.
* **Atomic claims across workers**: a job is claimed by ``os.rename`` of its
  first member into a private work directory. rename(2) is atomic on a
  POSIX filesystem, so several service processes (one per GPU host) can
  share one inbox; exactly one wins each job.
* **Journal and status**: every finished job appends one JSON line to
  ``service_journal.jsonl``; a stdlib HTTP endpoint (``/healthz``,
  ``/status``, ``/metrics``) exposes live counters.
* **Crash recovery**: work directories left by a dead worker are re-queued
  at startup by ``recover_orphans``.

Jobs run through the same ``process_record_job`` / ``process_single_video``
as the one-shot CLI (``pipeline/video_pipeline.py``), with the engine the
service was given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

from video_desensitization_torch.api.config import PipelineConfig
from video_desensitization_torch.pipeline.video_pipeline import (
    process_record_job,
    process_single_video,
)
from video_desensitization_torch.utils.logging import get_logger

# Any numeric suffix counts as a segment — aligned with the record layer's
# segment parsing (record.unpack._segment_sort_key accepts unpadded indexes
# like x.record.2 as well as Apollo's zero-padded x.record.00002).
_SEGMENT_RE = re.compile(r"^(?P<base>.+\.record)\.(?P<seg>\d+)$")

JOURNAL_NAME = "service_journal.jsonl"


@dataclasses.dataclass
class ServiceConfig:
    inbox_dir: str
    output_dir: str
    work_dir: str = ""  # default: <inbox>/.work (MUST share the inbox's fs)
    done_dir: str = ""  # default: <inbox>/.done ("" + delete_inputs -> remove)
    failed_dir: str = ""  # default: <inbox>/.failed
    poll_interval_s: float = 2.0
    # Extra unchanged polls required before claiming. ``stable_polls=0`` is an
    # explicit opt-out: files are claimed ON FIRST SIGHT with no
    # unchanged-interval evidence at all, so in-progress uploads can be
    # half-read. Use 0 only when every uploader writes `<name>.complete`
    # markers (which carry an exact completeness signal) or uploads are
    # rename-atomic; the service logs a warning at startup.
    stable_polls: int = 1
    delete_inputs: bool = False  # remove inputs after success instead of .done
    http_port: Optional[int] = None  # None = no HTTP endpoint; 0 = ephemeral
    http_host: str = "127.0.0.1"  # bind 0.0.0.0 for external LB health probes
    # Work dirs whose job.json heartbeat is older than this are presumed
    # abandoned and re-queued (in addition to same-host dead-pid detection).
    # run_job touches job.json every ``heartbeat_interval_s`` while the job
    # runs, so this only needs to exceed the longest plausible heartbeat GAP
    # (worker paused/swapped), not the longest job.
    orphan_grace_s: float = 6 * 3600.0
    heartbeat_interval_s: float = 30.0
    # Rotate service_journal.jsonl once it exceeds this many bytes (one
    # .1 generation is kept). 0 disables rotation.
    journal_max_bytes: int = 64 * 1024 * 1024
    # Use the link(2)-count lock idiom instead of O_CREAT|O_EXCL for the
    # segment-set claim lock. O_EXCL is exact on local filesystems and NFSv4
    # but only emulated on NFSv3; hard-link counts are exact there too.
    nfs_safe_locks: bool = False

    def __post_init__(self):
        self.work_dir = self.work_dir or os.path.join(self.inbox_dir, ".work")
        self.done_dir = self.done_dir or os.path.join(self.inbox_dir, ".done")
        self.failed_dir = self.failed_dir or os.path.join(self.inbox_dir, ".failed")


def load_service_config(
    path: str,
    inbox_dir: Optional[str] = None,
    output_dir: Optional[str] = None,
) -> ServiceConfig:
    """Read the optional [SERVICE] section of a config.ini.

    ``inbox_dir`` / ``output_dir`` override the file's values BEFORE the
    ServiceConfig is constructed, so the derived work/done/failed dirs (set
    in ``__post_init__`` from inbox_dir) follow the override — mutating the
    dataclass after construction would leave them pointing at the old tree.
    """
    import configparser

    parser = configparser.ConfigParser()
    if not parser.read(path, encoding="utf-8"):
        raise FileNotFoundError(f"config file not found: {path}")
    if "SERVICE" not in parser:
        raise ValueError(
            "config has no [SERVICE] section (keys: inbox_dir, output_dir, "
            "poll_interval, stable_polls, http_port, delete_inputs)"
        )
    s = parser["SERVICE"]
    if not (inbox_dir or "inbox_dir" in s) or not (output_dir or "output_dir" in s):
        raise ValueError("[SERVICE] requires inbox_dir and output_dir")
    port = s.get("http_port", "").strip()
    return ServiceConfig(
        inbox_dir=inbox_dir or s.get("inbox_dir").strip(),
        output_dir=output_dir or s.get("output_dir").strip(),
        work_dir=s.get("work_dir", "").strip(),
        done_dir=s.get("done_dir", "").strip(),
        failed_dir=s.get("failed_dir", "").strip(),
        poll_interval_s=s.getfloat("poll_interval", 2.0),
        stable_polls=s.getint("stable_polls", 1),
        delete_inputs=s.getboolean("delete_inputs", False),
        http_port=int(port) if port else None,
        http_host=s.get("http_host", "127.0.0.1").strip(),
        orphan_grace_s=s.getfloat("orphan_grace_s", 6 * 3600.0),
        heartbeat_interval_s=s.getfloat(
            "heartbeat_interval_s", s.getfloat("heartbeat_interval", 30.0)
        ),
        journal_max_bytes=s.getint("journal_max_bytes", 64 * 1024 * 1024),
        nfs_safe_locks=s.getboolean("nfs_safe_locks", False),
    )


@dataclasses.dataclass
class Job:
    """One claimable unit of work: a record (+segments) or a single video."""

    name: str  # display/job-dir name, e.g. "drive01.record" or "cam.mp4"
    kind: str  # "record" | "video"
    members: List[str]  # file names inside the inbox, sorted; [0] is the lock
    complete: bool = False  # "<name>.complete" marker present in the inbox


def group_inbox(names: List[str], video_formats: List[str]) -> List[Job]:
    """Group a directory listing into claimable jobs.

    ``a.record`` → one record job; ``a.record.00000`` + ``a.record.00001`` →
    one record job with both segments; ``cam.mp4`` → one video job. Unknown
    extensions are ignored (they stay in the inbox untouched).

    A ``<name>.complete`` marker file (written by the uploader LAST) makes
    the upload-completeness signal exact: the job bypasses the
    stability-window heuristics and is claimable on the next scan. The
    marker is consumed with the claim.
    """
    segments: Dict[str, List[str]] = {}
    jobs: List[Job] = []
    markers = {n[: -len(".complete")] for n in names if n.endswith(".complete")}
    for n in sorted(names):
        if n.startswith(".") or n.endswith(".complete"):
            continue
        m = _SEGMENT_RE.match(n)
        if m:
            segments.setdefault(m.group("base"), []).append(n)
        elif n.endswith(".record"):
            segments.setdefault(n, []).append(n)
        else:
            ext = os.path.splitext(n)[1].lower().lstrip(".")
            if ext in video_formats:
                jobs.append(
                    Job(name=n, kind="video", members=[n], complete=n in markers)
                )
    for base, members in sorted(segments.items()):
        jobs.append(
            Job(
                name=base,
                kind="record",
                members=sorted(members),
                complete=base in markers,
            )
        )
    return jobs


class DesensitizationService:
    """Long-running watch-folder service around a resident engine."""

    def __init__(
        self,
        service_cfg: ServiceConfig,
        pipeline_cfg: PipelineConfig,
        engine,
    ):
        self.cfg = service_cfg
        self.pcfg = pipeline_cfg
        self.engine = engine
        self.log = get_logger("service")
        self._stat_history: Dict[str, Tuple[int, float, int, float]] = {}
        self._set_history: Dict[str, Tuple[Tuple[str, ...], int, float]] = {}
        self._lock = threading.Lock()
        self.status = {
            "started_ts": time.time(),
            "jobs_done": 0,
            "jobs_failed": 0,
            "frames": 0,
            "faces": 0,
            "plates": 0,
            "current": None,
            "last_error": None,
        }
        for d in (
            self.cfg.inbox_dir,
            self.cfg.output_dir,
            self.cfg.work_dir,
            self.cfg.failed_dir,
        ):
            os.makedirs(d, exist_ok=True)
        if not self.cfg.delete_inputs:
            os.makedirs(self.cfg.done_dir, exist_ok=True)
        # Claiming relies on rename(2) atomicity, which requires the work dir
        # on the SAME filesystem as the inbox — fail loudly at startup rather
        # than EXDEV-crash on the first job.
        if os.stat(self.cfg.inbox_dir).st_dev != os.stat(self.cfg.work_dir).st_dev:
            raise ValueError(
                f"work_dir {self.cfg.work_dir!r} is on a different filesystem "
                f"than inbox_dir {self.cfg.inbox_dir!r}; atomic claims need "
                "them co-located (done/failed dirs may live anywhere)"
            )
        if self.cfg.stable_polls <= 0:
            self.log.warning(
                "stable_polls=0: files are claimed on first sight with NO "
                "upload protection — use only with .complete markers or "
                "rename-atomic uploads"
            )
        self.journal_path = os.path.join(self.cfg.output_dir, JOURNAL_NAME)
        self._httpd = None
        self.http_port: Optional[int] = None
        if self.cfg.http_port is not None:
            self._start_http(self.cfg.http_port)

    # -- inbox scanning ----------------------------------------------------

    def _stable(self, path: str) -> bool:
        """True once (size, mtime) has survived ``stable_polls`` extra polls.

        Observations closer together than half a poll interval don't count —
        the run loop rescans immediately after claiming a job, and two stats
        microseconds apart prove nothing about an in-progress upload.
        """
        try:
            st = os.stat(path)
        except OSError:
            return False
        now = time.monotonic()
        sig = (st.st_size, st.st_mtime)
        prev = self._stat_history.get(path)
        if prev is None or (prev[0], prev[1]) != sig:
            self._stat_history[path] = (*sig, 0, now)
            return 0 >= self.cfg.stable_polls
        size, mtime, count, last_ts = prev
        if now - last_ts >= 0.5 * self.cfg.poll_interval_s:
            count += 1
            self._stat_history[path] = (size, mtime, count, now)
        return count >= self.cfg.stable_polls

    def _set_stable(self, job: Job) -> bool:
        """For record jobs, the MEMBERSHIP itself must also be stable: a
        segment set is only claimable once no new segment has appeared for
        ``stable_polls`` spaced polls — an uploader mid-way through writing
        ``x.record.00001`` must not have ``x.record.00000`` claimed alone
        (which is why this gate applies even to a currently-single-member
        set: more segments may still be coming)."""
        if job.kind != "record":
            return True
        now = time.monotonic()
        sig = tuple(job.members)
        prev = self._set_history.get(job.name)
        if prev is None or prev[0] != sig:
            self._set_history[job.name] = (sig, 0, now)
            return 0 >= self.cfg.stable_polls
        _, count, last_ts = prev
        if now - last_ts >= 0.5 * self.cfg.poll_interval_s:
            count += 1
            self._set_history[job.name] = (sig, count, now)
        return count >= self.cfg.stable_polls

    def scan(self) -> List[Job]:
        try:
            names = os.listdir(self.cfg.inbox_dir)
        except OSError as e:
            self.log.error("inbox unreadable: %s", e)
            return []
        jobs = group_inbox(names, self.pcfg.video_formats)
        # Garbage-collect orphaned .complete markers (their files were
        # claimed in a race window, or the base never existed): a stale
        # marker would bypass the stability gate for a future same-named
        # upload. The uploader protocol writes markers LAST, so a marker
        # without members after a grace period cannot be an early marker.
        job_names = {j.name for j in jobs}
        for n in names:
            if not n.endswith(".complete") or n[: -len(".complete")] in job_names:
                continue
            path = os.path.join(self.cfg.inbox_dir, n)
            try:
                if time.time() - os.stat(path).st_mtime > max(
                    60.0, 4 * self.cfg.poll_interval_s
                ):
                    os.unlink(path)
                    self.log.warning("removed orphaned marker %s", n)
            except OSError:
                pass
        live = {os.path.join(self.cfg.inbox_dir, n) for j in jobs for n in j.members}
        for stale in [p for p in self._stat_history if p not in live]:
            del self._stat_history[stale]
        for stale in [n for n in self._set_history if n not in {j.name for j in jobs}]:
            del self._set_history[stale]
        return [
            j
            for j in jobs
            if j.complete  # explicit uploader marker: claim now
            or (
                all(
                    self._stable(os.path.join(self.cfg.inbox_dir, n))
                    for n in j.members
                )
                and self._set_stable(j)
            )
        ]

    # -- claiming ----------------------------------------------------------

    def _maybe_break_stale_lock(self, lock_path: str) -> None:
        """Break a held set lock ONLY when its owner is provably gone.

        A lock records ``host:pid``. Same host: the pid is probed directly —
        a live owner's lock is never broken, no matter its age (a worker
        stalled >60 s mid-claim must not have its set stolen and split).
        A provably-dead same-host owner has its partial claim recovered
        (recover_orphans re-queues the already-moved segments) BEFORE the
        lock is unlinked, so the reassembled set is claimed whole, never as
        two partial jobs. Foreign hosts can't be probed; their locks age out
        on the ``orphan_grace_s`` scale — the same horizon on which their
        partial work dir becomes recoverable.
        """
        try:
            st = os.stat(lock_path)
            with open(lock_path) as f:
                content = f.read().strip()
        except OSError:
            return  # released (or unreadable) meanwhile; next scan retries
        age = time.time() - st.st_mtime
        host, _, pid = content.partition(":")
        if host == os.uname().nodename and pid.isdigit():
            try:
                os.kill(int(pid), 0)
                return  # owner alive -> lock is honest, keep it
            except ProcessLookupError:
                pass  # provably dead -> break below
            except OSError:
                return  # can't probe (permissions oddity): keep
            if age < max(5.0, 2 * self.cfg.poll_interval_s):
                return  # dodge mid-write/pid-reuse races on brand-new locks
            self.recover_orphans()  # reassemble the dead owner's partial set
        elif age <= max(60.0, self.cfg.orphan_grace_s):
            return  # unparsable or foreign owner: only break on grace scale
        try:
            os.unlink(lock_path)
            self.log.warning("broke stale claim lock %s", os.path.basename(lock_path))
        except OSError:
            pass

    def _acquire_set_lock(self, job: Job) -> Optional[str]:
        """Exclusive inbox-level lock for multi-member (segment-set) claims.

        Renaming members one by one is atomic per file but not per SET:
        another worker's scan could land between two renames, see only the
        not-yet-moved segments, and claim them as a separate job. A lock file
        serializes set claims (O_CREAT|O_EXCL by default; the link(2)-count
        idiom under ``nfs_safe_locks`` where NFSv3's emulated O_EXCL isn't
        trustworthy); stale locks are broken only when the owner is provably
        dead (same-host pid probe, after recovering its partial claim) or,
        for unprobeable foreign hosts, aged past ``orphan_grace_s``.
        """
        lock_path = os.path.join(self.cfg.inbox_dir, f".claim.{job.name}.lock")
        ident = f"{os.uname().nodename}:{os.getpid()}\n"
        if self.cfg.nfs_safe_locks:
            # link(2) idiom: write a unique temp file, hard-link it to the
            # lock name, then verify st_nlink == 2 on the temp — exact even
            # when an NFSv3 server's reply to link() is lost.
            tmp_path = f"{lock_path}.{os.uname().nodename}.{os.getpid()}"
            try:
                with open(tmp_path, "w") as f:
                    f.write(ident)
                try:
                    os.link(tmp_path, lock_path)
                except OSError:
                    pass  # verdict comes from the nlink count below
                won = os.stat(tmp_path).st_nlink == 2
            except OSError:
                # Can't stat the temp (transient NFS error) — but the link
                # may have SUCCEEDED, leaving a lock bearing this live pid
                # that nobody would ever break (we'd probe ourselves alive).
                # Disambiguate by reading the lock itself: our ident means
                # we won.
                try:
                    with open(lock_path) as f:
                        won = f.read() == ident
                except OSError:
                    won = False
            finally:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
            if not won:
                self._maybe_break_stale_lock(lock_path)
                return None
            return lock_path
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self._maybe_break_stale_lock(lock_path)
            return None
        with os.fdopen(fd, "w") as f:
            f.write(ident)
        return lock_path

    def claim(self, job: Job) -> Optional[str]:
        """Atomically claim a job; returns its private work dir or None if
        another worker won the race (or members vanished)."""
        import tempfile

        # mkdtemp (atomic mkdir, even over NFS) guarantees a worker-unique
        # work dir: name.pid.seq schemes collide when two HOSTS sharing the
        # work dir reuse a pid number, and a loser's cleanup rmtree would
        # then delete the winner's claimed inputs.
        try:
            job_dir = tempfile.mkdtemp(
                prefix=f"{job.name}.{os.getpid()}.", dir=self.cfg.work_dir
            )
        except OSError as e:
            self.log.error("cannot create work dir for %s: %s", job.name, e)
            return None
        lock_path = None
        try:
            if job.kind == "record":
                # EVERY record claim takes the set lock, not just currently-
                # multi-member ones: a scan that lands mid-claim can see a
                # partial set as a single-member (or marker-completed) job
                # and would otherwise steal the not-yet-moved segments.
                lock_path = self._acquire_set_lock(job)
                if lock_path is None:
                    # Remove the just-made (still empty) work dir: a losing
                    # claim every poll against a long-held lock would
                    # otherwise leak one dir per attempt, and
                    # recover_orphans skips dirs without in/.
                    shutil.rmtree(job_dir, ignore_errors=True)
                    return None
            os.makedirs(os.path.join(job_dir, "in"), exist_ok=True)
            lock_member = job.members[0]
            try:
                os.rename(
                    os.path.join(self.cfg.inbox_dir, lock_member),
                    os.path.join(job_dir, "in", lock_member),
                )
            except FileNotFoundError:  # another worker won the race
                shutil.rmtree(job_dir, ignore_errors=True)
                return None
            # We own the job now: every other worker lost the rename race on
            # the first member (single files) or the set lock (segment sets).
            for n in job.members[1:]:
                try:
                    os.rename(
                        os.path.join(self.cfg.inbox_dir, n),
                        os.path.join(job_dir, "in", n),
                    )
                except FileNotFoundError:
                    self.log.warning(
                        "segment %s vanished while claiming %s", n, job.name
                    )
            with open(os.path.join(job_dir, "job.json"), "w") as f:
                json.dump(
                    {
                        "name": job.name,
                        "kind": job.kind,
                        "members": job.members,
                        "host": os.uname().nodename,
                        "pid": os.getpid(),
                    },
                    f,
                )
        except OSError as e:  # disk full, permissions, ... — skip, don't die
            self.log.error("claim of %s failed: %s", job.name, e)
            shutil.rmtree(job_dir, ignore_errors=True)
            return None
        finally:
            if lock_path is not None:
                try:
                    os.unlink(lock_path)
                except OSError:
                    pass
        # Consume the uploader's marker with the claim — unconditionally, so
        # a marker that landed between scan() and claim() cannot linger and
        # defeat the stability gate for a future same-named upload.
        try:
            os.unlink(os.path.join(self.cfg.inbox_dir, f"{job.name}.complete"))
        except OSError:
            pass
        return job_dir

    def _owner_alive(self, job_dir: str) -> bool:
        """Best-effort liveness of the worker that claimed ``job_dir``.

        Same host: the recorded pid is probed directly. Other hosts (shared
        inbox over NFS): liveness can't be probed, so the claim is presumed
        live until it is older than ``orphan_grace_s``.
        """
        meta_path = os.path.join(job_dir, "job.json")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            age = time.time() - os.stat(meta_path).st_mtime
        except (OSError, ValueError):
            # No metadata: the claimer died mid-claim. A live claimer writes
            # job.json within milliseconds, so only a brand-new dir is
            # ambiguous.
            try:
                age = time.time() - os.stat(job_dir).st_mtime
            except OSError:
                return False
            return age < max(10.0, 2 * self.cfg.poll_interval_s)
        if meta.get("host") == os.uname().nodename and meta.get("pid"):
            if meta["pid"] == os.getpid():
                return True
            try:
                os.kill(int(meta["pid"]), 0)
                return True  # process exists -> in flight
            except ProcessLookupError:
                return False
            except (OSError, ValueError):
                pass  # permission/parse oddity: fall back to the age rule
        return age < self.cfg.orphan_grace_s

    def recover_orphans(self) -> int:
        """Re-queue inputs from work dirs abandoned by a DEAD worker.

        Work dirs whose claiming process is still alive (same-host pid
        probe) or younger than ``orphan_grace_s`` (foreign hosts on a shared
        inbox) are left alone — stealing an in-flight job would double-
        process it and crash the original worker's finalize.
        """
        n = 0
        for d in sorted(os.listdir(self.cfg.work_dir)):
            job_dir = os.path.join(self.cfg.work_dir, d)
            in_dir = os.path.join(job_dir, "in")
            if not os.path.isdir(in_dir):
                continue
            if self._owner_alive(job_dir):
                self.log.info("leaving in-flight work dir %s alone", d)
                continue
            try:
                for f in os.listdir(in_dir):
                    os.rename(
                        os.path.join(in_dir, f),
                        os.path.join(self.cfg.inbox_dir, f),
                    )
                    n += 1
                shutil.rmtree(job_dir, ignore_errors=True)
            except OSError as e:
                self.log.error("could not recover %s: %s", d, e)
        if n:
            self.log.info("recovered %d orphaned input file(s) back to inbox", n)
        return n

    # -- processing --------------------------------------------------------

    def _process(self, job: Job, job_dir: str) -> dict:
        in_dir = os.path.join(job_dir, "in")
        if job.kind == "record":
            out_base = os.path.join(self.cfg.output_dir, job.name)
            cfg = dataclasses.replace(
                self.pcfg,
                record_dir=in_dir,
                output_h265_dir=os.path.join(job_dir, "h265"),
                output_videos_dir=os.path.join(out_base, "videos"),
                temp_directory_base=os.path.join(job_dir, "tmp"),
                record_output_dir=os.path.join(out_base, "record"),
            )
            stats = process_record_job(cfg, self.engine)
            if stats.videos_failed:
                raise RuntimeError(
                    f"{stats.videos_failed} stream(s) failed in {job.name}"
                )
            return {
                "frames": stats.frames,
                "faces": stats.faces,
                "plates": stats.plates,
                "videos": stats.videos_processed,
                "record": stats.record_path,
            }
        res = process_single_video(
            os.path.join(in_dir, job.members[0]),
            self.cfg.output_dir,
            self.engine,
            batch_size=self.pcfg.batch_size,
            output_fps=self.pcfg.output_fps,
            encode_kwargs=self.pcfg.encode_kwargs,
            transport=self.pcfg.transfer,
        )
        if not res.success:
            raise RuntimeError(f"video pipeline failed for {job.name}")
        return {"frames": res.frames, "faces": res.faces, "plates": res.plates}

    def _journal(self, entry: dict) -> None:
        if self.cfg.journal_max_bytes > 0:
            try:
                if os.path.getsize(self.journal_path) > self.cfg.journal_max_bytes:
                    os.replace(self.journal_path, self.journal_path + ".1")
                    self.log.info("rotated %s", JOURNAL_NAME)
            except OSError:
                pass  # absent journal / transient stat failure: just append
        with open(self.journal_path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def _start_heartbeat(self, job_dir: str) -> threading.Event:
        """Touch job.json periodically while a job runs, so foreign workers'
        ``_owner_alive`` age check reflects liveness rather than claim time —
        a legitimately-long job is never mistaken for an orphan."""
        stop = threading.Event()
        meta_path = os.path.join(job_dir, "job.json")
        interval = max(1.0, self.cfg.heartbeat_interval_s)

        def beat():
            while not stop.wait(interval):
                try:
                    os.utime(meta_path)
                except FileNotFoundError:
                    return  # job dir gone (finalized): nothing left to prove
                except OSError:
                    # Transient fs error (NFS ESTALE/EIO): keep beating — a
                    # dead heartbeat would age job.json until a foreign
                    # worker steals the in-flight job.
                    continue
        threading.Thread(target=beat, name="vdt-heartbeat", daemon=True).start()
        return stop

    def _finalize(self, job: Job, job_dir: str, ok: bool, error: str = "") -> None:
        in_dir = os.path.join(job_dir, "in")
        if ok and self.cfg.delete_inputs:
            pass  # inputs removed with the work dir below
        else:
            dest = self.cfg.done_dir if ok else self.cfg.failed_dir
            os.makedirs(dest, exist_ok=True)
            for f in os.listdir(in_dir):
                target = os.path.join(dest, f)
                suffix = 0
                while os.path.exists(target):  # never clobber an archive
                    suffix += 1
                    target = os.path.join(dest, f"{f}.{int(time.time())}.{suffix}")
                # shutil.move: done/failed dirs may be on another filesystem.
                shutil.move(os.path.join(in_dir, f), target)
            if not ok and error:
                with open(os.path.join(dest, f"{job.name}.error.txt"), "w") as f:
                    f.write(error)
        shutil.rmtree(job_dir, ignore_errors=True)

    def run_job(self, job: Job, job_dir: str) -> bool:
        t0 = time.time()
        with self._lock:
            self.status["current"] = job.name
        heartbeat = self._start_heartbeat(job_dir)
        try:
            stats = self._process(job, job_dir)
        except Exception as e:  # noqa: BLE001 — service must outlive any job
            heartbeat.set()
            self.log.error("job %s FAILED: %s", job.name, e)
            try:
                self._finalize(job, job_dir, ok=False, error=str(e))
            except OSError as fe:
                self.log.error("finalize of failed %s also failed: %s", job.name, fe)
            with self._lock:
                self.status["jobs_failed"] += 1
                self.status["last_error"] = f"{job.name}: {e}"
                self.status["current"] = None
            self._journal(
                {
                    "ts": time.time(),
                    "job": job.name,
                    "kind": job.kind,
                    "ok": False,
                    "error": str(e),
                    "wall_s": round(time.time() - t0, 3),
                }
            )
            return False
        heartbeat.set()
        try:
            self._finalize(job, job_dir, ok=True)
        except OSError as fe:
            # Output exists and the journal will say so; the stuck input is
            # recovered (or re-archived) on a later startup.
            self.log.error("finalize of %s failed: %s", job.name, fe)
        with self._lock:
            self.status["jobs_done"] += 1
            self.status["frames"] += stats.get("frames", 0)
            self.status["faces"] += stats.get("faces", 0)
            self.status["plates"] += stats.get("plates", 0)
            self.status["current"] = None
        self._journal(
            {
                "ts": time.time(),
                "job": job.name,
                "kind": job.kind,
                "ok": True,
                **stats,
                "wall_s": round(time.time() - t0, 3),
            }
        )
        self.log.info(
            "job %s done in %.1fs (%s)", job.name, time.time() - t0, stats
        )
        return True

    def run(
        self, stop: Optional[threading.Event] = None, max_jobs: Optional[int] = None
    ) -> int:
        """Serve until ``stop`` is set (or ``max_jobs`` jobs finished).

        Returns the number of jobs handled. The current job always runs to
        completion — ``stop`` is only checked between jobs, so SIGTERM drains
        gracefully.
        """
        stop = stop or threading.Event()
        if max_jobs is not None and max_jobs <= 0:
            self.shutdown()
            return 0
        self.recover_orphans()
        handled = 0
        self.log.info(
            "serving: inbox=%s output=%s%s",
            self.cfg.inbox_dir,
            self.cfg.output_dir,
            f" http=:{self.http_port}" if self.http_port is not None else "",
        )
        while not stop.is_set():
            claimed_any = False
            for job in self.scan():
                if stop.is_set():
                    break
                job_dir = self.claim(job)
                if job_dir is None:
                    continue
                claimed_any = True
                self.run_job(job, job_dir)
                handled += 1
                if max_jobs is not None and handled >= max_jobs:
                    self.shutdown()
                    return handled
            if not claimed_any:
                stop.wait(self.cfg.poll_interval_s)
        self.shutdown()
        return handled

    # -- HTTP status endpoint ---------------------------------------------

    def _start_http(self, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        service = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib naming
                if self.path == "/healthz":
                    body = b"ok\n"
                elif self.path == "/status":
                    with service._lock:
                        snap = dict(service.status)
                    snap["uptime_s"] = round(time.time() - snap["started_ts"], 1)
                    body = (json.dumps(snap) + "\n").encode()
                elif self.path == "/metrics":
                    # Prometheus text exposition format, scrape-ready.
                    with service._lock:
                        snap = dict(service.status)
                    lines = []
                    for key, mtype in (
                        ("jobs_done", "counter"),
                        ("jobs_failed", "counter"),
                        ("frames", "counter"),
                        ("faces", "counter"),
                        ("plates", "counter"),
                    ):
                        lines.append(f"# TYPE vdt_{key} {mtype}")
                        lines.append(f"vdt_{key} {snap[key]}")
                    lines.append("# TYPE vdt_uptime_seconds gauge")
                    lines.append(
                        f"vdt_uptime_seconds "
                        f"{time.time() - snap['started_ts']:.1f}"
                    )
                    lines.append("# TYPE vdt_busy gauge")
                    lines.append(f"vdt_busy {int(snap['current'] is not None)}")
                    body = ("\n".join(lines) + "\n").encode()
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/json" if self.path == "/status" else "text/plain",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((self.cfg.http_host, port), Handler)
        self.http_port = self._httpd.server_address[1]
        threading.Thread(
            target=self._httpd.serve_forever, name="vdt-http", daemon=True
        ).start()

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

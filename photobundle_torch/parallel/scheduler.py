"""Elastic work scheduling for multi-sequence / multi-window refinement.

The port's copy of photobundle_tpu/parallel/scheduler.py (host-only
Python, no device code): the port imports nothing of the JAX package.

SURVEY.md sections 2b and 5.3: the DP axis of this workload is independent
refinement jobs (sequence segments); "elastic window scheduling" means jobs
are rebalanced across the surviving workers when membership changes. The
reference is a single process with no counterpart — this is a build-phase
first-class component.

Design: lease-based work claiming over a shared directory (works for
multi-process on one machine and across hosts on shared storage; no extra
services). Each unit is claimed by atomically creating `unit_<k>.lease`
(O_EXCL). Workers renew their lease mtime as a heartbeat; a lease older
than `lease_timeout_s` is presumed dead and may be *stolen* (atomic rename
to a steal-marker, then re-create). A `unit_<k>.done` marker makes
completion idempotent — a unit is never reported complete twice, and a
re-run of a completed unit is harmless (refinement is deterministic).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Iterator, List, Optional


@dataclass(frozen=True)
class WorkUnit:
    """One refinement job: a contiguous frame range of one sequence."""

    uid: int
    sequence: int
    first_frame: int = 0
    num_frames: int = -1

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def from_json(s: str) -> "WorkUnit":
        return WorkUnit(**json.loads(s))


def make_units(sequences: List[int], frames_per_unit: int = -1,
               sequence_lengths: Optional[dict] = None,
               min_frames: int = 0) -> List[WorkUnit]:
    """Split sequences into work units. frames_per_unit < 0 -> one unit per
    sequence; otherwise each sequence is chunked (chunks overlap by one
    window is NOT needed — each chunk re-bootstraps its own window).

    min_frames: a tail chunk shorter than this (e.g. the sliding window
    size — it could never fill a window, so its frames would go unrefined)
    is folded into the preceding chunk instead of becoming its own unit.
    """
    units = []
    uid = 0
    for s in sequences:
        if frames_per_unit < 0 or sequence_lengths is None:
            units.append(WorkUnit(uid=uid, sequence=s))
            uid += 1
            continue
        n = sequence_lengths[s]
        start = 0
        while start < n:
            cnt = min(frames_per_unit, n - start)
            left_over = n - start - cnt
            if 0 < left_over < min_frames:
                cnt = n - start  # absorb the too-short tail
            units.append(WorkUnit(uid=uid, sequence=s, first_frame=start,
                                  num_frames=cnt))
            uid += 1
            start += cnt
    return units


class LeaseScheduler:
    """Directory-backed elastic scheduler (see module docstring).

    Usage (each worker):
        sched = LeaseScheduler(dir, worker_id="host3")
        sched.publish(units)          # idempotent; first writer wins
        for unit in sched.claims():   # iterate until no work remains
            ... refine ...            # call sched.heartbeat() periodically
            sched.complete(unit)
    """

    def __init__(self, root: str, worker_id: str,
                 lease_timeout_s: float = 120.0,
                 auto_heartbeat: bool = True):
        self.root = root
        self.worker_id = worker_id
        self.lease_timeout_s = lease_timeout_s
        self._current: Optional[WorkUnit] = None
        # Heartbeat runs on a timer THREAD, not on work-completion
        # callbacks: the first window of a unit includes kernel builds and
        # graph captures that can far exceed the lease timeout, and a
        # per-window callback would let a live worker's unit be stolen
        # mid-build (two workers then rewrite the same outputs
        # concurrently).
        self._auto_heartbeat = auto_heartbeat
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -------------------------------------------------- manifest
    def publish(self, units: List[WorkUnit]) -> None:
        path = os.path.join(self.root, "units.json")
        if os.path.exists(path):
            return
        tmp = path + f".tmp.{self.worker_id}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump([asdict(u) for u in units], f)
        try:
            os.rename(tmp, path)  # atomic; last writer wins with same content
        except OSError:
            os.remove(tmp)

    def units(self) -> List[WorkUnit]:
        with open(os.path.join(self.root, "units.json")) as f:
            return [WorkUnit(**d) for d in json.load(f)]

    # -------------------------------------------------- lease primitives
    def _lease_path(self, uid: int) -> str:
        return os.path.join(self.root, f"unit_{uid:05d}.lease")

    def _done_path(self, uid: int) -> str:
        return os.path.join(self.root, f"unit_{uid:05d}.done")

    def _try_claim(self, unit: WorkUnit) -> bool:
        if os.path.exists(self._done_path(unit.uid)):
            return False
        lease = self._lease_path(unit.uid)
        try:
            fd = os.open(lease, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return self._try_steal(unit)
        with os.fdopen(fd, "w") as f:
            f.write(self.worker_id)
        return True

    def _try_steal(self, unit: WorkUnit) -> bool:
        """Steal a lease whose owner stopped heartbeating (elastic
        rebalancing on worker failure)."""
        lease = self._lease_path(unit.uid)
        try:
            age = time.time() - os.path.getmtime(lease)
        except OSError:
            return False  # completed or contended; move on
        if age < self.lease_timeout_s:
            return False
        # Atomic rename wins the race among stealers.
        marker = lease + f".steal.{self.worker_id}.{os.getpid()}"
        try:
            os.rename(lease, marker)
        except OSError:
            return False
        os.remove(marker)
        try:
            fd = os.open(lease, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            f.write(self.worker_id)
        return True

    # -------------------------------------------------- worker API
    def heartbeat(self) -> None:
        if self._current is not None:
            lease = self._lease_path(self._current.uid)
            try:
                os.utime(lease, None)
            except OSError:
                pass

    def _start_heartbeat(self) -> None:
        if not self._auto_heartbeat or self._hb_thread is not None:
            return
        stop = threading.Event()
        period = max(0.05, self.lease_timeout_s / 4.0)

        def loop():
            while not stop.wait(period):
                self.heartbeat()

        t = threading.Thread(target=loop, name="lease-heartbeat", daemon=True)
        t.start()
        self._hb_stop, self._hb_thread = stop, t

    def _stop_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_thread.join(timeout=5.0)
            self._hb_stop = self._hb_thread = None

    def complete(self, unit: WorkUnit) -> None:
        self._stop_heartbeat()
        with open(self._done_path(unit.uid), "w") as f:
            f.write(self.worker_id)
        try:
            os.remove(self._lease_path(unit.uid))
        except OSError:
            pass
        self._current = None

    def release(self, unit: WorkUnit) -> None:
        """Give a unit back (graceful shutdown) so others pick it up."""
        self._stop_heartbeat()
        try:
            os.remove(self._lease_path(unit.uid))
        except OSError:
            pass
        self._current = None

    def pending(self) -> List[WorkUnit]:
        return [u for u in self.units()
                if not os.path.exists(self._done_path(u.uid))]

    def claims(self) -> Iterator[WorkUnit]:
        """Yield units until every unit is done. Re-scans after each pass so
        stolen/released work is picked up (workers that join late or survive
        others' failures keep contributing)."""
        while True:
            progress = False
            pending = self.pending()
            if not pending:
                return
            for u in pending:
                if self._try_claim(u):
                    self._current = u
                    self._start_heartbeat()
                    progress = True
                    yield u
                    self._stop_heartbeat()
            if not progress:
                # Everything is leased by live workers; wait for completions
                # or lease expiries.
                remaining = self.pending()
                if not remaining:
                    return
                time.sleep(min(1.0, self.lease_timeout_s / 10.0))

"""Work-stealing scan queue for evaluation workers (a copy of
mvsformerplusplus_tpu/parallel/scheduler.py, with its claim-file names and
generations, so that workers of either package can share one queue
directory).

Workers share the output file system and nothing else: no coordinator, no
network. A claim is a GENERATION file `<task>.claim.g<N>` under
`<root>/.claims`, created with O_CREAT|O_EXCL; the owner of a task is
whoever holds the highest generation.

- Claiming an unclaimed task creates g0: exactly one creator wins.
- Stealing a stale claim (no heartbeat within `reclaim_stale_s`, no .done)
  creates g(N+1), again with O_EXCL, so two racing stealers never both win
  and a stolen claim cannot be taken back (generations only grow; nothing
  is renamed or deleted).
- Owners heartbeat their generation file (its mtime) between views.

A finished task writes `<task>.done`. With reclaim on, iteration polls
until every task is done, so a claim that goes stale after a worker passed
it is still picked up.

    q = WorkQueue(outdir, scan_names)
    for scan in q:          # the tasks this worker claimed
        process(scan)       # q.heartbeat(scan) inside long tasks
        q.mark_done(scan)
"""
from __future__ import annotations

import os
import re
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional

_GEN_RE = re.compile(r"\.claim\.g(\d+)$")


class WorkQueue:
    """Filesystem-atomic dynamic task queue (work stealing via claims)."""

    def __init__(self, root, tasks: Iterable[str],
                 worker: Optional[str] = None,
                 reclaim_stale_s: Optional[float] = None,
                 poll_s: float = 5.0):
        self.root = Path(root) / ".claims"
        self.root.mkdir(parents=True, exist_ok=True)
        self.tasks: List[str] = list(tasks)
        self.worker = worker or f"pid{os.getpid()}"
        self.reclaim_stale_s = reclaim_stale_s
        self.poll_s = poll_s
        self._mine: Dict[str, Path] = {}  # task -> our generation file

    def _done_path(self, task: str) -> Path:
        return self.root / f"{task}.done"

    def _gen_path(self, task: str, gen: int) -> Path:
        return self.root / f"{task}.claim.g{gen}"

    def _highest_gen(self, task: str) -> int:
        """-1 when unclaimed."""
        best = -1
        for p in self.root.glob(f"{task}.claim.g*"):
            m = _GEN_RE.search(p.name)
            if m:
                best = max(best, int(m.group(1)))
        return best

    def _create(self, task: str, gen: int) -> bool:
        path = self._gen_path(task, gen)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            f.write(self.worker)
        self._mine[task] = path
        return True

    def _try_claim(self, task: str) -> bool:
        if self._done_path(task).exists():
            return False
        gen = self._highest_gen(task)
        if gen < 0:
            return self._create(task, 0)
        if self.reclaim_stale_s is None:
            return False
        # crashed-worker recovery: the CURRENT generation's mtime (refreshed
        # by the owner's heartbeat) decides staleness; stealing creates the
        # next generation — O_EXCL picks exactly one winner, and a live
        # owner's fresh claim can never be removed (nothing is ever
        # renamed or deleted)
        try:
            age = time.time() - self._gen_path(task, gen).stat().st_mtime
        except FileNotFoundError:
            return self._try_claim(task)
        if age < self.reclaim_stale_s:
            return False
        return self._create(task, gen + 1)

    def __iter__(self) -> Iterator[str]:
        while True:
            for task in self.tasks:
                if self._try_claim(task):
                    yield task
            if self.reclaim_stale_s is None:
                return  # static semantics: one pass
            remaining = self.pending()
            if not remaining:
                return
            # some task is claimed-but-unfinished elsewhere: poll until it
            # completes or its claim goes stale enough to steal
            time.sleep(self.poll_s)

    def heartbeat(self, task: str) -> None:
        """Refresh the claim's liveness stamp. Owners of long-running tasks
        call this periodically (e.g. once per view) so `reclaim_stale_s` can
        be set well below a scene's total runtime without healthy tasks
        getting stolen."""
        path = self._mine.get(task)
        if path is None:
            return
        try:
            os.utime(path)
        except FileNotFoundError:
            pass

    def mark_done(self, task: str) -> None:
        self._done_path(task).write_text(self.worker)

    def pending(self) -> List[str]:
        return [t for t in self.tasks if not self._done_path(t).exists()]

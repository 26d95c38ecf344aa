"""Dynamic shell-task farming for suite-scale sweeps (a copy of
abacusutils_tpu/utils/taskfarm.py that runs without JAX: the port's
generate_cf sweep, ``scripts/torch/emulator/generate_cf.py``, drains
through it).

The reference handles "run this script over many sims/redshifts" with the
vendored third-party disBatch task farmer (reference scripts/disBatch/;
scripts/emulator/README.md broadcasts generate_cf.py over the AbacusSummit
suite with it). This module is the framework-native equivalent: a taskfile
of shell commands is drained dynamically by a pool of workers, every task's
outcome lands in a tab-delimited status file, and an interrupted or partial
sweep resumes by skipping tasks the status file already records as done.

Two deployment shapes:

* **Single farmer** (one host): ``python -m abacusutils_tpu_torch.utils.taskfarm
  tasks.txt -w 8``. Workers pull the next task as they free up, so long and
  short tasks load-balance automatically.
* **Shared-filesystem fleet** (many hosts, e.g. one farmer per Slurm node):
  every farmer is started with the same taskfile and ``--shared CLAIMS``.
  Tasks are claimed through an fcntl-locked claims file before execution,
  so each task runs exactly once across the whole fleet — dynamic cross-node
  balancing without any network server. A farmer that crashes mid-task
  leaves its claim orphaned; restart the (stopped) fleet with
  ``--release-stale`` to return claimed-but-unfinished tasks to the pool.

Taskfile syntax (a strict, documented subset of the disBatch directive
language so operational taskfiles carry over; both ``#FARM`` and
``#DISBATCH`` spell the directives):

* blank lines and ``#``-comment lines are skipped
* ``#FARM PREFIX <text>`` / ``#FARM SUFFIX <text>`` — prepended/appended to
  every subsequent task line (empty text clears)
* ``#FARM REPEAT <n> [start <s>]`` — emit the current prefix+suffix as
  ``n`` tasks with ``TASKFARM_REPEAT_INDEX`` = s, s+1, …
* ``#FARM BARRIER`` — all earlier tasks finish before any later one starts
  (per farmer; in ``--shared`` fleets each farmer drains its own claimed
  tasks before proceeding, so a fleet-wide phase boundary should be a
  separate taskfile per phase)

Each task runs under ``/bin/sh -c`` with ``TASKFARM_TASKID``,
``TASKFARM_JOBID`` and (for REPEAT) ``TASKFARM_REPEAT_INDEX`` exported;
``DISBATCH_``-spelled aliases are exported too so existing taskfiles that
interpolate ``$DISBATCH_TASKID`` work unchanged.

Status file: one tab-delimited line per finished task —
``taskid  flag  rc  elapsed  host  pid  command`` with flag ``O`` (ok),
``E`` (error), ``S`` (skipped by resume), ``B`` (barrier). Resume (``-r``)
skips tasks whose (taskid, command) pair is recorded with rc == 0; ``-R``
additionally re-runs recorded failures.
"""

from __future__ import annotations

import argparse
import fcntl
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Task:
    taskid: int
    command: str
    repeat_index: int | None = None


@dataclass(frozen=True)
class Barrier:
    taskid: int


_DIRECTIVE_TAGS = ('#FARM ', '#DISBATCH ')


def _directive(line: str) -> str | None:
    for tag in _DIRECTIVE_TAGS:
        if line.startswith(tag):
            return line[len(tag):]
    return None


def parse_taskfile(lines) -> list:
    """Expand taskfile lines into an ordered list of Task/Barrier entries."""
    out: list = []
    prefix = ''
    suffix = ''
    nextid = 0

    def emit(cmd: str, rep: int | None = None):
        nonlocal nextid
        out.append(Task(nextid, cmd, rep))
        nextid += 1

    for raw in lines:
        line = raw.rstrip('\n')
        d = _directive(line.lstrip())
        if d is not None:
            word, _, rest = d.partition(' ')
            if word == 'PREFIX':
                prefix = rest
            elif word == 'SUFFIX':
                suffix = rest
            elif word == 'BARRIER':
                out.append(Barrier(nextid))
                nextid += 1
            elif word == 'REPEAT':
                toks = rest.split()
                n = int(toks[0])
                start = 0
                body_at = 1
                if len(toks) > 2 and toks[1] == 'start':
                    start = int(toks[2])
                    body_at = 3
                body = ' '.join(toks[body_at:])
                for i in range(start, start + n):
                    emit(prefix + body + suffix, rep=i)
            else:
                raise ValueError(f'unknown taskfile directive: {word!r}')
            continue
        if not line.strip() or line.lstrip().startswith('#'):
            continue
        emit(prefix + line + suffix)
    return out


def load_status(path: str) -> dict:
    """Map taskid -> (rc, command) from a previous run's status file."""
    done: dict[int, tuple[int, str]] = {}
    with open(path) as f:
        for line in f:
            # maxsplit keeps commands containing tabs intact in field 7
            parts = line.rstrip('\n').split('\t', 6)
            if len(parts) < 7 or parts[1] not in ('O', 'E'):
                continue
            done[int(parts[0])] = (int(parts[2]), parts[6])
    return done


class _StatusWriter:
    """Append-only, flock-serialized status lines (fleet-safe)."""

    def __init__(self, path: str):
        self._f = open(path, 'a')

    def write(self, taskid: int, flag: str, rc: int, elapsed: float,
              pid: int, command: str):
        line = (f'{taskid}\t{flag}\t{rc}\t{elapsed:.3f}\t'
                f'{socket.gethostname()}\t{pid}\t{command}\n')
        fcntl.flock(self._f, fcntl.LOCK_EX)
        try:
            self._f.write(line)
            self._f.flush()
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def close(self):
        self._f.close()


class _Claims:
    """Exactly-once task claiming through a locked claims file.

    Farmers on any number of hosts sharing one filesystem race to append
    task ids; the append happens under an exclusive lock after re-reading
    the file, so a task id can be claimed by exactly one farmer.
    """

    def __init__(self, path: str):
        self._path = path
        # O_CREAT once up front so every farmer locks the same inode
        self._f = open(path, 'a+')

    def try_claim(self, taskid: int) -> bool:
        fcntl.flock(self._f, fcntl.LOCK_EX)
        try:
            self._f.seek(0)
            claimed = {int(t) for t in self._f.read().split()}
            if taskid in claimed:
                return False
            self._f.write(f'{taskid}\n')
            self._f.flush()
            return True
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def release_stale(self, finished_ids):
        """Drop claims with no finished status record (a farmer crashed
        between claiming and recording). Only safe while no farmer is
        running — claims of in-flight tasks look identical to stale ones."""
        fcntl.flock(self._f, fcntl.LOCK_EX)
        try:
            self._f.seek(0)
            claimed = [int(t) for t in self._f.read().split()]
            kept = [t for t in claimed if t in finished_ids]
            self._f.seek(0)
            self._f.truncate()
            self._f.write(''.join(f'{t}\n' for t in kept))
            self._f.flush()
            return len(claimed) - len(kept)
        finally:
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def close(self):
        self._f.close()


def _run_one(task: Task, jobid: str, log_dir: str | None) -> tuple[int, float, int]:
    env = dict(os.environ)
    pairs = {'TASKID': str(task.taskid), 'JOBID': jobid}
    if task.repeat_index is not None:
        pairs['REPEAT_INDEX'] = str(task.repeat_index)
    for k, v in pairs.items():
        env[f'TASKFARM_{k}'] = v
        env[f'DISBATCH_{k}'] = v  # taskfile compat alias
    env['DISBATCH_NAMETASKS'] = jobid
    stdout = stderr = None
    logf = None
    if log_dir is not None:
        logf = open(os.path.join(log_dir, f'task_{task.taskid}.log'), 'wb')
        stdout = stderr = logf
    t0 = time.monotonic()
    try:
        proc = subprocess.Popen(task.command, shell=True, env=env,
                                stdout=stdout, stderr=stderr)
        rc = proc.wait()
        return rc, time.monotonic() - t0, proc.pid
    finally:
        if logf is not None:
            logf.close()


@dataclass
class FarmResult:
    ran: int = 0
    failed: int = 0
    skipped: int = 0
    failed_ids: list = field(default_factory=list)


def farm(taskfile: str, workers: int = 4, status_path: str | None = None,
         resume_from: str | None = None, retry: bool = False,
         force_resume: bool = False, shared: str | None = None,
         log_dir: str | None = None, jobid: str | None = None,
         release_stale: bool = False) -> FarmResult:
    """Drain a taskfile; returns counts. See module docstring for semantics.

    release_stale: with --shared, first drop claims that have no finished
    status record (a farmer crashed mid-task, leaving its claim orphaned so
    no other farmer would ever run the task). Only pass this when restarting
    a stopped fleet — a live farmer's in-flight claims look identical.
    """
    with open(taskfile) as f:
        entries = parse_taskfile(f)
    jobid = jobid or f'{os.path.basename(taskfile)}_{os.getpid()}'
    status_path = status_path or taskfile + '_status.txt'
    prior = load_status(resume_from) if resume_from else {}
    status = _StatusWriter(status_path)
    claims = _Claims(shared) if shared else None
    if claims is not None and release_stale:
        finished = set(prior)
        if os.path.exists(status_path):
            finished |= set(load_status(status_path))
        claims.release_stale(finished)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    res = FarmResult()
    pool = ThreadPoolExecutor(max_workers=workers)
    pending: dict = {}

    def finish(done):
        for fut in done:
            task = pending.pop(fut)
            rc, elapsed, pid = fut.result()
            status.write(task.taskid, 'E' if rc else 'O', rc, elapsed, pid,
                         task.command)
            res.ran += 1
            if rc:
                res.failed += 1
                res.failed_ids.append(task.taskid)

    def drain():
        done, _ = wait(pending)
        finish(done)

    try:
        for entry in entries:
            if isinstance(entry, Barrier):
                drain()
                status.write(entry.taskid, 'B', 0, 0.0, os.getpid(), 'BARRIER')
                continue
            if entry.taskid in prior:
                rc_prev, cmd_prev = prior[entry.taskid]
                same = force_resume or cmd_prev == entry.command
                if same and (rc_prev == 0 or not retry):
                    res.skipped += 1
                    status.write(entry.taskid, 'S', rc_prev, 0.0,
                                 os.getpid(), entry.command)
                    continue
            if claims is not None and not claims.try_claim(entry.taskid):
                continue
            while len(pending) >= workers:
                done, _ = wait(pending, return_when=FIRST_COMPLETED)
                finish(done)
            pending[pool.submit(_run_one, entry, jobid, log_dir)] = entry
        drain()
    finally:
        pool.shutdown(wait=True)
        status.close()
        if claims is not None:
            claims.close()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='taskfarm',
        description='Drain a taskfile of shell commands over a worker pool.')
    ap.add_argument('taskfile')
    ap.add_argument('-w', '--workers', type=int, default=os.cpu_count() or 1)
    ap.add_argument('-s', '--status', default=None,
                    help='status file path (default: TASKFILE_status.txt)')
    ap.add_argument('-r', '--resume-from', default=None,
                    help='skip tasks recorded as done in this status file')
    ap.add_argument('-R', '--retry', action='store_true',
                    help='with -r, also re-run recorded failures')
    ap.add_argument('--force-resume', action='store_true',
                    help='with -r, match tasks by id only (ignore command text)')
    ap.add_argument('--shared', default=None, metavar='CLAIMS',
                    help='claims file for exactly-once dispatch across '
                         'multiple farmers on a shared filesystem')
    ap.add_argument('--log-dir', default=None,
                    help='capture each task\'s stdout+stderr to task_ID.log')
    ap.add_argument('--release-stale', action='store_true',
                    help='with --shared, release claims that never finished '
                         '(crashed farmer); use only when no farmer is running')
    args = ap.parse_args(argv)
    res = farm(args.taskfile, workers=args.workers, status_path=args.status,
               resume_from=args.resume_from, retry=args.retry,
               force_resume=args.force_resume, shared=args.shared,
               log_dir=args.log_dir, release_stale=args.release_stale)
    print(f'taskfarm: {res.ran} ran, {res.failed} failed, '
          f'{res.skipped} skipped', file=sys.stderr)
    return 1 if res.failed else 0


if __name__ == '__main__':
    sys.exit(main())

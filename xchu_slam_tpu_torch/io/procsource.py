"""Process-parallel scan source: serve `scans[k]` from forked worker
processes (port of `xchu_slam_tpu.io.procsource`).

The staging threads of `io/prefetch.DeviceChunkPrefetcher` render lazily,
and the render (`utils/sim.render_scan`) is numpy that holds the
interpreter lock, so threads do not add up. Worker processes do: each
renders its share of the scans and sends them back through a pipe of its
own, and a collector thread in the parent files them for the consumer,
which may take them in any order (the chunked prefetcher's threads
interleave chunks).

Start method: fork. The workers inherit the scan source (world and poses)
copy-on-write, with nothing pickled; they run numpy only and leave with
`os._exit`, so no inherited exit hook runs. A fork is safe only before the
process has started threads of its own or a CUDA context, so the source is
made before the run's first CUDA call and before the prefetcher's threads,
and it refuses, by name, to fork once `torch.cuda.is_initialized()`.

Unlike the reference:
- each worker has its own task and result pipes and the parent knows which
  indices it holds, so the death of any worker ends a wait at once: the
  parent renders the indices that worker held, counts them
  (`inline_renders`) and names the worker's exit code on stderr. A killed
  worker cannot leave a shared queue's lock held, because nothing is shared.
- every item comes back float32, from the workers and from the inline
  path alike.
The result is the same whoever renders a scan, because each scan draws from
a generator of its own (`sim.RenderedScans`). An index already served, or
asked for after `close()`, is rendered inline too, so repeated access stays
correct.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import threading
from multiprocessing.connection import wait

import numpy as np


def _as_item(scan):
    """An item as the consumer gets it: float32 arrays, intensity optional."""
    xyz, inten = scan if isinstance(scan, tuple) else (scan, None)
    return (np.asarray(xyz, np.float32),
            None if inten is None else np.asarray(inten, np.float32))


def _worker_main(scans, tasks, results, inherited) -> None:
    """Render each index received on `tasks` and send it back on `results`,
    until a None or the parent's end closes. `inherited` are the parent's
    ends of the pipes, closed here so that this process holds none of them:
    then the parent's exit ends the wait below."""
    try:
        for conn in inherited:
            conn.close()
        while True:
            k = tasks.recv()
            if k is None:
                break
            try:
                xyz, inten = _as_item(scans[k])
                results.send((k, xyz, inten, None))
            except Exception as exc:  # noqa: BLE001 - re-raised by the parent's __getitem__
                results.send((k, None, None, repr(exc)))
    except (EOFError, OSError):
        pass                      # the parent is gone or closed the pipes
    finally:
        os._exit(0)               # skip the inherited exit hooks


class _Worker:
    def __init__(self, ctx, scans, earlier: list):
        task_r, self.tasks = ctx.Pipe(duplex=False)
        self.results, res_w = ctx.Pipe(duplex=False)
        inherited = [c for w in earlier for c in (w.tasks, w.results)]
        inherited += [self.tasks, self.results]
        self.proc = ctx.Process(target=_worker_main,
                                args=(scans, task_r, res_w, inherited), daemon=True)
        self.proc.start()
        task_r.close()            # the parent keeps only its own ends
        res_w.close()
        self.held: set[int] = set()   # indices sent and not yet returned
        self.alive = True


class ProcessScanSource:
    """Indexable view of `scans` whose items are rendered by `workers`
    forked processes, up to `readahead` items ahead of consumption.

    Contract: the same `__len__` / `__getitem__` as the wrapped sequence,
    items as float32 arrays (a tuple where the source gives one); an index
    is served from the workers at most once, and repeats, reads after
    `close()` and the indices of a dead worker are rendered inline."""

    def __init__(self, scans, workers: int = 3, readahead: int = 128):
        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError(
                "ProcessScanSource forks its render workers, which is unsafe once CUDA "
                "is initialized in this process: make the source before the first CUDA "
                "call")
        self.scans = scans
        self._n = len(scans)
        n_workers = max(1, workers)
        self._readahead = max(readahead, 2 * n_workers)
        self._results: dict[int, tuple] = {}
        self._served: set[int] = set()
        self._cv = threading.Condition()
        self._consumed = 0
        self._closed = False
        self.inline_renders = 0
        ctx = mp.get_context("fork")
        self._workers: list[_Worker] = []
        for _ in range(n_workers):
            self._workers.append(_Worker(ctx, scans, self._workers))
        self._owner: dict[int, _Worker] = {}
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._collector = threading.Thread(target=self._collect, daemon=True)
        self._feeder.start()
        self._collector.start()

    # ------------------------------------------------------------ threads -- #
    def _feed(self) -> None:
        """Hand out the indices in order, round-robin over the live workers,
        at most `readahead` ahead of what was consumed."""
        turn = 0
        for k in range(self._n):
            with self._cv:
                while not self._closed and k >= self._consumed + self._readahead:
                    self._cv.wait(0.2)
                live = [w for w in self._workers if w.alive]
                if self._closed or not live:
                    return
                w = live[turn % len(live)]
                turn += 1
                w.held.add(k)
                self._owner[k] = w
            try:
                w.tasks.send(k)
            except OSError:       # it died: its indices are rendered inline
                self._mark_dead(w)
        with self._cv:
            live = [w for w in self._workers if w.alive]
        for w in live:
            try:
                w.tasks.send(None)
            except OSError:
                pass

    def _mark_dead(self, w: _Worker) -> None:
        with self._cv:
            if not w.alive:
                return
            w.alive = False
            lost = sorted(w.held)
            closed = self._closed
            self._cv.notify_all()
        w.proc.join(timeout=1.0)
        if lost and not closed:
            print(f"render worker {w.proc.pid} exited with code {w.proc.exitcode} holding "
                  f"{len(lost)} scans; they are rendered in the parent", file=sys.stderr)

    def _collect(self) -> None:
        """File every result as it arrives; a worker whose process ended (its
        sentinel) or whose pipe broke is marked dead after its pipe is
        drained."""
        while True:
            with self._cv:
                if self._closed:
                    return
                live = [w for w in self._workers if w.alive]
            if not live:
                return
            conns = {w.results: w for w in live}
            sentinels = {w.proc.sentinel: w for w in live}
            ready = wait(list(conns) + list(sentinels), timeout=0.2)
            ended = []
            for r in ready:
                if r in conns:
                    if not self._receive(conns[r]):
                        ended.append(conns[r])
                else:
                    ended.append(sentinels[r])
            for w in ended:
                while self._receive(w) and w.results.poll():
                    pass
                self._mark_dead(w)

    def _receive(self, w: _Worker) -> bool:
        """File one result from w's pipe, if one is there. False once the
        pipe is closed or broken."""
        try:
            if not w.results.poll():
                return True
            k, xyz, inten, err = w.results.recv()
        except (EOFError, OSError):
            return False
        with self._cv:
            w.held.discard(k)
            self._results[k] = (xyz, inten, err)
            self._cv.notify_all()
        return True

    # ---------------------------------------------------------- consumer -- #
    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k: int):
        if k < 0:
            k += self._n
        with self._cv:
            inline = self._closed or k in self._served or not 0 <= k < self._n
            lost = False
            while not inline and k not in self._results:
                owner = self._owner.get(k)
                if not (owner.alive if owner is not None
                        else any(w.alive for w in self._workers)):
                    lost = True       # its worker died holding it, or all did
                    break
                self._cv.wait(0.2)
            if inline or lost:
                self.inline_renders += 1
            else:
                xyz, inten, err = self._results.pop(k)
            if not inline:
                self._served.add(k)
                self._consumed += 1
                self._cv.notify_all()
        if inline or lost:
            xyz, inten = _as_item(self.scans[k])
        elif err is not None:
            raise RuntimeError(f"render worker failed on scan {k}: {err}")
        return xyz if inten is None else (xyz, inten)

    def close(self) -> None:
        """Stop the threads and the workers (our own children, by PID)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        for w in self._workers:
            if w.proc.is_alive():
                w.proc.terminate()
        self._feeder.join(timeout=2.0)
        self._collector.join(timeout=2.0)
        for w in self._workers:
            w.proc.join(timeout=2.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=2.0)
            w.tasks.close()
            w.results.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

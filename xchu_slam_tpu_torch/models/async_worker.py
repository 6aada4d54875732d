"""Asynchronous loop-closure worker (port of
`xchu_slam_tpu.models.async_worker`).

Loop detection and ICP verification run on a worker thread, as the
reference's `LoopClosure` / `ICPRefine` threads do; all writes to the engine's
state stay on the pipeline's thread: verified loops travel back through a
queue and are applied at the next scan boundary.

The reference's worker reads immutable JAX arrays. The port's keyframe
database is written in place, so the worker reads the snapshot the pipeline
publishes (`SlamPipeline._snapshot`: the database and an event recorded on the
pipeline's stream after its last write). Rows below the snapshot's count are
never rewritten: a keyframe writes the row at the count, and a solve binds a
fresh `opt_poses`. On the card the worker has a CUDA stream of its own; it
waits for the snapshot's event before it reads, and the pipeline's stream
waits for the worker's event before it reads a verified transform.

A backlog collapses to its newest job, as in the reference, so which
keyframes are verified depends on timing. An exception in the worker is
kept and raised on the pipeline's thread at the next `drain` (and so in
`finalize`); it does not end the worker, which keeps taking jobs so that
`jobs.join()` returns.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import NamedTuple

import torch

# how long `stop` waits for the job in hand: a first verification on the card
# builds and captures the ICP graph
STOP_TIMEOUT_S = 600.0


class VerifiedLoop(NamedTuple):
    i: int
    j: int
    T: torch.Tensor   # [4,4] pose of keyframe j in keyframe i's frame
    fitness: float
    method: str


class AsyncLoopWorker:
    """The worker thread of one `SlamPipeline`: `submit` a keyframe, `drain`
    the verified loops, `stop` at the end."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.jobs: queue.Queue = queue.Queue()
        self.results: queue.Queue = queue.Queue()
        self.error: BaseException | None = None
        # the thread and its stream start with the first job, so that a
        # pipeline that never submits (a restored localizer) holds neither
        self.stream: torch.cuda.Stream | None = None
        self.thread: threading.Thread | None = None
        self._start_lock = threading.Lock()

    def submit(self, k: int, stamp: float) -> None:
        """Queue the detection of keyframe k (pipeline thread, after the
        keyframe's snapshot was published)."""
        with self._start_lock:
            if self.thread is None:
                dev = self.pipe.device
                if dev.type == "cuda":
                    self.stream = torch.cuda.Stream(dev)
                self.thread = threading.Thread(target=self._run, name="loop-worker",
                                               daemon=True)
                self.thread.start()
        self.jobs.put((k, stamp))

    def drain(self) -> list[VerifiedLoop]:
        """The loops verified so far, ready for the pipeline's stream; raises
        the worker's exception if it had one."""
        out = []
        while True:
            try:
                rec, done = self.results.get_nowait()
            except queue.Empty:
                break
            if done is not None:
                cur = torch.cuda.current_stream(self.pipe.device)
                cur.wait_event(done)
                rec.T.record_stream(cur)
            out.append(rec)
        if self.error is not None:
            raise self.error
        return out

    def stop(self) -> None:
        """Finish the job in hand (a stop found in the backlog lets the
        newest job complete first), then end the thread."""
        if self.thread is None:
            return
        self.jobs.put(None)
        self.thread.join(STOP_TIMEOUT_S)
        if self.thread.is_alive():
            raise RuntimeError(f"the loop worker did not stop within {STOP_TIMEOUT_S} s")

    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        ctx = (torch.cuda.stream(self.stream) if self.stream is not None
               else contextlib.nullcontext())
        with ctx:
            exiting = False
            while not exiting:
                job = self.jobs.get()
                taken = 1
                if job is None:
                    self.jobs.task_done()
                    return
                # collapse a backlog to the newest job
                while True:
                    try:
                        nxt = self.jobs.get_nowait()
                    except queue.Empty:
                        break
                    taken += 1
                    if nxt is None:
                        exiting = True
                        break
                    job = nxt
                try:
                    if self.error is None:
                        self._verify(*job)
                except Exception as exc:  # noqa: BLE001 - raised again by drain()
                    self.error = exc
                finally:
                    for _ in range(taken):
                        self.jobs.task_done()

    def _verify(self, k: int, stamp: float) -> None:
        db, ready = self.pipe._snapshot
        if ready is not None:
            self.stream.wait_event(ready)
        rec = self.pipe.detect_and_verify_snapshot(k, stamp, db)
        if rec is None:
            return
        done = None
        if self.stream is not None:
            done = torch.cuda.Event()
            done.record(self.stream)
        self.results.put((rec, done))

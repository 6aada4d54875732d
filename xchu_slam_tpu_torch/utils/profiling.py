"""Stage timers, program spans and device traces (port of
`xchu_slam_tpu.utils.profiling`, with the port's own spans).

`StageTimers` are host wall-clock meters. PyTorch returns before the device
finishes, so a timer made for a CUDA device synchronizes it before a stage's
clock starts and before it stops: the stage is then charged its own device
work and none of the stage before it.

`Spans` is an owner's recorder of named spans (the device engine has one):
always on, it keeps host seconds, self seconds (a span's duration less the
time its child spans cover) and a count by name, from
`time.perf_counter_ns`, with no synchronisation. Inside `recording()` every
span, an owner's or a `timeline` span of code that keeps no totals (the
prefetcher's), is also kept as a `SpanRecord` (name, start, end, parent,
chunk, thread) in a bounded ring, and a span opened with `device=True` on a
CUDA owner gets a pair of timing events, resolved once the card has passed
them. Outside it nothing is kept and no CUDA call is made.

`device_trace` is a torch.profiler scope that records the program's spans
for its scope and writes both into one Chrome trace (chrome://tracing,
Perfetto), where the reference writes a `jax.profiler` trace: the spans go
onto the profiler's clock through a (perf_counter, epoch) pair taken when
recording starts and the trace's own start. It also splits the card's idle
time among the spans of the feeding thread (`idle_by_span`).
`count_host_syncs` counts the host synchronisations PyTorch makes on the
card inside a block (the port's own; the mesh engine's readbacks are counted
with it).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from collections import defaultdict

import torch


class StageTimers:
    """Named accumulating wall-clock meters."""

    def __init__(self, device: torch.device | str | None = None):
        device = torch.device(device) if device is not None else None
        self._cuda = device if device is not None and device.type == "cuda" else None
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.last = {}

    def _sync(self):
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    @contextlib.contextmanager
    def time(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.last[name] = dt

    def mean_ms(self, name: str) -> float:
        c = self.count[name]
        return 1000.0 * self.total[name] / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.total):
            lines.append(
                f"{name:24s} n={self.count[name]:6d} "
                f"mean={self.mean_ms(name):8.2f} ms "
                f"total={self.total[name]:8.2f} s")
        return "\n".join(lines)


# ------------------------------------------------------------------ spans -- #
RING_RECORDS = 1 << 16      # a recording's ring: the newest records are kept


class SpanRecord:
    """One span of a recording: `start_ns` / `end_ns` on `perf_counter_ns`,
    the `id` of the span and of its `parent` (the innermost span open on the
    same thread when it opened; None at the top), the owner's `chunk` id,
    the thread, and the device milliseconds between its timing events (None
    without them, or until the card has passed them)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "chunk", "thread",
                 "thread_name", "device_ms", "events")

    def __init__(self, name, start_ns, end_ns, id_, parent, chunk, events):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.id, self.parent, self.chunk = id_, parent, chunk
        th = threading.current_thread()
        self.thread, self.thread_name = threading.get_native_id(), th.name
        self.device_ms = None
        self.events = events


class Recording:
    """The records of one `recording()` scope: a ring of the newest
    `capacity` records (`dropped` counts those pushed out), and the clock
    pair that places them on the epoch."""

    def __init__(self, capacity: int):
        self.records = collections.deque(maxlen=capacity)
        self.added = 0
        self._pending = []            # records whose timing events are unresolved
        self._events = []             # resolved timing events, for reuse
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.clock = (time.perf_counter_ns(), time.time_ns())

    @property
    def dropped(self) -> int:
        return self.added - len(self.records)

    def epoch_ns(self, perf_ns: int) -> int:
        return perf_ns - self.clock[0] + self.clock[1]

    def _event(self):
        """A timing event recorded on the current stream (a resolved one
        reused: making and freeing an event a span is not free)."""
        with self._lock:
            ev = self._events.pop() if self._events else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _add(self, rec: SpanRecord) -> None:
        with self._lock:
            self.records.append(rec)
            self.added += 1
            if rec.events is not None:
                self._pending.append(rec)

    def resolve(self) -> None:
        """Device milliseconds of the records whose end event the card has
        passed (no synchronisation: an event not yet passed stays pending)."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep, free = [], []
        for rec in pending:
            start, end = rec.events
            if end.query():
                rec.device_ms = start.elapsed_time(end)
                rec.events = None
                free += (start, end)
            else:
                keep.append(rec)
        with self._lock:
            self._pending.extend(keep)
            self._events.extend(free)


_ACTIVE: Recording | None = None     # the process's recording, set by `recording()`
_STACK = threading.local()           # the spans open on each thread


def _open_spans() -> list:
    stack = getattr(_STACK, "spans", None)
    if stack is None:
        stack = _STACK.spans = []
    return stack


def active_recording() -> Recording | None:
    return _ACTIVE


@contextlib.contextmanager
def recording(capacity: int = RING_RECORDS):
    """Keep every span of the process, timestamped, for the block (one
    recording at a time, like the profiler). Yields the `Recording`; its
    records are complete on exit, the device times of the spans whose events
    the card has passed resolved."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _ACTIVE = Recording(capacity)
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec.resolve()


class _Span:
    __slots__ = ("owner", "name", "device", "chunk", "t0", "child_ns", "parent", "rec",
                 "id", "events")

    def __init__(self, owner, name: str, device: bool, chunk):
        self.owner, self.name, self.device, self.chunk = owner, name, device, chunk

    def __enter__(self):
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        if self.owner is not None:
            self.chunk = self.owner.chunk
        elif self.chunk is None and self.parent is not None:
            self.chunk = self.parent.chunk
        self.rec = rec = _ACTIVE
        self.events = None
        if rec is not None:
            self.id = next(rec._ids)
            if self.device and self.owner is not None and self.owner.cuda:
                self.events = rec._event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        dur = t1 - self.t0
        _open_spans().pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        owner = self.owner
        if owner is not None:
            owner._add(self.name, dur, dur - self.child_ns)
        rec = self.rec
        if rec is not None and rec is _ACTIVE:
            events = None
            if self.events is not None:
                events = (self.events, rec._event())
            pid = parent.id if parent is not None and parent.rec is rec else None
            rec._add(SpanRecord(self.name, self.t0, t1, self.id, pid, self.chunk, events))
        return False


class Spans:
    """An owner's spans: `span(name)` is a context manager that adds the
    block's host seconds, self seconds and one count to the owner's totals
    under `name`, and, inside `recording()`, keeps a record with the owner's
    current `chunk` id. `device=True` on an owner made with `cuda` also
    brackets the block with timing events while recording."""

    def __init__(self, cuda: bool = False):
        self.cuda = cuda
        self.chunk = None
        self.seconds = defaultdict(float)
        self.self_seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    def span(self, name: str, device: bool = False) -> _Span:
        return _Span(self, name, device, None)

    def _add(self, name: str, dur_ns: int, self_ns: int) -> None:
        with self._lock:
            self.seconds[name] += 1e-9 * dur_ns
            self.self_seconds[name] += 1e-9 * self_ns
            self.counts[name] += 1

    def totals(self) -> dict:
        """Inclusive seconds by span name, and self seconds under
        `self.<name>`."""
        with self._lock:
            return {**self.seconds, **{f"self.{k}": v for k, v in self.self_seconds.items()}}


def timeline(name: str, chunk=None) -> _Span:
    """A span kept only inside `recording()`, with no owner and no totals."""
    return _Span(None, name, False, chunk)


# ------------------------------------------------------------------ trace -- #
TRACE_FILE = "trace.json"
SPAN_TID_BASE = 1_000_000_000    # the program's tracks, apart from the profiler's threads


def idle_gaps(intervals) -> list:
    """The gaps between the union of `intervals` ((start, end) pairs), from
    the first start to the last end."""
    gaps, cur = [], None
    for a, b in sorted(intervals):
        if cur is None:
            cur = b
        elif a > cur:
            gaps.append((cur, a))
            cur = b
        else:
            cur = max(cur, b)
    return gaps


def innermost(spans) -> list:
    """Properly nested (start, end, name) spans of one thread → the disjoint
    segments (start, end, name) of the innermost span covering them."""
    out = []
    stack = []
    t = None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            emit(t, end, top)
            t = end
        if stack:
            emit(t, a, stack[-1][1])
        t = a
        stack.append((b, name))
    while stack:
        end, top = stack.pop()
        emit(t, end, top)
        t = end
    return out


def idle_by_span(intervals, spans) -> dict:
    """Each gap between the union of the device's `intervals` split exactly
    among the innermost of `spans` (one thread's (start, end, name)) that
    cover it; the part no span covers goes under "outside". The parts sum to
    the total idle time, in the inputs' unit."""
    segs = innermost(spans)
    starts = [s[0] for s in segs]
    out: dict = defaultdict(float)
    for a, b in idle_gaps(intervals):
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        for sa, sb, name in segs[i:]:
            if sa >= b:
                break
            lo, hi = max(a, sa), min(b, sb)
            if hi > lo:
                out[name] += hi - lo
                covered += hi - lo
        out["outside"] += (b - a) - covered
    return dict(out)


def _is_device(ev) -> bool:
    """A kernel, copy or fill on the card (not the device-side copy of a host
    annotation)."""
    return (str(getattr(ev, "device_type", "")).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False))


class DeviceTrace:
    """What `device_trace` leaves: `prof` (the profiler), and after the
    scope `spans` (the recording's records as (start, end, name, record),
    microseconds on the profiler's clock: after its trace's start, as
    `FunctionEvent.time_range`), `dropped`, `idle_s` (the card's idle time
    between its first and last activity) and `idle_by_span` (that idle, in
    seconds, split among the feeding thread's innermost spans)."""

    def __init__(self, path: str, feeder: int):
        self.path = path
        self.feeder = feeder
        self.prof = None
        self.spans: list = []
        self.dropped = 0
        self.idle_s = 0.0
        self.idle_by_span: dict = {}

    def _finish(self, rec: Recording) -> None:
        t0 = int(self.prof.profiler.kineto_results.trace_start_ns())

        def us(perf_ns):
            return 1e-3 * (rec.epoch_ns(perf_ns) - t0)

        self.spans = [(us(r.start_ns), us(r.end_ns), r.name, r) for r in rec.records]
        self.dropped = rec.dropped
        dev = [(e.time_range.start, e.time_range.end) for e in self.prof.events()
               if _is_device(e)]
        fed = [(a, b, name) for a, b, name, r in self.spans if r.thread == self.feeder]
        self.idle_s = 1e-6 * sum(b - a for a, b in idle_gaps(dev))
        self.idle_by_span = {k: 1e-6 * v for k, v in idle_by_span(dev, fed).items()}

    def _write(self, rec: Recording) -> None:
        """The profiler's Chrome trace with the spans added: a track a host
        thread, each span a complete event with its chunk, parent and device
        time."""
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            doc = json.load(f)
        base = int(doc.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        events, named = doc["traceEvents"], set()
        for r in rec.records:
            tid = SPAN_TID_BASE + r.thread
            if tid not in named:
                named.add(tid)
                events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                               "args": {"name": f"program spans ({r.thread_name})"}})
            args = {"chunk": r.chunk, "id": r.id, "parent": r.parent}
            if r.device_ms is not None:
                args["device_ms"] = r.device_ms
            events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
                           "tid": tid, "ts": 1e-3 * (rec.epoch_ns(r.start_ns) - base),
                           "dur": 1e-3 * (r.end_ns - r.start_ns), "args": args})
        with open(self.path, "w") as f:
            json.dump(doc, f)


@contextlib.contextmanager
def device_trace(log_dir: str, device: torch.device | str = "cuda",
                 capacity: int = RING_RECORDS):
    """torch.profiler scope: host activity, and the card's kernels and copies
    where `device` is CUDA, with the program's spans recorded for the scope
    (`recording(capacity)`). On exit it waits for the device and writes
    `<log_dir>/trace.json` (a later trace into the same directory replaces
    it) with the spans as tracks of their own. Yields a `DeviceTrace`, whose
    spans and idle split are filled on exit; the thread that enters the
    scope is the one that feeds the card."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: no CUDA device is available")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    out = DeviceTrace(os.path.join(log_dir, TRACE_FILE), threading.get_native_id())
    with recording(capacity) as rec:
        with profile(activities=activities) as prof:
            out.prof = prof
            try:
                yield out
            finally:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    out._finish(rec)
    out._write(rec)


_SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def count_host_syncs(enabled: bool = True):
    """Count the host synchronisations PyTorch makes on CUDA tensors inside
    the block (a readback, `.item()`, a stream or device synchronise): the
    block runs under `torch.cuda.set_sync_debug_mode("warn")` and its
    warnings are counted, not shown. A synchronise made through `ctypes` is
    not seen. Yields a dict whose `"syncs"` is set on exit (None where not
    `enabled`); the block's other warnings are shown on exit. The mode and
    the warnings filter are the process's: threads beside the block are
    counted too."""
    out = {"syncs": None}
    if not enabled:
        yield out
        return
    prev = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield out
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    finally:
        others = [w for w in seen if _SYNC_WARNING not in str(w.message)]
        out["syncs"] = len(seen) - len(others)
        for w in others:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

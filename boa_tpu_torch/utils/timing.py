"""Per-stage wall seconds, and the program's spans on the profiler's clock.

Counterpart of `Spans` in `boa_tpu/utils/timing.py`, shared by
`predict_image`, the measurement engine and `compute_all_models`: each
mark waits for the device's queued work (`torch.cuda.synchronize`) before
it reads the clock, so a stage's seconds are its own and not the next
stage's. With no `out` dict the marks do nothing and never synchronize.
`Spans.span(name)` times a block the same way.

The recorder. While a `torch.profiler` records (the flag
`torch.autograd.profiler._is_profiler_enabled`, which every torch profiler
sets), each span, from `Spans.span` or `span`:
- opens the range `boa.<name>` (`record_function`), which the profiler's
  trace holds beside the device's kernels, on their clock;
- is recorded with its study (one id for every span of one `study()`, the
  root span of a `python_api.totalsegmentator` call, which opens no range),
  its parent, its host start and end (`time.perf_counter_ns`) and, on a
  CUDA device, two timing events recorded on the current stream at entry
  and exit. The events are never waited on inside the span: `last_trace()`
  resolves them when the record is read.
`Spans.add` and `count` add counters to the same record. Only the newest
capture is kept: the records since the first taken after a study that ran
with no profiler recording (or since the process began), at most
`MAX_RECORDS` of them. So the profiler's window and the program's spans are
taken together, with no flag of their own: the benchmark's traced window,
or the CLI's `BOA_PROFILE`.

With no profiler recording, a span costs one flag check: it returns a
shared do-nothing context, with no range, no event and no allocation, and
no synchronize unless an `out` dict asks for its seconds.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16   # spans and counters a capture keeps
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    """One recorded span. `parent` indexes `Trace.spans`; `end_ns` is None
    while the span is open; `device_ms` is the time between its CUDA events
    (None off the card)."""
    name: str
    study: int | None
    parent: int | None
    start_ns: int
    end_ns: int | None
    device_ms: float | None


class Count(NamedTuple):
    """One counter addition; `span` indexes the innermost open span."""
    name: str
    value: float
    study: int | None
    span: int | None


class Trace(NamedTuple):
    """The newest profiled capture, read-only; `dropped` counts records
    past `MAX_RECORDS`."""
    spans: tuple[Span, ...]
    counts: tuple[Count, ...]
    dropped: int

    def studies(self) -> int:
        """Studies recorded: the root spans `study`."""
        return sum(1 for s in self.spans if s.name == "study" and s.parent is None)

    def host_s(self, name: str) -> float:
        """Host seconds of the closed spans `name`, summed."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name == name and s.end_ns is not None) * 1e-9

    def device_s(self, name: str) -> float | None:
        """Device seconds of the closed spans `name`, summed; None where one
        has no device time."""
        ms = [s.device_ms for s in self.spans if s.name == name and s.end_ns is not None]
        return None if not ms or None in ms else 1e-3 * sum(ms)

    def total(self, name: str) -> float:
        """The counter `name` summed."""
        return sum(c.value for c in self.counts if c.name == name)


class _Rec:
    __slots__ = ("name", "study", "parent", "index", "t0", "t1", "events",
                 "device_ms", "range")


class _Capture:
    def __init__(self) -> None:
        self.recs: list[_Rec] = []
        self.counts: list[Count] = []
        self.dropped = 0

    def room(self) -> bool:
        """Whether one more record is kept; a record past the bound is
        counted in `dropped` instead."""
        if len(self.recs) + len(self.counts) < MAX_RECORDS:
            return True
        self.dropped += 1
        return False


_capture: _Capture | None = None
_taking = False            # whether the newest capture takes further records
_study_ids = itertools.count(1)
_local = threading.local()


def _current() -> tuple[_Capture, list]:
    """The capture taking records, and this thread's stack of open spans."""
    global _capture, _taking
    if not _taking:
        _capture, _taking = _Capture(), True
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return _capture, stack


def _open(name: str, device: torch.device | None, root: bool) -> _Rec:
    capture, stack = _current()
    top = stack[-1] if stack else None
    rec = _Rec()
    rec.name = name
    rec.study = top.study if top is not None else (next(_study_ids) if root else None)
    rec.parent = None if top is None else top.index
    rec.index = rec.t1 = rec.events = rec.device_ms = rec.range = None
    if capture.room():
        rec.index = len(capture.recs)
        capture.recs.append(rec)
    stack.append(rec)
    if not root:
        rec.range = _profiler.record_function("boa." + name)
        rec.range.__enter__()
    if device is not None and device.type == "cuda":
        rec.events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        rec.events[0].record(torch.cuda.current_stream(device))
    rec.t0 = time.perf_counter_ns()
    return rec


def _close(rec: _Rec, device: torch.device | None) -> None:
    rec.t1 = time.perf_counter_ns()
    if rec.events is not None:
        rec.events[1].record(torch.cuda.current_stream(device))
    if rec.range is not None:
        rec.range.__exit__(None, None, None)
        rec.range = None
    stack = getattr(_local, "stack", [])
    if stack and stack[-1] is rec:
        stack.pop()


class _Span:
    """A span's block: the seconds into its owner's `out` (when given) and
    the record (while a profiler records)."""
    __slots__ = ("owner", "name", "device", "recorded", "root", "rec", "t0")

    def __init__(self, owner: Spans | None, name: str, device: torch.device | None,
                 recorded: bool, root: bool = False) -> None:
        self.owner, self.name, self.device = owner, name, device
        self.recorded, self.root, self.rec = recorded, root, None

    def __enter__(self) -> _Span:
        if self.recorded:
            self.rec = _open(self.name, self.device, self.root)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        own = self.owner
        if own is not None and own.out is not None and exc_type is None:
            if own.device.type == "cuda":
                torch.cuda.synchronize(own.device)
            now = time.perf_counter()
            own._sum(self.name, now - self.t0)
            own.t = now
        if self.rec is not None:
            _close(self.rec, self.device)
        return False


def span(name: str, device=None):
    """Context manager: the span `name` in the recorder while a profiler
    records (its CUDA events on `device`, when that is the card); otherwise
    nothing. It never synchronizes."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(None, name, None if device is None else torch.device(device), True)


def study():
    """Context manager: the root span `study`, whose id every span inside it
    shares; it opens no range, so a gap in the trace is named by its layer.
    A study entered with no profiler recording ends the newest capture's
    intake: the next profiled span starts a new one."""
    global _taking
    if not _profiler._is_profiler_enabled:
        _taking = False
        return _OFF
    return _Span(None, "study", None, True, root=True)


def count(name: str, value) -> None:
    """Add `value` to the counter `name` of the record while a profiler
    records; otherwise nothing."""
    if not _profiler._is_profiler_enabled:
        return
    capture, stack = _current()
    if not capture.room():
        return
    top = stack[-1] if stack else None
    capture.counts.append(Count(name, value, None if top is None else top.study,
                                None if top is None else top.index))


def last_trace() -> Trace | None:
    """The newest profiled capture (None before the first): its spans, each
    closed span's CUDA events resolved here, and its counters."""
    capture = _capture
    if capture is None:
        return None
    spans = []
    for r in list(capture.recs):
        if r.events is not None and r.t1 is not None:
            r.events[1].synchronize()
            r.device_ms, r.events = r.events[0].elapsed_time(r.events[1]), None
        spans.append(Span(r.name, r.study, r.parent, r.t0, r.t1, r.device_ms))
    return Trace(tuple(spans), tuple(capture.counts), capture.dropped)


class Spans:
    """Per-stage wall seconds into `out` (when given), summed per label."""

    def __init__(self, out: dict | None, device: torch.device) -> None:
        self.out, self.device = out, torch.device(device)
        self.t = time.perf_counter()

    def mark(self, label: str) -> None:
        """Add the seconds since the last mark (or since the start) to `label`."""
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self._sum(label, now - self.t)
        self.t = now

    def span(self, name: str):
        """Context manager: the block's seconds into `out[name]` on exit, as
        `mark(name)` would add them (synchronizing only when `out` is
        given; a block that raises adds nothing), and the span `name` in
        the recorder while a profiler records, with CUDA events on this
        device."""
        if _profiler._is_profiler_enabled:
            return _Span(self, name, self.device, True)
        if self.out is None:
            return _OFF
        return _Span(self, name, None, False)

    def restart(self) -> None:
        """Start the next span now (after work that other spans timed)."""
        self.t = time.perf_counter()

    def add(self, label: str, value) -> None:
        """Add `value` to `out[label]`, and to the recorder's counter
        `label` while a profiler records."""
        self._sum(label, value)
        count(label, value)

    def _sum(self, label: str, value) -> None:
        if self.out is not None:
            self.out[label] = self.out.get(label, 0) + value

"""Host spans of the serving and decode path, recorded in memory.

Off by default.  ``span(name, batch=, request=)`` is a context manager;
while recording is off it returns one shared object that does nothing,
after one check of a module flag: no lock, no allocation, no clock read.
``enable()`` starts a recording, ``disable()`` stops it and ``take()``
hands the recorded spans over and clears them.  ``record(...)`` adds a
span whose start was stamped earlier (a request's wait in the queue).

A span is ``(name, thread name, start_ns, end_ns, ids)``: ``ids`` holds
the ``batch`` (the caption service's batch counter) and the ``request``
(its submit sequence number) the span belongs to, where it knows them,
so the spans of one request and of one batch can be joined.  Nesting is
by time on one thread.  A recording holds at most ``LIMIT`` spans; the
ones past it are counted and ``take()`` reports how many.

Spans are stamped with ``now()``, the wall clock (``time.time_ns()``),
which is the clock ``torch.profiler`` puts its host events on: in the
Chrome trace it exports, an event's ``ts`` (microseconds) is ``(t_ns -
baseTimeNanoseconds) / 1e3``, with ``baseTimeNanoseconds`` read from the
trace's top level.  So a recording that spans a profiled window lands on
the profiler's timeline, the spans of threads that the profiler does not
follow (those started before it, such as the service's worker and
completer) too.

The recording is process-wide, as the profiler's is: every thread of the
process records into it.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import List, Optional, Tuple

Span = Tuple[str, str, int, int, dict]

LIMIT = 1_000_000      # spans a recording holds (~40,000 in a 30-s serving window)

_enabled = False
_spans: List[Span] = []
_dropped = 0
_lock = threading.Lock()


def now() -> int:
    """The recorder's clock: the wall clock, nanoseconds."""
    return time.time_ns()


class _Off:
    """The span handed out while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    __slots__ = ("name", "ids", "start")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        self.start = now()
        return self

    def __exit__(self, *exc):
        _append(self.name, self.start, now(), self.ids)
        return False


def _ids(batch: Optional[int], request: Optional[int]) -> dict:
    ids = {}
    if batch is not None:
        ids["batch"] = int(batch)
    if request is not None:
        ids["request"] = int(request)
    return ids


def _append(name: str, start_ns: int, end_ns: int, ids: dict) -> None:
    global _dropped
    thread = threading.current_thread().name
    with _lock:
        if not _enabled:
            return
        if len(_spans) < LIMIT:
            _spans.append((name, thread, start_ns, end_ns, ids))
        else:
            _dropped += 1


def enabled() -> bool:
    """Whether a recording is on."""
    return _enabled


def span(name: str, batch: Optional[int] = None, request: Optional[int] = None):
    """A context manager that records ``name`` from its entry to its exit
    on the calling thread, while a recording is on."""
    if not _enabled:
        return _OFF
    return _Live(name, _ids(batch, request))


def record(name: str, start_ns: int, end_ns: int, batch: Optional[int] = None,
           request: Optional[int] = None) -> None:
    """Record a span stamped by the caller with ``now()``, on the calling
    thread, while a recording is on."""
    if _enabled:
        _append(name, int(start_ns), int(end_ns), _ids(batch, request))


def traced(name: str):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with _Live(name, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


def enable() -> None:
    """Start a recording, dropping what an earlier one left."""
    global _enabled, _dropped
    with _lock:
        _spans.clear()
        _dropped, _enabled = 0, True


def disable() -> None:
    """Stop recording; what was recorded stays for ``take()``.  A span open
    at this moment is not recorded."""
    global _enabled
    with _lock:
        _enabled = False


def take() -> Tuple[List[Span], int]:
    """(the spans recorded, in the order they ended; how many did not fit
    the limit), clearing both."""
    global _dropped
    with _lock:
        spans, dropped = list(_spans), _dropped
        _spans.clear()
        _dropped = 0
    return spans, dropped

"""Request-scoped tracing with Chrome-trace/Perfetto JSON export.

The port's own copy of ``repro.obs.trace``; its traces name the process
``repro_torch.serve``.

:class:`TraceRecorder` collects three kinds of events into a bounded
in-memory buffer:

* **Spans** — duration events on the calling thread, opened with the
  :meth:`TraceRecorder.span` context manager.  Nesting on one thread is
  expressed by containment (Chrome ``"X"`` complete events: ``ts`` +
  ``dur``), which is exactly how Perfetto reconstructs the stack.
* **Instant events** — point-in-time markers (``"i"``), either free-
  standing via :meth:`instant` or attached to an open span via
  :meth:`SpanHandle.event` (e.g. the coalescer's ``deadline_shed``).
* **Async events** — ``"b"``/``"n"``/``"e"`` pairs keyed by ``(cat, id)``
  for work that crosses threads, like one request's enqueue-on-client /
  dispatch-on-flusher lifetime.

Timestamps come from ``time.perf_counter()`` relative to the recorder's
construction, expressed in microseconds (the Chrome-trace unit).  Export
with :meth:`to_chrome_trace` / :meth:`write` and open the file in
`ui.perfetto.dev <https://ui.perfetto.dev>`__ or ``chrome://tracing``.

A disabled recorder (``TraceRecorder(enabled=False)``, or the shared
:data:`NULL_TRACER`) turns every call into a constant-time no-op — the
``span`` context manager returns a shared singleton and allocates
nothing — so instrumented hot paths pay nothing when tracing is off.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, Optional

__all__ = ["TraceRecorder", "SpanHandle", "NULL_TRACER"]


class SpanHandle:
    """Open span returned by :meth:`TraceRecorder.span`; lets the wrapped
    code attach args and instant events before the span closes."""

    __slots__ = ("_rec", "name", "cat", "_start_us", "_tid", "args")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 start_us: float, tid: int, args: Optional[dict]):
        self._rec = rec
        self.name = name
        self.cat = cat
        self._start_us = start_us
        self._tid = tid
        self.args = dict(args) if args else {}

    def add_args(self, **kw) -> None:
        self.args.update(kw)

    def event(self, name: str, args: Optional[dict] = None) -> None:
        """Instant event stamped inside this span (same thread lane)."""
        self._rec._emit({
            "name": name, "ph": "i", "s": "t", "cat": self.cat,
            "ts": self._rec._now_us(), "pid": self._rec.pid,
            "tid": self._tid, "args": args or {},
        })

    def close(self) -> None:
        self._rec._emit({
            "name": self.name, "ph": "X", "cat": self.cat,
            "ts": self._start_us,
            "dur": self._rec._now_us() - self._start_us,
            "pid": self._rec.pid, "tid": self._tid, "args": self.args,
        })


class _NullSpan:
    """Shared no-op stand-in for :class:`SpanHandle` when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add_args(self, **kw) -> None:
        pass

    def event(self, name: str, args: Optional[dict] = None) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager wrapping one live :class:`SpanHandle`."""

    __slots__ = ("_handle",)

    def __init__(self, handle: SpanHandle):
        self._handle = handle

    def __enter__(self) -> SpanHandle:
        return self._handle

    def __exit__(self, *exc) -> bool:
        self._handle.close()
        return False


class TraceRecorder:
    """Bounded, thread-safe trace-event buffer (see module docstring).

    ``max_events`` caps memory: the buffer is a ring, oldest events drop
    first (``dropped_events`` counts them).
    """

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = bool(enabled)
        self.pid = os.getpid()
        self._epoch = time.perf_counter()
        self._events: deque = deque(maxlen=max_events)
        self._n_emitted = 0
        self._lock = threading.Lock()
        self._thread_names: Dict[int, str] = {}

    # -- internals ---------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            self._n_emitted += 1

    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._n_emitted - len(self._events)

    def name_thread(self, name: str, tid: Optional[int] = None) -> None:
        """Label the current (or given) thread's lane in the trace UI."""
        if not self.enabled:
            return
        self._thread_names[tid if tid is not None else
                           threading.get_ident()] = name

    # -- spans -------------------------------------------------------------

    def span(self, name: str, cat: str = "serve",
             args: Optional[dict] = None):
        """``with rec.span("dispatch") as sp: ...`` — duration event on the
        calling thread; nested calls nest by containment."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(SpanHandle(self, name, cat, self._now_us(),
                                   threading.get_ident(), args))

    def instant(self, name: str, cat: str = "serve",
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._emit({
            "name": name, "ph": "i", "s": "t", "cat": cat,
            "ts": self._now_us(), "pid": self.pid,
            "tid": threading.get_ident(), "args": args or {},
        })

    # -- async (cross-thread) events --------------------------------------

    def async_begin(self, name: str, id: int, cat: str = "request",
                    args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._emit({
            "name": name, "ph": "b", "cat": cat, "id": id,
            "ts": self._now_us(), "pid": self.pid,
            "tid": threading.get_ident(), "args": args or {},
        })

    def async_instant(self, name: str, id: int, cat: str = "request",
                      args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._emit({
            "name": name, "ph": "n", "cat": cat, "id": id,
            "ts": self._now_us(), "pid": self.pid,
            "tid": threading.get_ident(), "args": args or {},
        })

    def async_end(self, name: str, id: int, cat: str = "request",
                  args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._emit({
            "name": name, "ph": "e", "cat": cat, "id": id,
            "ts": self._now_us(), "pid": self.pid,
            "tid": threading.get_ident(), "args": args or {},
        })

    # -- export ------------------------------------------------------------

    def events(self) -> Iterator[dict]:
        with self._lock:
            return iter(list(self._events))

    def to_chrome_trace(self) -> dict:
        """Chrome-trace JSON object: ``{"traceEvents": [...], ...}``.
        Metadata (``"M"``) events name the process and any labelled
        threads so Perfetto lanes are readable."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        meta = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": "repro_torch.serve"},
        }]
        for tid, name in sorted(names.items()):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": self.pid,
                "tid": tid, "args": {"name": name},
            })
        return {
            "traceEvents": meta + sorted(events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }

    def write(self, path: str, indent: Optional[int] = None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=indent)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._n_emitted = 0


#: Shared disabled recorder — the default everywhere tracing is optional.
NULL_TRACER = TraceRecorder(enabled=False, max_events=1)

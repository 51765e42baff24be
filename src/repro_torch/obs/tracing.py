"""Per-request span tracing with Chrome trace-event / Perfetto export; copy
of ``src/repro/obs/tracing.py`` (pure Python).

A :class:`Tracer` records two event shapes:

* **sync spans** (``tracer.span("kernel-execute", ...)``) — complete
  ``"ph": "X"`` events with microsecond ``ts``/``dur``, nested by time
  containment on their track (``tid``).  The serving engine emits
  ``batch`` > ``batch-assembly`` / ``kernel-execute`` / ``post-process`` /
  ``nand-billing`` on the engine track.
* **async spans** (``async_begin``/``async_end``) — ``"ph": "b"/"e"``
  event pairs keyed by ``id``, for intervals that overlap freely across
  requests (``queue-wait`` from ``submit`` to its batch's flush).

``export()`` returns the standard ``{"traceEvents": [...]}`` JSON object
(load it in ``chrome://tracing`` or https://ui.perfetto.dev), with process/
thread metadata events naming the tracks.

Zero-cost-when-off: a disabled tracer hands back one shared no-op span
object — no allocation, no clock read.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

ENGINE_TID = 0          # the serving engine's synchronous track


class _NullSpan:
    """Shared no-op span for disabled tracers (and a safe ``set`` sink)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass

    def end(self) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One in-flight sync span; closes into a complete ("X") trace event."""

    __slots__ = ("_tracer", "name", "cat", "tid", "args", "ts")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int,
                 args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self.ts = tracer._now_us()

    def set(self, **args) -> None:
        """Attach (or update) event args after the span opened."""
        self.args.update(args)

    def end(self) -> None:
        t = self._tracer
        t._events.append({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self.ts, "dur": max(t._now_us() - self.ts, 0.0),
            "pid": t.pid, "tid": self.tid, "args": self.args,
        })

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Tracer:
    def __init__(self, enabled: bool = True, pid: int = 0):
        self.enabled = enabled
        self.pid = pid
        self._epoch = time.perf_counter()
        self._events: List[dict] = []
        if enabled:
            self._meta("process_name", ENGINE_TID, name="repro-serving")
            self._meta("thread_name", ENGINE_TID, name="engine")

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _meta(self, kind: str, tid: int, **args) -> None:
        self._events.append({"name": kind, "ph": "M", "pid": self.pid,
                             "tid": tid, "args": args})

    # ------------------------------------------------------------ sync spans
    def span(self, name: str, cat: str = "serve", tid: int = ENGINE_TID,
             **args):
        """Context manager recording a complete event on track ``tid``."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, tid, args)

    # ----------------------------------------------------------- async spans
    def async_begin(self, name: str, id: int, cat: str = "request",
                    **args) -> None:
        if not self.enabled:
            return
        self._events.append({
            "name": name, "cat": cat, "ph": "b", "id": id,
            "ts": self._now_us(), "pid": self.pid, "tid": ENGINE_TID,
            "args": args,
        })

    def async_end(self, name: str, id: int, cat: str = "request",
                  **args) -> None:
        if not self.enabled:
            return
        self._events.append({
            "name": name, "cat": cat, "ph": "e", "id": id,
            "ts": self._now_us(), "pid": self.pid, "tid": ENGINE_TID,
            "args": args,
        })

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        """Zero-duration marker (consolidation points, warnings...)."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "cat": cat, "ph": "i", "s": "g",
            "ts": self._now_us(), "pid": self.pid, "tid": ENGINE_TID,
            "args": args,
        })

    # --------------------------------------------------------------- reading
    def events(self) -> List[dict]:
        return list(self._events)

    def export(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON object; written to ``path`` if given."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def clear(self) -> None:
        keep = [e for e in self._events if e.get("ph") == "M"]
        self._events = keep


#: the shared disabled tracer — every call is a no-op
NULL_TRACER = Tracer(enabled=False)

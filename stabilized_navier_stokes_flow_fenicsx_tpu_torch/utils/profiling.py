"""The port's tracer: spans and counters, and the device profile.

Counterpart of the JAX package's ``utils/profiling.py``.  The reference
brackets phases with wall-clock prints
(NavierStokesChannelFlow.py:289-299, streamtrace.py:221-249) and relies
on PETSc -ksp_monitor for solver residual histories.  Here:

* ``span(name, sync=None)`` (or the decorator ``traced(name)``) times a
  block on ``time.time_ns``, the clock of ``torch.profiler``'s events,
  so that program spans and device kernels share one timeline.  Each
  recorded span is a tuple
  ``(id, parent id, case id, name, t0_ns, t1_ns)`` in a bounded log
  (``spans()``); its parent is the innermost open span.  ``sync=device``
  waits for the device before the span closes; it is given only where
  the program synchronised anyway (the ``timings`` phases, the trace's
  walls).  The handle's ``seconds`` is the span's length, with
  recording on or off: ``ChannelSolution.timings`` and
  ``StreamtraceResult.stats`` are filled from it.
* A span named ``case`` (``apps/inlet_batch.py::run_trace_save``)
  groups everything under it.  When it closes, its spans' totals by
  name (inclusive, not counting a span inside one of the same name,
  and self time) and the counters' changes over it are kept as a
  ``Case`` (``cases()``).
* ``count(name, n=1, key=None)`` adds to a counter; ``read(t, convert)``
  is a blocking device->host read (``float(t)``, ``t.tolist()``,
  ``t.cpu()``...) and counts one ``host_reads`` under the innermost
  open span's name.  ``counts(name)`` reads a counter by key.
* ``device_trace(logdir)`` profiles a block with ``torch.profiler`` and
  writes ``<logdir>/trace.json`` with the block's spans as a host track
  above the device's kernels (Chrome tracing, Perfetto).

Recording is on by default and costs two clock reads and a tuple append
per span; ``set_enabled(False)`` stops it (the spans' ``seconds`` still
read).  The log holds Python numbers and strings only, never a tensor.
One thread records at a time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple

LOG_SPANS = 1 << 18            # the log keeps the last this many spans
KEEP_CASES = 256               # and the last this many cases

_log: "collections.deque[Tuple]" = collections.deque(maxlen=LOG_SPANS)
_cases: "collections.deque[Case]" = collections.deque(maxlen=KEEP_CASES)
_counts: Dict[Tuple[str, Hashable], int] = {}
_stack: List["_Span"] = []
_ids = itertools.count(1)
_enabled = True


@dataclasses.dataclass
class Case:
    """One closed ``case`` span: its interval, its spans' totals by name
    (seconds) and its counters' changes, by name then key."""

    id: int
    t0_ns: int
    t1_ns: int
    inclusive_s: Dict[str, float]
    self_s: Dict[str, float]
    counters: Dict[str, Dict[Hashable, int]]
    n_spans: int


class _Span:
    __slots__ = ("name", "sync", "id", "parent", "case", "nested", "t0",
                 "t1", "child_ns", "totals", "before")

    def __init__(self, name: str, sync):
        self.name, self.sync = name, sync
        self.id = None
        self.t1 = None

    def __enter__(self) -> "_Span":
        if _enabled:
            top = _stack[-1] if _stack else None
            self.id = next(_ids)
            self.parent = top.id if top else None
            self.nested = any(s.name == self.name for s in _stack)
            self.child_ns = 0
            if self.name == "case" and (top is None or top.case is None):
                self.case = self.id
                self.totals = {}
                self.before = dict(_counts)
            else:
                self.case = top.case if top else None
                self.totals = top.totals if top else None
            _stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.sync is not None and exc_type is None:
            from .device import sync
            sync(self.sync)
        self.t1 = t1 = time.time_ns()
        if self.id is None:
            return False
        _stack.pop()
        _log.append((self.id, self.parent, self.case, self.name, self.t0,
                     t1))
        dur = t1 - self.t0
        if _stack:
            _stack[-1].child_ns += dur
        if self.totals is not None:
            tot = self.totals.setdefault(self.name, [0, 0, 0])
            if not self.nested:
                tot[0] += dur
            tot[1] += dur - self.child_ns
            tot[2] += 1
        if self.case == self.id:
            _close_case(self)
        return False

    @property
    def seconds(self) -> float:
        """The span's length (s), once it has closed."""
        return (self.t1 - self.t0) / 1e9


def _close_case(s: _Span) -> None:
    counters: Dict[str, Dict[Hashable, int]] = {}
    for (name, key), n in _counts.items():
        d = n - s.before.get((name, key), 0)
        if d:
            counters.setdefault(name, {})[key] = d
    _cases.append(Case(
        s.id, s.t0, s.t1,
        {k: v[0] / 1e9 for k, v in s.totals.items()},
        {k: v[1] / 1e9 for k, v in s.totals.items()},
        counters, sum(v[2] for v in s.totals.values())))


def span(name: str, sync=None) -> _Span:
    """A context manager that records the block as a span named
    ``name``; ``sync``: a device to wait for before the span closes."""
    return _Span(name, sync)


def traced(name: str) -> Callable:
    """Decorator: record each call of the function as a span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with _Span(name, None):
                return fn(*args, **kw)
        return wrapped
    return deco


def count(name: str, n: int = 1, key: Hashable = None) -> None:
    """Add ``n`` to the counter ``name`` under ``key``."""
    if _enabled:
        k = (name, key)
        _counts[k] = _counts.get(k, 0) + n


def dtype_name(dtype) -> str:
    """``torch.float64`` -> ``"float64"`` (a launch key's dtype)."""
    return str(dtype).replace("torch.", "")


def read(t, convert: Callable = float):
    """``convert(t)``, a blocking device->host read of the tensor ``t``
    (``float``, ``int``, ``bool``, ``torch.Tensor.tolist``,
    ``torch.Tensor.cpu``), counted as one ``host_reads`` under the
    innermost open span's name."""
    if _enabled:
        k = ("host_reads", _stack[-1].name if _stack else None)
        _counts[k] = _counts.get(k, 0) + 1
    return convert(t)


def counts(name: str, since: Optional[Dict[Hashable, int]] = None
           ) -> Dict[Hashable, int]:
    """The counter ``name`` by key: since the process started, or its
    change from ``since`` (an earlier ``counts(name)``), keys that did
    not move left out."""
    since = since or {}
    out = {k: n - since.get(k, 0) for (c, k), n in _counts.items()
           if c == name}
    return {k: n for k, n in out.items() if n}


def cases() -> List[Case]:
    """The kept cases, oldest first."""
    return list(_cases)


def spans() -> List[Tuple]:
    """The kept spans, ``(id, parent id, case id, name, t0_ns, t1_ns)``
    in the order they closed."""
    return list(_log)


def set_enabled(on: bool) -> None:
    """Turn recording on or off (spans still time their blocks)."""
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when there is a card) and write ``<logdir>/trace.json`` with
    the block's program spans as a host track on the same clock; does
    nothing for ``logdir=None``."""
    if logdir is None:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    t0 = time.time_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = "program spans"
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": pid}})
    for sid, parent, case, name, s0, s1 in _log:
        if s0 >= t0:
            events.append({"ph": "X", "cat": "program", "name": name,
                           "pid": pid, "tid": 0, "ts": (s0 - base) / 1e3,
                           "dur": (s1 - s0) / 1e3,
                           "args": {"id": sid, "parent": parent,
                                    "case": case}})
    with open(path, "w") as f:
        json.dump(trace, f)

"""Spans at the stage boundaries of serving and training, and a count of
the host's waits on the device inside them.

``with span("serve.generate"): ...`` marks a stage.  A span is *off*
unless a ``torch.profiler`` is recording or the caller is inside
:func:`recording`: off, it costs a check of two module-level values and
returns a shared null context.  On, it

* enters ``torch._C._profiler._RecordFunctionFast(name)``, so the span is
  a ``cpu_op`` event of the profiler's trace (and of its Chrome export),
  on the profiler's clock, and never on the device's timeline;
* appends a :class:`Record` ``(name, parent, thread, t0_ns, t1_ns,
  syncs)`` to a bounded list in the process (:func:`records`,
  :func:`clear`), its times by ``time.time_ns()``, the clock the profiler
  stamps its events with.

Each thread has its own stack of open spans, so spans that autograd's
thread runs (the forward's recompute under ``remat``) do not nest under
the caller's.

The sync counter.  While any span is open, torch's sync debug mode is set
to warn (unless the caller set a mode of their own) and each of its
warnings is counted against the innermost open span of the thread that
raised it and not shown; autograd replays the warnings of its own
threads on the thread that called ``backward()``.  A wait that mode does
not see is counted where it is made, with :func:`add_syncs`.  A record's
``syncs`` are the waits while it was open, its children's included.

``kernels.LAUNCHES`` stays the one count of kernel launches.
"""

from __future__ import annotations

import collections
import contextlib
import re
import threading
import time
import warnings
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

#: the text of the warning that torch's sync debug mode raises
SYNC_MESSAGE = "called a synchronizing CUDA operation"
#: the records kept: the newest, once more spans than this have opened
MAX_RECORDS = 1 << 16


class Record(NamedTuple):
    name: str
    parent: Optional[str]   # the enclosing span on the same thread
    thread: int             # ``threading.get_ident()``
    t0_ns: int              # ``time.time_ns()`` at entry
    t1_ns: int              # and at exit
    syncs: int              # the host's waits while open, children's too


class _Null:
    """A span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()
_recording = 0              # depth of open recording() blocks
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()
_lock = threading.Lock()
_threads_open = 0           # threads with an open span: the counter is on
_set_mode = False           # the counter set the sync debug mode
_SYNC_FILTER_ARGS = ("always", SYNC_MESSAGE, UserWarning)
_SYNC_FILTER = ("always", re.compile(SYNC_MESSAGE, re.I), UserWarning, None,
                0)
_shown = warnings.showwarning


def span(name: str):
    """A context manager that marks the stage ``name`` (module
    docstring); the shared null context while tracing is off."""
    if _recording or _profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL


@contextlib.contextmanager
def recording():
    """Spans record inside this block without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def records() -> list:
    """The closed spans' :class:`Record` s, in the order they opened."""
    return [Record(*e) for e in list(_records) if e[4] is not None]


def clear() -> None:
    _records.clear()


def add_syncs(n: int) -> None:
    """Count ``n`` waits that torch's sync debug mode does not see against
    this thread's innermost open span (nothing while no span is open)."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1][5] += n


class _Span:
    __slots__ = ("_name", "_rf")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._rf = torch._C._profiler._RecordFunctionFast(self._name)
        self._rf.__enter__()
        # [name, parent, thread, t0_ns, t1_ns, syncs], closed at exit; the
        # times taken inside the profiler's event, next to its own stamps,
        # and outside the counter's switching
        entry = [self._name, stack[-1][0] if stack else None,
                 threading.get_ident(), time.time_ns(), None, 0]
        if not stack:
            _thread_opens()
        _records.append(entry)
        stack.append(entry)
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._rf.__exit__(*exc)
        stack = _local.stack
        entry = stack.pop()
        entry[4] = t1
        if stack:
            stack[-1][5] += entry[5]
        else:
            _thread_closes()
        return False


def _thread_opens() -> None:
    global _threads_open
    with _lock:
        _threads_open += 1
        if _threads_open == 1:
            _counter_on()


def _thread_closes() -> None:
    global _threads_open
    with _lock:
        _threads_open -= 1
        if _threads_open == 0:
            _counter_off()


def _counter_on() -> None:
    """Set the sync debug mode to warn, unless the caller set a mode, and
    make :func:`_count_sync` see each of its warnings.  The "always"
    filter for them and the hook stay once installed: putting a filter in
    or taking it out resets every module's record of the warnings it has
    shown, which would show those again at every unit."""
    global _shown, _set_mode
    if _SYNC_FILTER not in warnings.filters:
        warnings.filterwarnings(*_SYNC_FILTER_ARGS)
    if warnings.showwarning is not _count_sync:
        _shown = warnings.showwarning
        warnings.showwarning = _count_sync
    if torch.cuda.is_available() and torch.cuda.get_sync_debug_mode() == 0:
        torch.cuda.set_sync_debug_mode("warn")
        _set_mode = True


def _counter_off() -> None:
    global _set_mode
    if _set_mode:
        torch.cuda.set_sync_debug_mode(0)
        _set_mode = False


def _count_sync(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while installed: a sync warning raised while
    the counter is on is counted (on a thread with an open span) and not
    shown; every other warning goes to the hook it replaced."""
    if (_threads_open and issubclass(category, UserWarning)
            and str(message).startswith(SYNC_MESSAGE)):
        add_syncs(1)
        return
    _shown(message, category, filename, lineno, file, line)

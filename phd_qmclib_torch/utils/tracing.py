"""Spans at the layer boundaries of the block loop.

::

    from phd_qmclib_torch.utils import tracing

    with tracing.span(tracing.STEP_DMC):
        ...

Tracing is off by default: :func:`span` then tests one flag and returns
one shared context object that does nothing.  :func:`enable` turns it
on for the whole process, and each span then goes to exactly one sink,
chosen when it opens:

* while a ``torch.profiler`` session records, to that session, as a
  ``torch.profiler.record_function`` range: a ``user_annotation`` event
  of the Chrome trace, on the same clock as the kernels it launches;
* otherwise to an in-memory list of :class:`Span` records, timed by
  ``time.perf_counter_ns``, at most :data:`MAX_SPANS` of them (later
  spans are counted as dropped).  :func:`take` hands the list over and
  clears it; nothing is written to disk.

So host times that the profiler inflates never reach the in-memory
records.  The span names are the constants below; a span's parent is
the innermost span open in memory when it opened.
"""
import functools
import time
import typing as t

import torch

__all__ = ["BLOCK", "DENSITY", "G2", "ITC", "MAX_SPANS", "OBD", "RUN_DMC",
           "RUN_VMC", "SPANS", "SSF", "STEP_DMC", "STEP_VMC", "Span",
           "disable", "enable", "enabled", "span", "take", "traced"]

#: One measured block of ``qmc_exec``'s DMC and VMC loops: the sampler's
#: block and the accumulator's fold, not the checkpoint.
BLOCK = "qmc_exec.block"
#: A block's steps in the sampler, before its host copies.
RUN_DMC = "samplers.dmc.run"
RUN_VMC = "samplers.vmc.run"
#: One call of the sampler's step.
STEP_DMC = "samplers.dmc.step"
STEP_VMC = "samplers.vmc.step"
#: One evaluation of an estimator.
OBD = "estimators.obd"
SSF = "estimators.ssf"
G2 = "estimators.g2"
DENSITY = "estimators.density"
ITC = "estimators.itc"
SPANS = (BLOCK, RUN_DMC, RUN_VMC, STEP_DMC, STEP_VMC, OBD, SSF, G2, DENSITY,
         ITC)

#: The most spans the in-memory list holds between two :func:`take`.
MAX_SPANS = 1 << 18


class Span(t.NamedTuple):
    """One span held in memory: ``index`` numbers the spans in the order
    they opened, and ``parent`` is the index of the innermost span open
    in memory around it (``None`` at the top)."""
    name: str
    index: int
    parent: t.Optional[int]
    start_ns: int
    end_ns: int


class _Off:
    """The span of tracing off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_spans: t.List[tuple] = []  # the fields of the closed spans
_open: t.List[int] = []     # the indices of the spans open in memory
_opened = 0                 # spans opened in memory since the last take
_dropped = 0


class _Recorded:
    """A span of tracing on: to the profiler while one records, else to
    memory."""
    __slots__ = ("name", "profiled", "index", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _opened
        if torch.autograd.profiler._is_profiler_enabled:
            self.profiled = torch.profiler.record_function(
                self.name).__enter__()
            return self
        self.profiled = None
        self.index = _opened
        _opened += 1
        _open.append(self.index)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.profiled is not None:
            return self.profiled.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        _open.pop()
        if len(_spans) < MAX_SPANS:
            _spans.append((self.name, self.index,
                           _open[-1] if _open else None, self.start_ns,
                           end_ns))
        else:
            _dropped += 1
        return False


def span(name: str):
    """A context manager that records ``name`` where tracing is on."""
    if not _on:
        return _OFF
    return _Recorded(name)


def traced(name: str):
    """A decorator that runs each call of its function in a span
    ``name``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Recorded(name):
                return fn(*args, **kwargs)
        return call
    return decorate


def enable() -> None:
    """Turn tracing on for the process."""
    global _on
    _on = True


def disable() -> None:
    """Turn tracing off; the in-memory records stay until :func:`take`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> t.Tuple[t.List[Span], int]:
    """The in-memory spans, closed ones in the order they closed, and how
    many were dropped on a full list; both cleared.  Call it with no
    span open."""
    global _spans, _opened, _dropped
    spans, dropped = _spans, _dropped
    _spans, _opened, _dropped = [], 0, 0
    return [Span._make(fields) for fields in spans], dropped

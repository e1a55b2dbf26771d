"""Spans at the program's stages: a recorder on the host's clock that costs
a flag check when it is off.

    from mimo_ofdm_tpu_torch.utils import spans
    spans.enable()
    counters = frame_fn(snr_db, draws)
    recorded = spans.collect()          # [Span, ...] in the order they began
    spans.disable()

The program marks its stages with ``with span(name):`` (``PERF.md`` §3
lists the names and what reads them). Off, the default, :func:`span` hands
back the one shared :data:`OFF` object, whose ``with`` does nothing: no
profiler range, no NVTX range, no tensor op, no device sync, and nothing
kept or allocated. A span with counts builds a keyword dict and the counts
before the call, so its call site asks first:
``with span("chain", rows=n) if enabled() else OFF:``. On, entering a span
reads the clock and appends its record to one flat list, and leaving reads
the clock again. A span never reads a tensor, so it adds no host sync
either. Spans stay in memory until :func:`collect`.

Every span of one call of a frame function shares the call's round number,
taken when its ``frame`` span (:data:`ROUND_SPAN`) begins. The recorder
serves one thread, the one that enqueues the rounds.

``torch.profiler``'s Chrome trace writes ``ts`` in microseconds after the
trace's ``baseTimeNanoseconds``, on the wall clock (Unix time).
:func:`on_trace_clock` puts spans there. It reads the pair of clocks when it
is called, right after the traced window, because the wall clock may be
slewed against the monotonic one, and the nearer the anchor, the smaller
the error.

This module imports nothing of the port and nothing of torch, so that
every module of the port can import it.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

ROUND_SPAN = "frame"

_clock = time.perf_counter_ns
_on = False
# one flat list of the spans' fields, in the order the spans began: name, the
# number of counts, the parent's offset (-1 at the top), round, start_ns,
# end_ns, then each count's name and value
_rec: list = []
_open: list[int] = []          # offsets in _rec of the spans still open
_rounds = -1                   # the last round number handed out


class Span(NamedTuple):
    """One stage of one call. ``start_ns``/``end_ns`` are
    ``time.perf_counter_ns`` readings, ``parent`` the index of the enclosing
    span in the collected list (-1 at the top), ``round`` the number of the
    frame call it belongs to (-1 outside every frame), ``counts`` its
    integer counts."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    round: int
    counts: dict


class _On:
    """What :func:`span` hands back while the recorder is on. The record
    goes into one flat list of strings and ints, which the garbage
    collector neither tracks nor counts: a record kept as an object of its
    own, or a dict of counts, would set off the collector every few hundred
    spans, and now and then a full pass over the whole heap inside the
    traced window."""
    __slots__ = ("name", "counts")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self) -> None:
        global _rounds
        parent = _open[-1] if _open else -1
        rnd = _rec[parent + 3] if _open else -1
        if self.name == ROUND_SPAN:
            _rounds += 1
            rnd = _rounds
        _open.append(len(_rec))
        _rec.extend((self.name, len(self.counts), parent, rnd, _clock(), 0))
        for item in self.counts.items():
            _rec.extend(item)

    def __exit__(self, typ, value, tb) -> bool:
        _rec[_open.pop() + 5] = _clock()
        return False


class _Off:
    """What :func:`span` hands back while the recorder is off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, typ, value, tb) -> bool:
        return False


OFF = _Off()


def span(name: str, **counts):
    """A context manager around one stage: :data:`OFF` while the recorder
    is off, else one that records ``name`` and ``counts`` when the ``with``
    block runs."""
    if not _on:
        return OFF
    return _On(name, counts)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inside(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _On(name, {}):
                return fn(*args, **kwargs)
        return inside
    return wrap


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn the recorder on, with an empty record and round numbers from 0."""
    global _on, _rounds
    _rec.clear()
    _open.clear()
    _rounds = -1
    _on = True


def disable() -> None:
    """Turn the recorder off; what it recorded stays until :func:`collect`."""
    global _on
    _on = False


def collect() -> list[Span]:
    """The spans recorded since :func:`enable` or the last collect, in the
    order they began (their ``parent`` indices point into this list), and an
    empty record after. Call it with no span open."""
    global _rec
    if _open:
        raise RuntimeError(f"collect() inside {len(_open)} open span(s)")
    rec, _rec = _rec, []
    out, index, i = [], {}, 0
    while i < len(rec):
        name, n, parent, rnd, start, end = rec[i:i + 6]
        index[i] = len(out)
        out.append(Span(name, start, end, index.get(parent, -1), rnd,
                        dict(zip(rec[i + 6:i + 6 + 2 * n:2], rec[i + 7:i + 7 + 2 * n:2]))))
        i += 6 + 2 * n
    return out


class TraceSpan(NamedTuple):
    """A span on the Chrome trace's clock (microseconds, as ``ts``)."""
    start: float
    end: float
    name: str
    parent: int
    round: int
    counts: dict


def clock_offset_ns() -> int:
    """Wall clock minus ``time.perf_counter_ns``, from the closest of a few
    back-to-back readings."""
    best = None
    for _ in range(5):
        a = _clock()
        wall = time.time_ns()
        b = _clock()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def on_trace_clock(recorded: list[Span], base_time_ns: int) -> list[TraceSpan]:
    """``recorded`` on the clock of a Chrome trace whose
    ``baseTimeNanoseconds`` is ``base_time_ns``."""
    shift = clock_offset_ns() - base_time_ns
    return [TraceSpan((s.start_ns + shift) / 1e3, (s.end_ns + shift) / 1e3,
                      s.name, s.parent, s.round, s.counts) for s in recorded]

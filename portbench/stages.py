"""The port's own spans in the traced window, for the per-layer readers.

The port marks its frame's stages with a span recorder
(``mimo_ofdm_tpu_torch/utils/spans.py``; ``PERF.md`` §3 lists the names).
A reader gets the :class:`trace.TraceView`, which holds neither the spans
nor which host call launched each device operation, so this module takes
both from where a traced run leaves them:

* importing it in a ``python -m portbench.run ... --trace 1`` process turns
  the program's recorder on. The harness loads the readers before it
  builds the program, so the set-up spans are recorded too. The first read
  collects the spans and puts them on the trace's clock;
* the launches' correlation ids and the trace's ``baseTimeNanoseconds``
  come from the Chrome trace the run has just written,
  ``.cache/trace/<cell>.json.gz``.

An untraced run leaves the recorder off, and a port without the recorder
gives no spans: :func:`of` is then ``None``, and so is every reader of it.
:func:`attach` hands a view its spans directly (the tests do).

Attribution: a device operation (kernel, copy or set) belongs to the
innermost program span that holds the host runtime or driver call that
launched it, matched by ``correlation`` (the rule of the port's
``utils/profiling.device_work_by_class``, written again here). Work
launched outside every span, the harness's ``cat`` of the counters, is
:data:`UNSPANNED`. "Per round" is per ``frame`` span begun in the window.
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRACE_DIR = ROOT / ".cache" / "trace"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ROUND_SPAN = "frame"
UNSPANNED = "(outside every span)"
OUTSIDE_FRAME = "outside frame"

_cell: str | None = None       # the cell of this traced run, while the recorder is on
_since = 0.0                   # wall clock when it was turned on


def recorder():
    """The port's span recorder module, or ``None`` for a port without one."""
    try:
        from mimo_ofdm_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def traced_cell(argv: list[str]) -> str | None:
    """The cell of a ``python -m portbench.run ... --trace 1`` process."""
    if not argv or Path(argv[0]).resolve() != ROOT / "run.py":
        return None
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--trace", type=int, default=0)
    args, _ = ap.parse_known_args(argv[1:])
    return args.workload if args.trace == 1 else None


def enable(cell: str) -> bool:
    """Turn the program's recorder on for a traced run of ``cell``; False
    where the port has none."""
    global _cell, _since
    rec = recorder()
    if rec is None:
        return False
    rec.enable()
    _cell, _since = cell, time.time()
    return True


def disable() -> None:
    """Turn the program's recorder off and forget the cell."""
    global _cell
    rec = recorder()
    if rec is not None and _cell is not None:
        rec.disable()
        rec.collect()
    _cell = None


def launches(trace: dict) -> list[tuple[float, float, float | None]]:
    """Each device operation of ``trace`` as ``(start, end, launch)``: the
    ``ts`` of the runtime or driver call with its correlation id, or None."""
    launched_at, ops = {}, []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, corr = e.get("cat", ""), e.get("args", {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launched_at[corr] = float(e["ts"])
        elif cat in DEVICE_CATS:
            ops.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), corr))
    return [(s, t, launched_at.get(c)) for s, t, c in ops]


def innermost(spans: list, times: list[float]) -> list[int]:
    """For each time, the index in ``spans`` of the innermost span that holds
    it (-1 for none). Spans are ``(start, end, ...)`` and nest, as one
    thread's spans do."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][0], -spans[i][1]))
    by_time = sorted(range(len(times)), key=lambda k: times[k])
    out, stack, j = [-1] * len(times), [], 0
    for k in by_time:
        t = times[k]
        while j < len(order) and spans[order[j]][0] <= t:
            while stack and spans[stack[-1]][1] < spans[order[j]][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[k] = stack[-1] if stack else -1
    return out


class Stages:
    """The program's spans over one traced window, and the device work and
    idle time put down to them. Times in microseconds on the trace's
    clock; ``spans`` are ``(start, end, name, parent, round, counts)``."""

    def __init__(self, view, spans: list, ops: list[tuple[float, float, float | None]]):
        self.view, self.spans = view, spans
        w0, w1 = view.window
        self.frames = [sp for sp in spans if sp[2] == ROUND_SPAN and w0 <= sp[0] <= w1]
        self.names_in_window = {sp[2] for sp in spans if w0 <= sp[0] <= w1}
        owner = innermost(spans, [t if t is not None else float("-inf") for _, _, t in ops])
        self.device_us: dict[str, float] = defaultdict(float)
        for (s, e, _), i in zip(ops, owner):
            self.device_us[spans[i][2] if i >= 0 else UNSPANNED] += e - s

    @property
    def rounds(self) -> int:
        return len(self.frames)

    def device_ms_per_round(self, names) -> float | None:
        """Device ms a round of the work launched inside spans ``names``
        (innermost); None without device work or unless such a span began
        in the window."""
        if (not self.view.device_ops or not self.rounds
                or not self.names_in_window & set(names)):
            return None
        return sum(self.device_us.get(n, 0.0) for n in names) / 1e3 / self.rounds

    def idle_in_frame_us(self) -> float:
        """Idle device time while the host is inside a ``frame`` span."""
        frames = sorted((sp[0], sp[1]) for sp in self.frames)
        total, i = 0.0, 0
        for s, e in self.view.idle_gaps():
            while i < len(frames) and frames[i][1] <= s:
                i += 1
            k = i
            while k < len(frames) and frames[k][0] < e:
                total += min(e, frames[k][1]) - max(s, frames[k][0])
                k += 1
        return total

    def idle_by_span(self) -> dict[str, float]:
        """Idle seconds by the innermost program span open at each gap's
        middle, else :data:`OUTSIDE_FRAME`."""
        gaps = self.view.idle_gaps()
        owner = innermost(self.spans, [(s + e) / 2 for s, e in gaps])
        out: dict[str, float] = defaultdict(float)
        for (s, e), i in zip(gaps, owner):
            out[self.spans[i][2] if i >= 0 else OUTSIDE_FRAME] += (e - s) / 1e6
        return dict(out)

    def setup_s(self) -> float | None:
        """Host seconds inside the program's top-level spans that end before
        the window: building the frame function and the warm-up rounds."""
        before = [sp for sp in self.spans if sp[3] == -1 and sp[1] < self.view.window[0]]
        if not before:
            return None
        return sum(sp[1] - sp[0] for sp in before) / 1e6


def attach(view, trace: dict, spans: list) -> Stages:
    """Give ``view`` the program's ``spans``, in the order they began and
    already on the clock of ``trace`` (the Chrome trace the view was read
    from)."""
    st = Stages(view, list(spans), launches(trace))
    view.__dict__["_stages"] = st
    return st


def _from_this_run(view) -> Stages | None:
    """The spans this traced run recorded, with the trace it wrote."""
    rec = recorder()
    if _cell is None or rec is None:
        return None
    path = TRACE_DIR / f"{_cell}.json.gz"
    if not path.exists() or path.stat().st_mtime < _since:
        return None
    try:
        recorded = rec.collect()
    except RuntimeError:
        return None
    rec.disable()
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    spans = rec.on_trace_clock(recorded, int(trace.get("baseTimeNanoseconds", 0)))
    return attach(view, trace, [tuple(sp) for sp in spans])


def of(view) -> Stages | None:
    """The program's spans over ``view``'s window, or None without them."""
    if "_stages" not in view.__dict__:
        view.__dict__["_stages"] = _from_this_run(view)
    return view.__dict__["_stages"]


_traced = traced_cell(sys.argv)
if _traced is not None:
    enable(_traced)

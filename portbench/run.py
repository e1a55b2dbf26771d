"""The port's benchmark: frames/s of the CNC/MCNC Monte-Carlo round on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json`` (its parts found by name, see
``spec.py``):

1. points the kernel build and every compiler cache at fixed directories
   under ``portbench/.cache/``, so that only a checkout's first run builds;
2. builds the port's frame function for the cell's configuration and
   receiver, through the configuration's frame family (``frames/``: the
   single-user ``models.link.make_frame_fn`` unless it names another);
3. draws a pool of distinct rounds of inputs on the card from ``--seed``
   (``traffic.py`` and the family's ``draw_round``), and warms up the
   cell's one shape;
4. measures for ``--seconds``: a closed loop with the traffic's rounds in
   flight, each round ``frame_fn(snr_db, draws)`` on the next pool slot,
   its per-frame counters (per user, in a multi-user family) copied to
   pinned memory and waited on through the round's own event (the port's
   ``bench.py`` fetch). ``frames_per_s`` is every frame whose counters
   reached the host, over the time from the window's start to the last of
   them. With ``--trace 1`` the window (at most :data:`TRACE_SECONDS`)
   runs under ``torch.profiler``, recording the card's activity, and the
   per-layer metrics are read from its Chrome trace instead;
5. reads the peak memory, frees the program's state, and compares the
   counters of a sample of the window's frames, drawn from the seed, with
   the plain reference's on the same draws (``check.py``; each user's
   counters of a frame are a row of their own);
6. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then ``card``
   (the card's name and power limit) and, last, ``checks``: each number
   compared with its limit. The same numbers end standard error.

It exits non-zero without a result when there is no card, fewer cards than
the cell asks for, or when JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "mimo_ofdm_tpu")
TRACE_SECONDS = 2.0
WARMUP_ROUNDS = 3
CHECK_FRAMES = 512         # window frames compared with the reference
CHECK_BLOCK = 32           # frames the reference takes at once


def process_age() -> float:
    """Seconds since this process started (0 where ``/proc`` cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T0 = _T_START - process_age()


def use_cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


class Harness:
    """One cell's program, inputs and window on one device."""

    def __init__(self, cell, seed: int, device):
        import torch

        from portbench import traffic

        self.torch = torch
        self.cell, self.seed = cell, seed
        self.dev = torch.device(device)
        tr = cell.traffic
        self.frames, self.depth, self.snr_db = (tr["frames_per_round"], tr["rounds_in_flight"],
                                                float(tr["snr_db"]))
        fam = cell.frame
        self.frame_fn = fam.build(cell.link, cell.n_iters, self.dev, **cell.frame_args)
        self.pool = traffic.make_pool(cell.link, tr, seed, self.dev,
                                      functools.partial(fam.draw_round, **cell.frame_args))
        self.draws = [fam.to_draws(d) for d in self.pool]
        self.frame_host_s = 0.0            # host clock inside the frame calls

    def launch(self, i: int):
        """Enqueue round ``i`` on pool slot ``i % len(pool)``: returns
        ``(host counters, event, slot)``, the counters ``[frames, ...,
        n_iters + 2]`` (the family's ``counters``) copied to pinned memory
        behind the round and followed by the round's own event."""
        torch = self.torch
        slot = i % len(self.draws)
        t = time.perf_counter()
        c = self.frame_fn(self.snr_db, self.draws[slot])
        self.frame_host_s += time.perf_counter() - t
        out = self.cell.frame.counters(c)
        if out.device.type != "cuda":
            return out, None, slot
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, slot

    def warm_up(self) -> None:
        """The cell's shape through the same path as the window."""
        pending = [self.launch(i) for i in range(WARMUP_ROUNDS)]
        for host, done, _ in pending:
            if done is not None:
                done.synchronize()
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def window(self, seconds: float) -> dict:
        """The closed loop for ``seconds``: rounds in flight up to the
        traffic's depth, each consumed in order through its own event.
        Returns the counted rounds ``[(slot, per-frame counters)]``, the
        counted frames' rate and, for the profiler, every round launched and
        the host seconds spent inside the port's frame calls."""
        counted, pending = [], deque()
        launched, self.frame_host_s = 0, 0.0
        t0 = time.perf_counter()
        deadline, t_last = t0 + seconds, t0
        while True:
            while len(pending) < self.depth and time.perf_counter() < deadline:
                pending.append(self.launch(launched))
                launched += 1
            if not pending:
                break
            host, done, slot = pending.popleft()
            if done is not None:
                done.synchronize()
            now = time.perf_counter()
            if now <= deadline:
                counted.append((slot, host.numpy().copy()))
                t_last = now
        frames = len(counted) * self.frames
        return {"rounds": counted, "frames": frames, "launched": launched,
                "host_s": self.frame_host_s,
                "frames_per_s": frames / (t_last - t0) if frames else 0.0}

    def free_program(self) -> None:
        self.frame_fn = None
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def sample(self, counted: list) -> tuple[list[tuple[int, int]], "np.ndarray"]:
        """Frames of the window drawn from the seed, :data:`CHECK_FRAMES` of them
        at most, each pool frame once: ``(picks [(slot, frame)], the
        program's counters [rows, n_iters + 2])``, every axis but the last
        flattened (a row a frame, or a row a user of each frame)."""
        import numpy as np

        from portbench import traffic

        rng = np.random.default_rng(traffic.round_seed(self.seed, -1))
        n = len(counted) * self.frames
        order = rng.permutation(n)
        picks, rows, seen = [], [], set()
        for k in order:
            r, f = divmod(int(k), self.frames)
            slot = counted[r][0]
            if (slot, f) in seen:
                continue
            seen.add((slot, f))
            picks.append((slot, f))
            rows.append(counted[r][1][f])
            if len(picks) == CHECK_FRAMES:
                break
        rows = np.array(rows, np.int64)
        return picks, rows.reshape(-1, rows.shape[-1]) if rows.size else rows

    def reference(self, picks: list[tuple[int, int]], planes: str = "float32"):
        """The plain reference's counters of the frames ``picks``, flattened
        as :meth:`sample` flattens the program's."""
        import numpy as np

        from portbench import traffic

        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = []
        with torch.no_grad():
            for i in range(0, len(picks), CHECK_BLOCK):
                d = traffic.gather(self.pool, picks[i:i + CHECK_BLOCK])
                c = self.cell.reference.frame_counters(
                    self.cell.link, self.cell.traffic["receiver"], self.cell.n_iters,
                    self.snr_db, d, planes=planes, **self.cell.frame_args)
                out.append(c.cpu().numpy().reshape(-1, c.shape[-1]))
        return np.concatenate(out).astype(np.int64)


def read_trace(prof, win: dict, cell) -> tuple[dict, dict, dict]:
    """The per-layer metrics, ``busy_s``/``window_s`` and the breakdown of
    the traced window."""
    from portbench import trace as trace_mod

    path = CACHE / "trace" / f"{cell.name}.json.gz"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    view = trace_mod.TraceView.from_trace(
        trace_mod.load(path), rounds=win["launched"], host_frame_s=win["host_s"],
        link=cell.link, traffic=cell.traffic, readers=cell.readers)
    metrics = {}
    for m in cell.per_layer:
        v = m.read(view)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    device = {"busy_s": view.busy_us() / 1e6, "window_s": view.window_us / 1e6}
    return metrics, device, view.breakdown()


def run(cell_name: str, seed: int, seconds: float, traced: bool, *, device="cuda",
        benchmark=None, root=None) -> dict:
    """One run of a cell; returns the result line's object."""
    from portbench import check, spec

    use_cache_dirs()
    import torch

    from mimo_ofdm_tpu_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache(str(CACHE / "build"))
    cell = spec.load_cell(cell_name, benchmark or spec.BENCHMARK, root or spec.ROOT)
    h = Harness(cell, seed, device)
    h.warm_up()
    setup_s = time.perf_counter() - _T0
    on_card = h.dev.type == "cuda"
    if traced:
        # on the card the device's activity alone: recording every host op
        # would double the host's cost a launch and idle a device-bound round
        acts = [torch.profiler.ProfilerActivity.CUDA if on_card
                else torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            win = h.window(min(seconds, TRACE_SECONDS))
    else:
        win = h.window(seconds)
    peak = torch.cuda.max_memory_allocated(h.dev) if on_card else 0
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(h.dev) if on_card else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": win["frames"], "failed": 0, "metrics": {},
              "device": dev_info}
    if traced:
        metrics, busy, breakdown = read_trace(prof, win, cell)
        del prof
        result["metrics"] = metrics
        dev_info.update(busy)
        result["breakdown"] = breakdown
    else:
        # an end-to-end metric's quantity is its name up to the first dot; the
        # rest names the group of cells whose bound it carries
        values = {"frames_per_s": win["frames_per_s"], "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": float(values[m["name"].split(".")[0]]),
                                         "unit": m["unit"]} for m in cell.end_to_end}
    h.free_program()
    picks, program = h.sample(win["rounds"])
    if not picks:
        raise RuntimeError("no round completed inside the window")
    found = check.numbers(program, h.reference(picks))
    correct, checks = check.judge(found, cell.limits)
    result["correct"] = bool(correct)
    result["card"] = card() if on_card else "cpu"
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run imported {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

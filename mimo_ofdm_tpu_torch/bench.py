"""The port's headline benchmark (port of the root ``bench.py``):
frames/s of bench.py's Rayleigh CNC/MCNC frame on the card.

    python -m mimo_ofdm_tpu_torch.bench

Workload = bench.py's (``bench.py:66-114``): ``canonical_miso_cnc()`` with
the Rayleigh channel rerolled per frame: 64-QAM, n_fft 4096, n_sc 2048,
64-antenna ULA, MRT, soft limiter at IBO 0 dB, bf16 planes, a clean run
and an 8-iteration CNC receive per frame, SNR 15 dB. The MCNC arm is the
same frame with the MCNC receiver. Rounds are ``models.link.make_round_fn``
rounds, which run the fused CUDA kernel (``csrc/fused_pa.cu``) 10 times a
round on each arm.

Prints ONE JSON line with bench.py's keys and meanings (``metric``,
``value``, ``unit``, ``vs_baseline``, ``windows``, ``mcnc_frames_per_s``,
``mcnc_windows``) and ``device``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them. ``value`` and ``mcnc_frames_per_s`` are the medians of interleaved
CNC and MCNC windows; ``vs_baseline`` divides by the reference-style CPU
implementation (``utils/baseline_cpu.py``) measured on this host and
cached in ``mimo_ofdm_tpu_torch/_build/``, keyed by the configuration and
the host CPU's model name.

Environment knobs, with bench.py's names and meanings: ``BENCH_BATCH``
and ``BENCH_MCNC_BATCH`` (frames a round of each arm; defaults
:data:`DEFAULT_BATCH`, measured on the H100 with :func:`batch_table`),
``BENCH_PIPELINE_DEPTH`` (rounds in flight, 3), ``BENCH_WINDOWS`` (7),
``BENCH_WINDOW_S`` (3.0) and ``BENCH_SKIP_MCNC`` (any value skips the MCNC
arm). Runs on ``cuda``; without a card it raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
from pathlib import Path

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models.link import make_round_fn
from mimo_ofdm_tpu_torch.utils import baseline_cpu, profiling
from mimo_ofdm_tpu_torch.utils.config import (ChannelConfig, LinkConfig,
                                              canonical_miso_cnc)
from mimo_ofdm_tpu_torch.utils.device import resolve_device

N_ITERS = 8
SNR_DB = 15.0
KEY = 0
# each arm's first round index (bench.py:106-114): arm i's windows start at
# offset + 100 * w, its warm-up rounds at 0 and offset + 1000..1003
ARM_OFFSETS = {"cnc": 10_000, "mcnc": 30_000}
# frames a round, the best of interleaved medians at 128, 256 and 512 on
# an NVIDIA H100 80GB HBM3 at 700 W (batch_table; PERF.md)
DEFAULT_BATCH = {"cnc": 512, "mcnc": 512}
BASELINE_CACHE = Path(__file__).resolve().parent / "_build" / "baseline_cpu.json"


def workload() -> LinkConfig:
    """bench.py's CNC arm: the canonical config on the Rayleigh channel."""
    cfg, _ = canonical_miso_cnc()
    return cfg.replace(channel=ChannelConfig(model="rayleigh"))


def arm_config(cfg: LinkConfig, arm: str) -> LinkConfig:
    """``cfg`` with the arm's receiver (``"cnc"`` or ``"mcnc"``)."""
    return cfg.replace(rx=dataclasses.replace(cfg.rx, algorithm=arm))


def _measure_window(round_fn, consume, key_base, snr, batch, window_s, depth,
                    fold_offset):
    """One pipelined measurement window (``bench.py:33-51``): ``depth``
    rounds in flight, consumed in order; returns (frames/s, rounds)."""
    t0 = time.perf_counter()
    n_rounds = 0
    pending = []
    for _ in range(depth - 1):
        pending.append(round_fn(key_base, fold_offset + n_rounds, snr))
        n_rounds += 1
    while time.perf_counter() - t0 < window_s:
        pending.append(round_fn(key_base, fold_offset + n_rounds, snr))
        n_rounds += 1
        consume(pending.pop(0))
    for p in pending:
        consume(p)
    dt = time.perf_counter() - t0
    return n_rounds * batch / dt, n_rounds


def fetching(round_fn):
    """``round_fn`` whose counters start their copy to the host as soon as
    the round is enqueued, followed by an event. A blocking fetch of round
    k on the one CUDA stream would also wait for every round enqueued after
    it, so the rounds in flight would drain at every fetch; waiting on the
    round's own event waits for round k alone, as JAX's fetch does. A CPU
    round's counters are returned as they are."""
    def issue(key, idx, snr):
        c = round_fn(key, idx, snr)
        if c.device.type != "cuda":
            return c, None
        host = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
        host.copy_(c, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    return issue


def consumer(tally: dict):
    """``consume(p)`` of a :func:`fetching` round: waits for that round's
    counters and returns the first (``bench.py:90-94``); it also counts the
    round in ``tally["rounds"]`` and adds its counters ``[clean,
    it0..it8]`` to ``tally["counters"]``."""
    def consume(p):
        c, done = p
        if done is not None:
            done.synchronize()
        counts = c.tolist()
        tally["rounds"] += 1
        tally["counters"] = [a + b for a, b in zip(tally["counters"], counts)]
        return counts[0]
    return consume


def interleaved(arms, n_windows: int, window_s: float, tallies: dict | None = None
                ) -> dict[str, list[float]]:
    """Warm up each arm, then ``n_windows`` windows of each in turn (a, b, a,
    b, ...), so every arm samples the same drift (``bench.py:116-133``).
    ``arms`` holds ``(name, round_fn, batch, offset, depth)``. A window
    starts at ``offset + 100 * w`` or after the arm's previous window,
    whichever is later, so no round index repeats within an arm; an arm
    whose windows reach the next arm's offset raises. Returns each arm's
    frames/s per window; ``tallies``, when given, receives each arm's
    rounds and summed counters, warm-up included (see :func:`consumer`)."""
    tallies = {} if tallies is None else tallies
    offsets = sorted(off for *_, off, _ in arms)
    runs = []
    for name, fn, batch, off, depth in arms:
        tallies[name] = {"rounds": 0, "counters": [0] * (N_ITERS + 2)}
        issue, consume = fetching(fn), consumer(tallies[name])
        consume(issue(KEY, 0, SNR_DB))       # kernel build, allocator
        for w in [issue(KEY, off + 1000 + i, SNR_DB) for i in range(4)]:
            consume(w)
        limit = next((o for o in offsets if o > off), None)
        runs.append([name, issue, consume, batch, off, depth, limit, off])
    windows = {name: [] for name, *_ in arms}
    for w in range(n_windows):
        for run in runs:
            name, issue, consume, batch, off, depth, limit, nxt = run
            start = max(off + 100 * w, nxt)
            fps, n = _measure_window(issue, consume, KEY, SNR_DB, batch, window_s,
                                     depth, fold_offset=start)
            run[-1] = start + n
            if limit is not None and start + n > limit:
                raise RuntimeError(f"arm {name}'s round indices reached {start + n}, "
                                   f"past the next arm's offset {limit}: shorten the windows")
            windows[name].append(round(fps, 2))
    return windows


def cpu_model() -> str:
    """The host CPU's model name; where the kernel reports none (``unknown``
    on some virtual machines), its vendor, family, model and stepping."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                      # the first processor's block
                k, _, v = line.partition(":")
                info[k.strip()] = v.strip()
    except OSError:
        pass
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family')} "
                f"model {info.get('model')} stepping {info.get('stepping')}")
    return platform.processor() or platform.machine()


def baseline_frames_per_s(cfg: LinkConfig, n_iters: int = N_ITERS,
                          path: Path = BASELINE_CACHE) -> float:
    """Frames/s of the reference-style CPU implementation on this host,
    read from ``path`` when it holds this configuration and CPU model, else
    measured and added there."""
    cpu = cpu_model()
    key = json.dumps({"config": dataclasses.asdict(cfg), "n_iters": n_iters,
                      "cpu": cpu}, sort_keys=True)
    path = Path(path)
    cache = json.loads(path.read_text()) if path.exists() else {}
    if key not in cache:
        cache[key] = {"frames_per_s": baseline_cpu.measure_baseline_frames_per_s(cfg, n_iters),
                      "cpu": cpu}
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(cache, indent=1))
        os.replace(tmp, path)
    return cache[key]["frames_per_s"]


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    host CPU's model name for a CPU run."""
    return profiling.card() if dev.type == "cuda" else f"cpu: {cpu_model()}"


def run(cfg: LinkConfig, batch: int, mcnc_batch: int | None, *, n_windows: int = 7,
        window_s: float = 3.0, depth: int = 3, device=None,
        baseline_path: Path = BASELINE_CACHE, tallies: dict | None = None) -> dict:
    """The benchmark: interleaved windows of the CNC arm of ``cfg`` at
    ``batch`` frames a round and, unless ``mcnc_batch`` is None, its MCNC
    arm; returns bench.py's output dict plus ``device``. ``tallies``, when
    given, receives each arm's rounds and summed counters, warm-up
    included (see :func:`consumer`). Runs on ``device`` (``cuda`` unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    arms = [("cnc", make_round_fn(arm_config(cfg, "cnc"), N_ITERS, batch, device=dev),
             batch, ARM_OFFSETS["cnc"], depth)]
    if mcnc_batch is not None:
        arms.append(("mcnc", make_round_fn(arm_config(cfg, "mcnc"), N_ITERS, mcnc_batch,
                                           device=dev),
                     mcnc_batch, ARM_OFFSETS["mcnc"], depth))
    windows = interleaved(arms, n_windows, window_s, tallies)
    frames_per_s = float(np.median(windows["cnc"]))
    baseline = baseline_frames_per_s(cfg, N_ITERS, baseline_path)
    out = {
        "metric": "canonical_miso_cnc_frames_per_s",
        "value": round(frames_per_s, 2),
        "unit": "frames/s",
        "vs_baseline": round(frames_per_s / baseline, 2),
        "windows": windows["cnc"],
    }
    if mcnc_batch is not None:
        out["mcnc_frames_per_s"] = float(np.median(windows["mcnc"]))
        out["mcnc_windows"] = windows["mcnc"]
    out["device"] = device_name(dev)
    return out


def settings(env=None) -> dict:
    """:func:`run`'s batches and window settings from bench.py's
    environment knobs."""
    env = os.environ if env is None else env
    return {
        "batch": int(env.get("BENCH_BATCH", DEFAULT_BATCH["cnc"])),
        "mcnc_batch": (None if env.get("BENCH_SKIP_MCNC")
                       else int(env.get("BENCH_MCNC_BATCH", DEFAULT_BATCH["mcnc"]))),
        "depth": int(env.get("BENCH_PIPELINE_DEPTH", "3")),
        "n_windows": int(env.get("BENCH_WINDOWS", "7")),
        "window_s": float(env.get("BENCH_WINDOW_S", "3.0")),
    }


def batch_table(batches=(128, 256, 512), depths=(3,), n_windows: int = 7,
                window_s: float = 3.0, device=None) -> dict:
    """Interleaved medians of both arms of :func:`workload` at every batch
    and pipeline depth, all windows in one round-robin: the measurement
    behind :data:`DEFAULT_BATCH` and the default depth. Returns
    ``{"device": ..., "cnc": {"<batch>/<depth>": {"median", "windows"}},
    "mcnc": ...}``."""
    dev = resolve_device(device)
    cfg = workload()
    arms = []
    for arm in ("cnc", "mcnc"):
        for b in batches:
            fn = make_round_fn(arm_config(cfg, arm), N_ITERS, b, device=dev)
            for d in depths:
                arms.append((f"{arm} {b}/{d}", fn, b, 10_000 + 20_000 * len(arms), d))
    windows = interleaved(arms, n_windows, window_s)
    table = {"device": device_name(dev), "cnc": {}, "mcnc": {}}
    for name, w in windows.items():
        arm, cell = name.split()
        table[arm][cell] = {"median": float(np.median(w)), "windows": w}
    return table


def main() -> None:
    # the kernel's build directory, as bench.py turns on XLA's compile cache
    from mimo_ofdm_tpu_torch.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    print(json.dumps(run(workload(), **settings())))


if __name__ == "__main__":
    main()

"""Where a round's device time goes: ``torch.profiler`` over a few
Monte-Carlo rounds on the card: bench.py's Rayleigh frame, the repo's
canonical configuration (LOS, RX rerolled per frame), its two-path
variant, the canonical LOS on the complex64 branch (f32 chain), the TR
38.901 TDL and GSCM (uma_los) channels, the multi-user link of
``multiuser_ber`` (2 users, MRT; CNC and MCNC-MU), and the coded frames
(``coded``: ``ldpc_ref_ber`` at 64 antennas, rate 1/2, 8 iterations, 12
sum-product iterations; ``ldpc_in_loop_ber``'s defaults; the raw IRA
codeword of ``ldpc_coded_ber(family="ira")``).

    python -m mimo_ofdm_tpu_torch.utils.profiling [--batch 128] [--rounds 3] [--frames tdl,mu,coded]

Prints one JSON line per frame and arm with the wall time per round, the
device-busy time per round (sum of kernel durations), the idle share (the
union of the device's operations over the traced window), the kernels that
take most device time, grouped by name, and what the chain calls cost: the
device ms of the work launched inside the program's ``chain`` spans
(``utils/spans.py``: the planar TX and MCNC passes, and the complex-ended
calls ``transmit.ifft_pa_fft_sc``/``ifft_pa_fft``), the fused kernel's
share of it, and the ms and launches of the rest, the conversions around
the kernel; for the coded frames the device time by span (``decode``,
``soft_demap``, ``chain``, the rest), the chain's conversions, the kernel
launches and the peak device memory of a round instead. The profiles turn
the program's span recorder on while they trace. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch

from mimo_ofdm_tpu_torch.models import link, link_ldpc, link_mu
from mimo_ofdm_tpu_torch.utils import config, spans


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


@contextlib.contextmanager
def wallclock(label: str = "", verbose: bool = True):
    """Wall-clock bracket in the reference's print format
    (``mimo_ofdm_tpu/utils/profiling.py:12-18``). It times the host: work
    queued on a CUDA stream inside it is timed only if the body waits for
    it."""
    t0 = time.time()
    yield
    if verbose:
        print(f"--- Computation time: {time.time() - t0:f} --- {label}")


@contextlib.contextmanager
def trace(logdir: str = "mimo_ofdm_tpu_torch_trace"):
    """``torch.profiler`` over the body, CPU and (with a card) CUDA
    activities; on exit the Chrome trace is written to
    ``logdir/trace.json`` (open it in ``chrome://tracing`` or Perfetto).
    Yields the profiler. The JAX package's ``jax.profiler`` counterpart is
    ``mimo_ofdm_tpu/utils/profiling.py:21-38``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class ThroughputMeter:
    """Frames/s and bits/s counter for sweep points
    (``mimo_ofdm_tpu/utils/profiling.py:41-60``), on the host's clock."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.frames = 0
        self.bits = 0

    def add(self, frames: int, bits: int):
        self.frames += frames
        self.bits += bits

    @property
    def frames_per_s(self) -> float:
        return self.frames / max(time.perf_counter() - self.t0, 1e-9)

    @property
    def bits_per_s(self) -> float:
        return self.bits / max(time.perf_counter() - self.t0, 1e-9)


def _kernel_times(prof) -> dict[str, list[float]]:
    """Device time (us) and count of every kernel in the trace, by name."""
    out: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        out[evt.key][0] += t
        out[evt.key][1] += evt.count
    return out


FUSED_KERNEL = "fused_ifft_pa_fft"      # the fused kernel's name, in every instantiation
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# the program's spans (utils/spans.py) that the profiles split device work by
CHAIN_SPANS = ("chain",)
CODED_SPANS = ("decode", "soft_demap", "chain")


@contextlib.contextmanager
def recording():
    """The program's span recorder on, from an empty record, while the block
    runs; yields the list that receives the block's spans."""
    was_on = spans.enabled()
    spans.enable()
    out: list = []
    try:
        yield out
    finally:
        out.extend(spans.collect())
        if not was_on:
            spans.disable()


def _trace_work(prof, recorded, labels) -> dict:
    """:func:`device_work_by_class` and :func:`idle_share` of the
    profiler's Chrome trace, with the spans ``recorded`` in its window."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    on_trace = spans.on_trace_clock(recorded, int(trace.get("baseTimeNanoseconds", 0)))
    return {"work": device_work_by_class(trace, on_trace, labels),
            "idle_share": idle_share(trace)}


def chain_costs(work: dict, rounds: int) -> dict:
    """A round's chain device ms, the fused kernel's ms in it, and the ms
    and launches of the conversions around it (the chain's other work)."""
    c = work["chain"]
    return {"chain_ms_per_round": c["ms"] / rounds,
            "chain_fused_ms_per_round": c["fused_ms"] / rounds,
            "conversion_ms_per_round": (c["ms"] - c["fused_ms"]) / rounds,
            "conversion_launches_per_round": (c["kernels"] - c["fused_kernels"]) / rounds}


def profile_round(cfg: config.LinkConfig, n_iters: int, batch: int,
                  rounds: int, device="cuda", top: int = 12) -> dict:
    """Profile ``rounds`` rounds after two warm-up rounds; a config with
    several users profiles ``link_mu``'s round at its default two-user
    geometry. The program's ``chain`` spans tell the chain calls' work, and
    so their conversions, apart."""
    make = link_mu.make_mu_round_fn if cfg.modem.n_users > 1 else link.make_round_fn
    round_fn = make(cfg, n_iters, batch, device=device)
    for i in range(2):
        round_fn(1, 1000 + i, 15.0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with recording() as recorded, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            round_fn(1, i, 15.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kt = _kernel_times(prof)
    busy_us = sum(v[0] for v in kt.values())
    ranked = sorted(kt.items(), key=lambda kv: -kv[1][0])
    fused = sum(v[0] for k, v in kt.items() if FUSED_KERNEL in k)
    traced = _trace_work(prof, recorded, CHAIN_SPANS)
    return {
        "alg": cfg.rx.algorithm, "batch": batch, "rounds": rounds,
        "wall_ms_per_round": wall * 1e3 / rounds,
        "device_busy_ms_per_round": busy_us / 1e3 / rounds,
        "idle_share": traced["idle_share"],
        "fused_pa_ms_per_round": fused / 1e3 / rounds,
        "kernel_launches_per_round": sum(v[1] for v in kt.values()) / rounds,
        **chain_costs(traced["work"], rounds),
        "top": [{"kernel": k[:120], "ms_per_round": v[0] / 1e3 / rounds,
                 "calls_per_round": v[1] / rounds} for k, v in ranked[:top]],
    }


CODED_BATCH = 16     # the coded experiments' default frames a round


def device_work_by_class(trace: dict, on_trace: list, labels) -> dict:
    """Device work by span name from a Chrome trace of the profiler and the
    program's spans on its clock (``spans.on_trace_clock``): for each name
    in ``labels`` and ``rest``, its device ms, its kernels, and the ms and
    launches of the fused kernel among them. A kernel belongs to the
    innermost span named in ``labels`` that holds the host call that
    launched it (matched by correlation id), else to ``rest``; memory copies
    and sets count as device time too."""
    launched_at, work = {}, []
    ranges = [(sp.start, sp.end, sp.name) for sp in on_trace if sp.name in labels]
    for e in trace["traceEvents"]:
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launched_at[args["correlation"]] = e["ts"]
        elif cat in DEVICE_CATS:
            work.append((e["dur"], args.get("correlation"), cat == "kernel",
                         FUSED_KERNEL in e.get("name", "")))
    out = {k: {"ms": 0.0, "kernels": 0, "fused_ms": 0.0, "fused_kernels": 0}
           for k in [*labels, "rest"]}
    for dur, corr, is_kernel, is_fused in work:
        ts = launched_at.get(corr)
        inside = [sp for sp in ranges if ts is not None and sp[0] <= ts <= sp[1]]
        c = out[min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "rest"]
        c["ms"] += dur / 1e3
        c["kernels"] += is_kernel
        c["fused_ms"] += dur / 1e3 if is_fused else 0.0
        c["fused_kernels"] += is_fused
    return out


def idle_share(trace: dict) -> float:
    """The share of the traced window (its first event to its last) in
    which no device operation ran: 1 - the union of the kernels', copies'
    and sets' intervals over the window."""
    events = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("cat", ""))
              for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    if not events:
        return 1.0
    w0, w1 = min(s for s, _, _ in events), max(e for _, e, _ in events)
    busy, reach = 0.0, w0
    for s, e in sorted((s, e) for s, e, cat in events if cat in DEVICE_CATS):
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return 1.0 - busy / (w1 - w0) if w1 > w0 else 1.0


def profile_coded_round(round_fn, rounds: int, snr_db: float) -> dict:
    """Profile ``rounds`` coded rounds after a warm-up round: wall and
    device-busy ms a round, the idle share, device ms a round by the
    program's spans (:data:`CODED_SPANS`, the rest apart), kernel launches a
    round, and the peak device memory of one round."""
    round_fn(1, 1000, snr_db)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    round_fn(1, 1001, snr_db)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with recording() as recorded, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            round_fn(1, i, snr_db)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    traced = _trace_work(prof, recorded, CODED_SPANS)
    work = traced["work"]
    busy = sum(c["ms"] for c in work.values())
    return {"rounds": rounds, "wall_ms_per_round": wall * 1e3 / rounds,
            "device_busy_ms_per_round": busy / rounds,
            "idle_share": traced["idle_share"],
            "device_ms_per_round_by_class": {k: c["ms"] / rounds for k, c in work.items()},
            **chain_costs(work, rounds),
            "kernel_launches_per_round": sum(c["kernels"] for c in work.values()) / rounds,
            "peak_memory_bytes": peak}


def coded_frames(batch: int) -> dict:
    """The coded rounds of ``--frames coded`` at Eb/N0 1 dB, by name:
    ``(round_fn, SNR dB)``."""
    from mimo_ofdm_tpu_torch.experiments.ber_sweeps import coded_link_config
    from mimo_ofdm_tpu_torch.ops.metrics import ebn0_to_snr
    snr = float(ebn0_to_snr(1.0, 2048, 2048, 64))
    out = {}
    for alg in ("cnc", "mcnc"):
        cfg = coded_link_config("los", alg, 64, 0.0, small=False)
        out[f"coded_ref_{alg}"] = link_ldpc.make_transport_round_fn(
            cfg, 8, batch, link_ldpc.reference_chain(cfg, 0.5), ldpc_iters=12,
            ldpc_algorithm="sumprod")
    cfg = coded_link_config("los", "cnc", 16, 0.0, small=False)
    out["coded_inloop_cnc"] = link_ldpc.make_transport_inloop_round_fn(
        cfg, 3, batch, link_ldpc.reference_chain(cfg, 1 / 3), ldpc_iters=12)
    cfg = coded_link_config("los", "cnc", 64, 0.0, small=False)
    out["coded_ira_cnc"] = link_ldpc.make_coded_round_fn(
        cfg, 8, batch, link_ldpc.code_for_modem(cfg, 0.5), ldpc_iters=25)
    return {k: (v, snr) for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frames", default=None,
                    help="comma-separated frame names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    canonical, _ = config.canonical_miso_cnc()
    mu = canonical.replace(modem=dataclasses.replace(canonical.modem, n_users=2))
    su_algs, mu_algs = ("cnc", "mcnc"), ("cnc", "mcnc_mu")
    frames = {"bench_rayleigh": (canonical.replace(
                  channel=config.ChannelConfig(model="rayleigh")), su_algs),
              "canonical_los": (canonical, su_algs),
              "two_path": (canonical.replace(
                  channel=config.ChannelConfig(model="two_path")), su_algs),
              "complex64_los": (canonical.replace(channel_storage="complex64",
                                                  mxu_fft_storage="float32"), su_algs),
              "tdl": (canonical.replace(channel=config.ChannelConfig(model="tdl_3gpp")),
                      su_algs),
              "gscm": (canonical.replace(channel=config.ChannelConfig(model="gscm")),
                       su_algs),
              "mu": (mu, mu_algs)}
    names = args.frames.split(",") if args.frames else [*frames, "coded"]
    for name in names:
        if name == "coded":
            for arm, (round_fn, snr) in coded_frames(CODED_BATCH).items():
                res = profile_coded_round(round_fn, args.rounds, snr)
                print(json.dumps({"card": card(), "frame": arm, "batch": CODED_BATCH,
                                  **res}), flush=True)
            continue
        base, algs = frames[name]
        for alg in algs:
            cfg = base.replace(rx=dataclasses.replace(base.rx, algorithm=alg))
            res = profile_round(cfg, 8, args.batch, args.rounds)
            print(json.dumps({"card": card(), "frame": name, **res}), flush=True)


if __name__ == "__main__":
    main()

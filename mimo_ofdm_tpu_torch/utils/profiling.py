"""Where a round's device time goes: ``torch.profiler`` over a few
Monte-Carlo rounds on the card: bench.py's Rayleigh frame, the repo's
canonical configuration (LOS, RX rerolled per frame), its two-path
variant, the canonical LOS on the complex64 branch (f32 chain), the TR
38.901 TDL and GSCM (uma_los) channels, and the multi-user link of
``multiuser_ber`` (2 users, MRT; CNC and MCNC-MU).

    python -m mimo_ofdm_tpu_torch.utils.profiling [--batch 128] [--rounds 3] [--frames tdl,mu]

Prints one JSON line per frame and arm with the wall time per round, the
device-busy time per round (sum of kernel durations), the idle share, and
the kernels that take the most device time, grouped by name. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from collections import defaultdict

import torch

from mimo_ofdm_tpu_torch.models import link, link_mu
from mimo_ofdm_tpu_torch.utils import config


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


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


def profile_round(cfg: config.LinkConfig, n_iters: int, batch: int,
                  rounds: int, device="cuda", top: int = 12) -> dict:
    """Profile ``rounds`` rounds after two warm-up rounds; a config with
    several users profiles ``link_mu``'s round at its default two-user
    geometry."""
    make = link_mu.make_mu_round_fn if cfg.modem.n_users > 1 else link.make_round_fn
    round_fn = make(cfg, n_iters, batch, device=device)
    for i in range(2):
        round_fn(1, 1000 + i, 15.0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            round_fn(1, i, 15.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kt = _kernel_times(prof)
    busy_us = sum(v[0] for v in kt.values())
    ranked = sorted(kt.items(), key=lambda kv: -kv[1][0])
    fused = sum(v[0] for k, v in kt.items() if "fused_ifft_pa_fft" in k)
    return {
        "alg": cfg.rx.algorithm, "batch": batch, "rounds": rounds,
        "wall_ms_per_round": wall * 1e3 / rounds,
        "device_busy_ms_per_round": busy_us / 1e3 / rounds,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        "fused_pa_ms_per_round": fused / 1e3 / rounds,
        "kernel_launches_per_round": sum(v[1] for v in kt.values()) / rounds,
        "top": [{"kernel": k[:120], "ms_per_round": v[0] / 1e3 / rounds,
                 "calls_per_round": v[1] / rounds} for k, v in ranked[:top]],
    }


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
    names = args.frames.split(",") if args.frames else list(frames)
    for name in names:
        base, algs = frames[name]
        for alg in algs:
            cfg = base.replace(rx=dataclasses.replace(base.rx, algorithm=alg))
            res = profile_round(cfg, 8, args.batch, args.rounds)
            print(json.dumps({"card": card(), "frame": name, **res}), flush=True)


if __name__ == "__main__":
    main()

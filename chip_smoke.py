"""Smoke run of the PyTorch/CUDA port (mimo_ofdm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--batch 128] [--rounds 20] [--out results.json]

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi) and torch's view.
2. build: compile csrc/fused_pa.cu with nvcc (ptxas register report).
3. kernel: the fused_pa kernel against its plain PyTorch version on the
   card (full/sc modes, f32/bf16 planes, every PA model, every n_fft).
4. main path: the canonical frame (64-QAM, n_fft 4096, n_sc 2048, 64-antenna
   ULA, MRT, Rayleigh, soft limiter at IBO 0 dB, 8 CNC iterations, bf16
   storage) through ``make_round_fn``: CNC and MCNC rounds at full width,
   with the kernel's launch count checked against the path's launches.
5. frame: a small f32 frame with fixed draws through the kernel and through
   the plain version forced on CUDA tensors; the counters must be equal.
6. timing: CUDA-event times of the kernel, its plain version and the
   torch.fft chain at the main path's shapes, beside the kernel's bound.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero without the last line; so does a machine with no
CUDA device, or a directory without the package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM data sheet
RESULTS: dict = {}


def emit(phase: str, **fields) -> None:
    RESULTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).to(torch.complex128))
                 / torch.linalg.vector_norm(b.to(torch.complex128)))


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``fn()`` over ``n`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_checks(fp, dev) -> dict:
    """Phase 3: kernel against plain version on the same CUDA inputs."""
    kern = fp.fused_ifft_pa_fft
    g = torch.Generator(device=dev).manual_seed(0)

    def planes(rows, n, dtype=torch.float32, scale=1.0):
        return ((torch.randn(rows, n, generator=g, device=dev) * scale).to(dtype),
                (torch.randn(rows, n, generator=g, device=dev) * scale).to(dtype))

    def check(name, xr, xi, sat, coeff=0.0, tol=1e-5, ref=None, **kw):
        kr, ki = kern(xr, xi, sat, coeff, **kw)
        torch.cuda.synchronize()
        got = torch.complex(kr.float(), ki.float())
        if ref is None:
            lead = xr.shape[:-1]
            s = torch.broadcast_to(torch.as_tensor(sat, dtype=torch.float32, device=dev), lead)
            c = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=dev), lead)
            pr, pi = fp.fused_ifft_pa_fft_plain(xr, xi, s, c, **kw)
            torch.cuda.synchronize()
            ref = torch.complex(pr.float(), pi.float())
        err = rel_err(got, ref)
        max_abs = float((got - ref).abs().max())
        ok = err < tol and bool(torch.isfinite(got).all())
        line = {"case": name, "shape": list(xr.shape), "dtype": str(xr.dtype),
                "rel_err": err, "max_abs_err": max_abs, "tol": tol, "ok": ok}
        print(json.dumps({"phase": "kernel", **line}), flush=True)
        if not ok:
            raise AssertionError(f"kernel check {name} failed: {line}")
        return line

    cases = []
    xr, xi = planes(256, 4096)
    cases.append(check("full_softlim_f32", xr, xi, 1.5, pa_model="softlim",
                       n_fft=4096, mode="full"))
    xr, xi = planes(64 * 8, 2048)
    sat = torch.rand(64 * 8, generator=g, device=dev) * 2 + 0.2
    cases.append(check("sc_softlim_f32_row_sat", xr, xi, sat, pa_model="softlim",
                       n_fft=4096, mode="sc"))
    cases.append(check("sc_softlim_bf16", xr.bfloat16(), xi.bfloat16(), sat, tol=1e-2,
                       pa_model="softlim", n_fft=4096, mode="sc"))
    sr, si = planes(64, 4096, scale=0.01)
    cases.append(check("full_huge_sat_identity", sr, si, 1e6, ref=torch.complex(sr, si),
                       pa_model="softlim", n_fft=4096, mode="full"))
    coeff = torch.rand(64 * 8, generator=g, device=dev) * 0.05
    for model in ("none", "rapp", "toi"):
        cases.append(check(f"sc_{model}_f32", xr, xi, sat, coeff, pa_model=model,
                           n_fft=4096, mode="sc"))
    for n_fft in (256, 512, 1024, 2048):
        ar, ai = planes(96, n_fft // 2)
        cases.append(check(f"sc_softlim_f32_nfft{n_fft}", ar, ai, 0.5,
                           pa_model="softlim", n_fft=n_fft, mode="sc"))
    return {"cases": len(cases), "worst_rel_err": max(c["rel_err"] for c in cases
                                                      if c["tol"] <= 1e-5)}


def canonical_cfg(config, alg: str, storage: str = "bfloat16"):
    cfg, _ = config.canonical_miso_cnc()
    return cfg.replace(channel=config.ChannelConfig(model="rayleigh"),
                       rx=dataclasses.replace(cfg.rx, algorithm=alg),
                       channel_storage=storage, mxu_fft_storage=storage)


def main_path(fp, config, link, dev, batch: int, rounds: int, card: str = "") -> dict:
    """Phase 4: CNC and MCNC rounds at full width through make_round_fn."""
    kern = fp.fused_ifft_pa_fft
    n_iters, snr = 8, 15.0
    out = {}
    for alg in ("cnc", "mcnc"):
        cfg = canonical_cfg(config, alg)
        round_fn = link.make_round_fn(cfg, n_iters, batch, device=dev)
        for i in range(2):                      # warm-up (allocator, kernel build)
            round_fn(0, 10_000 + i, snr)
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        total = torch.zeros(n_iters + 2, dtype=torch.int64, device=dev)
        for i in range(rounds):
            total += round_fn(0, i, snr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kern.launches
        counts = total.cpu().tolist()
        expected = rounds * (1 + n_iters + 1)    # TX + one per replica pass
        n_bits = rounds * batch * cfg.modem.n_bits_per_ofdm_sym
        ber = [c / n_bits for c in counts]
        line = {"alg": alg, "batch": batch, "rounds": rounds, "snr_db": snr,
                "counters": counts, "ber": ber, "launches": launches,
                "expected_launches": expected, "seconds": dt,
                "frames_per_s": rounds * batch / dt,
                "kernel_rows_per_frame": cfg.array.n_elements + (n_iters + 1) * (
                    cfg.array.n_elements if alg == "mcnc" else 1), "card": card}
        print(json.dumps({"phase": "main_path", **line}), flush=True)
        if launches != expected:
            raise AssertionError(f"{alg}: {launches} kernel launches, expected {expected}")
        if not all(0 <= b < 0.5 for b in ber) or not ber[0] < ber[1]:
            raise AssertionError(f"{alg}: insane counters {counts}")
        # MCNC cancels the clipping noise; CNC's single-PA replica does not
        # model per-bin Rayleigh fading, and its iterations hurt there, as in
        # the reference's committed curve (docs/CURVE_REPRODUCTION.md:169-178)
        if alg == "mcnc" and not ber[-1] <= ber[1]:
            raise AssertionError(f"mcnc: iteration 8 worse than iteration 0: {counts}")
        out[alg] = line
    return out


def frame_kernel_vs_plain(fp, config, link, dev, batch: int = 2) -> dict:
    """Phase 5: one f32 frame, fixed draws, kernel vs plain forced on CUDA."""
    kern = fp.fused_ifft_pa_fft
    res = {}
    for alg in ("cnc", "mcnc"):
        cfg = canonical_cfg(config, alg, "float32")
        frame = link.make_frame_fn(cfg, 8, device=dev)
        draws = link.FrameDraws.draw(cfg, batch, torch.Generator(device=dev).manual_seed(7))
        got = {}
        for plain in (False, True):
            kern.force_plain = plain
            try:
                c = frame(15.0, draws)
            finally:
                kern.force_plain = False
            got[plain] = [c.clean_err.cpu().tolist(), c.dist_err.cpu().tolist()]
        line = {"alg": alg, "batch": batch, "kernel": got[False], "plain": got[True],
                "equal": got[False] == got[True]}
        print(json.dumps({"phase": "frame", **line}), flush=True)
        if not line["equal"]:
            raise AssertionError(f"{alg}: kernel and plain frames disagree: {line}")
        res[alg] = line
    return res


def timing(fp, ofdm, dev, batch: int, card: str = "", n_fft: int = 4096,
           n_sc: int = 2048) -> dict:
    """Phase 6: kernel, plain and torch.fft chain at the main path's shapes."""
    kern = fp.fused_ifft_pa_fft
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, rows in (("tx", batch * 64), ("cnc_replica", batch)):
        xr = torch.randn(rows, n_sc, generator=g, device=dev).bfloat16()
        xi = torch.randn(rows, n_sc, generator=g, device=dev).bfloat16()
        sat = torch.full((rows,), 0.5, device=dev)
        coeff = torch.zeros(rows, device=dev)
        kw = dict(pa_model="softlim", n_fft=n_fft, mode="sc")
        ms = time_ms(lambda: kern(xr, xi, sat, coeff, **kw))
        plain_ms = time_ms(lambda: fp.fused_ifft_pa_fft_plain(xr, xi, sat, coeff, **kw))
        full = ofdm.map_subcarriers(torch.complex(xr.float(), xi.float()), n_fft)
        lib_ms = time_ms(lambda: torch.fft.fft(torch.fft.ifft(full, norm="ortho"),
                                               norm="ortho"))
        kr, ki = kern(xr, xi, sat, coeff, **kw)
        pr, pi = fp.fused_ifft_pa_fft_plain(xr, xi, sat, coeff, **kw)
        torch.cuda.synchronize()
        diff = torch.complex(kr.float(), ki.float()) - torch.complex(pr.float(), pi.float())
        n_bytes = rows * n_sc * 2 * xr.element_size() * 2 + rows * 8
        n_ops = rows * 2 * 5 * n_fft * math.log2(n_fft)
        bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_F32_FLOPS * 1e3
        out[name] = {"rows": rows, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                     "bytes": n_bytes, "flops": n_ops, "ns_per_row": ms * 1e6 / rows,
                     "max_abs_err": float(diff.abs().max()), "card": card}
        print(json.dumps({"phase": "timing", "shape": name, **out[name]}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128, help="frames per round")
    ap.add_argument("--rounds", type=int, default=20, help="timed rounds per arm")
    ap.add_argument("--out", default=None, help="also write all results as JSON here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mimo_ofdm_tpu_torch.kernels import fused_pa as fp
    from mimo_ofdm_tpu_torch.models import link
    from mimo_ofdm_tpu_torch.ops import ofdm
    from mimo_ofdm_tpu_torch.utils import config

    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _, report = fp.build_library()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln for ln in report.splitlines() if "registers" in ln or "smem" in ln])

    emit("kernel_summary", **kernel_checks(fp, dev))
    paths = main_path(fp, config, link, dev, args.batch, args.rounds, smi)
    frame_kernel_vs_plain(fp, config, link, dev)
    times = timing(fp, ofdm, dev, args.batch, smi)

    tx = times["tx"]
    launches = sum(p["launches"] for p in paths.values())
    kernels = {"kernels": [{
        "name": "fused_ifft_pa_fft", "route": "cuda",
        "source": "mimo_ofdm_tpu_torch/csrc/fused_pa.cu",
        "replaces": "mimo_ofdm_tpu/kernels/fused_pa.py:113",
        "replaces_function": "mimo_ofdm_tpu/kernels/fused_pa.py::fused_ifft_clip_fft",
        "launches": launches, "max_abs_err": tx["max_abs_err"],
        "max_rel_err": RESULTS["kernel_summary"]["worst_rel_err"],
        "ms": tx["ms"], "plain_ms": tx["plain_ms"], "bound_ms": tx["bound_ms"],
        "bound_by": tx["bound_by"], "library_ms": tx["library_ms"],
        "shape": f"sc bf16 [{tx['rows']}, 2048] n_fft 4096",
        "card": smi}]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": RESULTS, "main_path": paths, "timing": times,
                       **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

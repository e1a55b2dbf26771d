"""Smoke run of the PyTorch/CUDA port (mimo_ofdm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--batch 128] [--rounds 20] [--out results.json]

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi) and torch's view.
2. build: compile csrc/fused_pa.cu with nvcc and print ptxas's report;
   registers, local memory (spills), shared memory and resident blocks per
   SM of every instantiation (5 sizes x 2 modes x 4 I/O layouts, and 5
   sizes x 4 precoded layouts in sc mode), as the
   runtime reads them, whether it is the tensor-core kernel (the bf16
   layouts) and the HMMA/HGMMA instructions in its SASS (``cuobjdump``).
   A 4096-point instantiation with local memory or fewer than 2 resident
   blocks per SM fails the phase; so does a bf16 instantiation off the
   tensor cores (no HMMA), with spills or under 2 blocks per SM, and an
   f32 one on them.
   Before it, the antenna combine kernel (csrc/antenna_combine.cu): its
   build, ptxas's report and each instantiation's resources (no spills, 4
   blocks an SM), then its time at MCNC b512's [512, 64, 2048] and
   LOS b32's [32, 64, 2048] bf16 planes beside its bound (the four planes
   in, complex64 out, at 3.35 TB/s) and its plain version (the eager
   expression it replaces), within 1e-5 relative L2 of it and the same
   bits on a second call.
3. kernel: the fused_pa kernel against its plain PyTorch version on the
   card (full/sc modes, f32/bf16 planes, every PA model, every n_fft, a
   ragged last block at every n_fft below 4096, one row and zero rows,
   n_sc = n_fft/4, and the TX shape in both dtypes; bf16 planes at every
   n_fft in both modes at 96, 37 and 1 rows and every PA model); then its
   interleaved complex64 layouts (``fused_ifft_pa_fft_complex``) at every
   n_fft in both modes and storages, every PA model, a ragged last block,
   one row, a conjugated and a strided view and the main paths' shapes,
   each the same bits as the plane layout on the same input and within
   1e-5 (f32) or 1e-2 (bf16) of the plain version. Every bf16 case is
   also held within 2e-3 of the bf16 layouts' own plain version
   (``fused_ifft_pa_fft_bf16``, the tensor-core passes and roundings).
4. main path: bench.py's Rayleigh frame (the canonical config with the
   Rayleigh channel: 64-QAM, n_fft 4096, n_sc 2048, 64-antenna ULA, MRT,
   soft limiter at IBO 0 dB, 8 CNC iterations, bf16 storage) through
   ``make_round_fn``: CNC and MCNC rounds at full width, with the kernel's
   launch count checked against the path's launches, the combine kernel's
   against its own (a TX launch and one a MCNC replica pass, a round, on
   bf16 planar paths; none on other planes), and the counters checked for
   sanity.
5. frame: f32 frames at full width with fixed draws through the kernel and
   through the plain version forced on CUDA tensors: the Rayleigh frame,
   the canonical LOS planes, the complex64 branch, and the TDL and GSCM
   channels; the counters must be equal.
6. timing: CUDA-event times of the kernel, its plain version and the
   torch.fft chain with the clip (and without it) at the main path's two
   shapes (TX launch, CNC replica) in both plane dtypes, beside the
   kernel's bound and its share of it; then the interleaved bf16 layout at
   the TX shape, with the complex-ended chain call as callers see it
   through the interleaved layout and through planes; then the
   precoded_mu bf16 layout, which the two-user TX and MCNC-MU replica
   passes run, at the TX shape and at an MCNC-MU pass, bit for bit the
   eager swap, precode and interleaved launch it replaces (timed beside
   it, and that launch alone).
   ``ms`` is the mean over back-to-back calls, host time included, as the
   main path sees it; ``graph_ms`` replays the kernel's calls from a CUDA
   graph, which leaves its device time alone. A bf16 line's ``plain_ms``
   and ``max_abs_err`` are those of the bf16 plain version, within 2e-3
   (the exact one within 1e-2: ``exact_plain_ms``, ``rel_err``), beside
   the tensor-core products' flops and their time at 989 TFLOP/s. A bf16
   layout's bound takes its operations at the dense bf16 tensor-core
   rate (``bound_ms_f32_rate`` keeps them at the float32 rate).
7. canonical_los: the repo's canonical configuration, canonical_miso_cnc()
   unchanged (LOS, RX rerolled per frame), CNC and MCNC rounds at full
   width and Eb/N0 15 dB, with the same checks and frames/s.
8. two_path / complex64 / f32_planes: one full-width round per receiver of
   the two-path channel on bf16 planes, of the complex64 branch on LOS at
   f32 chain storage and of the LOS frame on f32 planes, with the same
   checks.
9. sweep: miso_ber_vs_ebn0 at full width through the Monte-Carlo driver,
   two Eb/N0 points of a few rounds each; its CSV (in a temporary
   directory) must have the expected name and layout.
10. channels: one full-width round per receiver (CNC, MCNC) of
   canonical_miso_cnc() with the channel switched to Rician (K 9 dB),
   random paths, TR 38.901 TDL (uma_los, 20 subpaths) and the GSCM
   (uma_los, uma_nlos), with phase 4's checks.
11. multiuser: multiuser_ber's configuration (2 users at +-30 deg and 100 /
   316.3 m, LOS, 64 antennas, the canonical frame): one full-width round
   each of MRT+CNC, ZF+CNC, MRT+CNC-MU, MRT+MCNC-MU and separate-carrier
   CNC, with 10 launches a round, per-user sanity, and the CUDA syncs of
   the timed rounds counted under torch.cuda.set_sync_debug_mode("warn");
   f32 frames equal through the kernel and the plain version; then a
   two-point multiuser_ber sweep whose CSV name and layout are checked,
   with its ratio to the committed full-width curve printed.

12. coded: ``ldpc_ref_ber``'s configuration at full width (64 antennas,
   LOS, IBO 0 dB, 8 CNC iterations, rate 1/2: A = 6144, CRC24A, BG1, Zc
   288, one code block; 12 sum-product iterations), one round of 16 frames
   per receiver at Eb/N0 1 dB with 10 launches a round, sane BERs and
   BLERs (clean BER at most iteration 0's), frames/s, device ms by op class
   (decode, soft demap, chain, rest) and peak memory; one round of
   ``ldpc_in_loop_ber``'s defaults (rate 1/3, 16 antennas, 3 iterations: 5
   launches) and of the raw IRA codeword of ``ldpc_coded_ber(family="ira")``;
   f32 coded frames (CNC, MCNC, 2 frames) equal through the kernel and the
   plain version; a two-point ``ldpc_ref_ber`` sweep (Eb/N0 1 and 5 dB, 3
   rounds a point) whose BER and BLER CSVs are checked for name and layout,
   with its ratio to the committed nant64 curve printed.
13. analysis: the distortion-analysis family at full width, every
   distorted transmit through the kernel at f32 planes (``sc`` mode for
   the power, SDR, alpha and SISO scans, ``full`` mode for the PSDs):
   (a) ``mrt_radiation_pattern`` at the committed configuration (LOS, 64
   antennas, IBO 3 dB, 181 points, 100 snapshots) against the committed
   PSDs (in-band levels within 1 dB, the distortion shoulder within 0.5
   dB) and powers (dB-pattern correlation at least 0.999, the desired
   power at the precoding point within 5%); (b) ``sdr_vs_ibo`` (LOS,
   two-path, Rayleigh; IBO 0, 4, 8 dB; 500 snapshots), run with seven
   seeds, the linear mean pooled over them within 0.7 dB of the committed
   nant64 rows;
   (c) ``reproduce_reference_curve`` with its
   defaults, every counter with 1,000 errors within 0.8-1.25 of the
   committed canonical curve; (d) ``siso_ser_vs_snr`` at two SNR points;
   (e) every other new experiment once at cut depth, each with a physics
   check; (f) an f32 radiation pattern and a SISO frame through the
   kernel and the plain version; (g) each path's launches against the
   code's prediction; and the kernel's time at the analysis shapes, on
   f32 planes and in the interleaved f32 layout the scans launch.
14. scale_out: (a) a world-size-1 NCCL job (``parallel.multihost``): the
   sharded rounds on its (1, 1) mesh (``parallel.sharded``) against the
   unsharded ones for the same keys, counters equal and 10 launches a
   round: bench.py's Rayleigh frame (CNC and MCNC, 3 rounds of 128
   frames), MRT+MCNC-MU (one round) and ``ldpc_ref_ber``'s CNC round (16
   frames); the frames/s of both sides; one round's global draws (ms and
   bytes on this rank); (c) ``weak_scaling`` on one device in that job
   (frames/s, efficiency 1.0); (b) two spawned ranks on the card over
   gloo: dp 2 on the Rayleigh frame equal to the single-process round,
   tp 2 on canonical LOS (complex64 branch, f32 chain) within JAX's
   tolerance for non-exact sharding with the differing bits printed, and
   10 launches a round on each rank.
15. components: the component API at the canonical width (canonical LOS,
   the complex64 branch, 128 frames at Eb/N0 15 dB): (a) one frame round
   per receiver on fixed draws, then the same bits, noise and RX offsets
   through ``transmit.array_transmit_fd`` -> ``channels.propagate`` ->
   ``awgn`` -> ``agc.compute_agc`` -> ``receivers.equalize`` into
   ``standard_receive``, ``cnc_receive`` and ``mcnc_receive`` (torch.fft
   replicas), every counter within 5 binomial sd of the frame round's;
   (b) the same frames through ``cnc_iterate`` with the kernel-backed
   replicas, 9 launches a receive and at most 1e-4 of the bits differing
   at any pass; (c) ``fused_ifft_clip_fft`` at ``[6400, 4096]`` against
   its plain version, one launch in the interleaved f32 layout, the same
   bits as the plane route it took before, 1e-5; (d) the CP modem's round
   trip at ``[128, 64, 2048]``, ``cp_len`` 128, 1e-6.
16. bench: the port's bench (``mimo_ofdm_tpu_torch/bench.py``), bench.py's
   Rayleigh CNC and MCNC arms at full width in pipelined, interleaved
   windows (its default batches and depth 3; 3 windows of 1 s an arm):
   bench.py's keys plus ``device``, 10 launches a round, the consumed
   counters sane, the medians, windows, peak memory and the ratio to phase
   4's synchronous rounds; then ``python -m mimo_ofdm_tpu_torch.bench`` in
   a subprocess, which must print one JSON line with those keys; and the
   kernel against both plain versions at the bench's shapes (the TX on
   bf16 planes, the CNC replica pass interleaved), timed as in phase 6.

Then the ``{"kernels": [...]}`` line, one row per I/O layout with the
paths' launches in it and one for the antenna combine kernel (its
launches in the paths' timed rounds, which drive_path checks), the
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero without the last
line; so does a machine with no CUDA device, or a directory without the
package.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores, H100 SXM data sheet
COMMITTED_CSV_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "figs",
                                 "csv_results")
BF16_TOL = 1e-2                 # relative L2 of a bf16 layout against the exact plain version
# relative L2 of a bf16 layout against its own plain version (the same
# passes and roundings): under 1e-3 on an H100, where the earlier
# float32-pass arithmetic with bf16 loads and stores reads 4.6e-3
BF16_PLAIN_TOL = 2e-3
# the layouts that the paths may leave unlaunched: the transmitter's chain
# is precoded, so the planes take complex128 chain calls only
PLANES_LAYOUTS = ("planes_bf16", "planes_f32")
PRECODED_LAYOUTS = ("precoded_bf16", "precoded_f32", "precoded_mu_bf16")
RESULTS: dict = {}
LAYOUT_LAUNCHES: dict = {}      # the paths' kernel launches by I/O layout, summed
COMBINE_LAUNCHES = [0]          # the combine kernel's launches in drive_path's rounds


def zero_launches(kern) -> None:
    """Set the kernel's launch counts, in all and by I/O layout, to 0."""
    kern.launches = 0
    for layout in kern.launches_by_layout:
        kern.launches_by_layout[layout] = 0


def add_layout_launches(counts: dict) -> None:
    for layout, n in counts.items():
        LAYOUT_LAUNCHES[layout] = LAYOUT_LAUNCHES.get(layout, 0) + n


def routed(plain: bool):
    """Inside the ``with`` block: the plain version of every kernel where
    ``plain``, else the kernels."""
    from mimo_ofdm_tpu_torch import kernels
    return kernels.plain_versions() if plain else contextlib.nullcontext()


def read_launches(kern) -> int:
    """The kernel's launches since :func:`zero_launches`, all made by a path
    of the run: their split by layout goes into ``LAYOUT_LAUNCHES``."""
    add_layout_launches(kern.launches_by_layout)
    return kern.launches


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


def bf16_plain(fp, xr, xi, sat, coeff=0.0, **kw) -> torch.Tensor:
    """The bf16 layouts' plain version (the tensor-core kernel's passes,
    roundings and float32 sums) on the same inputs, as complex64."""
    lead = xr.shape[:-1]
    s = torch.broadcast_to(torch.as_tensor(sat, dtype=torch.float32, device=xr.device), lead)
    c = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=xr.device), lead)
    pr, pi = fp.fused_ifft_pa_fft_bf16(xr, xi, s, c, **kw)
    return torch.complex(pr.float(), pi.float())


def tensor_core_flops(rows: int, n_fft: int) -> int:
    """The tensor-core kernel's products for ``rows`` rows: a pass is 8
    mma.sync m16n8k16 (2 * 16 * 8 * 16 flops each) a tile of 256 points,
    and a transform 2 passes (n_fft 256) or 3."""
    tiles = n_fft // 256
    passes = 2 * (2 if tiles == 1 else 3)
    return rows * passes * tiles * 8 * 2 * 16 * 8 * 16


def ops_bound_ms(n_ops: int, dtype: torch.dtype) -> float:
    """The least time for ``n_ops`` operations of a kernel layout of
    ``dtype``: the bf16 layouts run their DFT passes on the tensor cores,
    so at the dense bf16 peak; the float32 ones at the float32 peak."""
    return n_ops / (H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS) * 1e3


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


def graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()``: a CUDA graph of ``n`` calls, replayed,
    so that no host time between the launches counts."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


@contextlib.contextmanager
def results_dir():
    """A temporary directory as the port's CSV directory, removed after."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_csv_")
    old = os.environ.get("MIMO_OFDM_TPU_TORCH_RESULTS")
    os.environ["MIMO_OFDM_TPU_TORCH_RESULTS"] = tmp
    try:
        yield tmp
    finally:
        if old is None:
            os.environ.pop("MIMO_OFDM_TPU_TORCH_RESULTS")
        else:
            os.environ["MIMO_OFDM_TPU_TORCH_RESULTS"] = old
        shutil.rmtree(tmp, ignore_errors=True)


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
                "rel_err": err, "max_abs_err": max_abs, "tol": tol}
        if xr.dtype == torch.bfloat16:      # the tensor-core arithmetic's own plain version
            lead = xr.shape[:-1]
            c = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=dev), lead)
            b = bf16_plain(fp, xr, xi, sat, c, **kw)
            line.update(rel_err_bf16_plain=rel_err(got, b),
                        max_abs_err_bf16_plain=float((got - b).abs().max()))
            ok = ok and line["rel_err_bf16_plain"] < BF16_PLAIN_TOL
        line["ok"] = ok
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
        # 37 rows: the last block of 256 / (n_fft / 16) rows is ragged
        ar, ai = planes(37, n_fft // 2)
        cases.append(check(f"sc_softlim_f32_nfft{n_fft}_ragged37", ar, ai, sat[:37],
                           pa_model="softlim", n_fft=n_fft, mode="sc"))
    ar, ai = planes(1, 2048)
    cases.append(check("sc_softlim_f32_one_row", ar, ai, 0.4, pa_model="softlim",
                       n_fft=4096, mode="sc"))
    ar, ai = planes(40, 256)
    cases.append(check("sc_softlim_f32_nfft1024_nsc256", ar, ai, 0.3,
                       pa_model="softlim", n_fft=1024, mode="sc"))
    ar, ai = planes(64 * 128, 2048)
    tx_sat = torch.rand(64 * 128, generator=g, device=dev) + 0.2
    cases.append(check("sc_softlim_f32_tx_shape", ar, ai, tx_sat, pa_model="softlim",
                       n_fft=4096, mode="sc"))
    cases.append(check("sc_softlim_bf16_tx_shape", ar.bfloat16(), ai.bfloat16(), tx_sat,
                       tol=1e-2, pa_model="softlim", n_fft=4096, mode="sc"))
    # an MCNC-MU replica pass: B x n_usr x n_ant = 128 x 2 x 64 rows
    ar, ai = planes(2 * 64 * 128, 2048)
    mu_sat = torch.rand(2 * 64 * 128, generator=g, device=dev) + 0.2
    cases.append(check("sc_softlim_f32_mcnc_mu_shape", ar, ai, mu_sat, pa_model="softlim",
                       n_fft=4096, mode="sc"))
    cases.append(check("sc_softlim_bf16_mcnc_mu_shape", ar.bfloat16(), ai.bfloat16(), mu_sat,
                       tol=1e-2, pa_model="softlim", n_fft=4096, mode="sc"))
    # the tensor-core kernel (bf16 planes) at every size, both modes, a
    # ragged last block, one row, every PA model
    for n_fft in (256, 512, 1024, 2048, 4096):
        for mode in ("sc", "full"):
            n_io = n_fft // 2 if mode == "sc" else n_fft
            for rows in (96, 37, 1):
                br, bi = planes(rows, n_io, torch.bfloat16)
                cases.append(check(f"{mode}_softlim_bf16_nfft{n_fft}_rows{rows}", br, bi,
                                   sat[:rows], tol=BF16_TOL, pa_model="softlim", n_fft=n_fft,
                                   mode=mode))
    br, bi = planes(64 * 8, 2048, torch.bfloat16)
    for model in ("none", "rapp", "toi"):
        cases.append(check(f"sc_{model}_bf16", br, bi, sat, coeff, tol=BF16_TOL, pa_model=model,
                           n_fft=4096, mode="sc"))
    before = kern.launches
    zr, _ = kern(ar[:0], ai[:0], 1.0, pa_model="softlim", n_fft=4096, mode="sc")
    zc = fp.fused_ifft_pa_fft_complex(torch.complex(ar[:0], ai[:0]), 1.0, pa_model="softlim",
                                      n_fft=4096, mode="sc", storage="bfloat16")
    zero_ok = (tuple(zr.shape) == tuple(zc.shape) == (0, 2048) and zc.is_cuda
               and kern.launches == before)
    print(json.dumps({"phase": "kernel", "case": "zero_rows", "shape": [0, 2048],
                      "launched": kern.launches - before, "ok": zero_ok}), flush=True)
    if not zero_ok:
        raise AssertionError("zero rows: expected an empty result and no launch")
    inter = interleaved_checks(fp, dev, g)
    bf16 = [c for c in cases + inter if "rel_err_bf16_plain" in c]
    return {"cases": len(cases), "worst_rel_err": max(c["rel_err"] for c in cases
                                                      if c["tol"] <= 1e-5),
            "bf16_cases": len(bf16),
            "bf16_worst_rel_err_exact": max(c["rel_err"] for c in bf16),
            "bf16_worst_rel_err_bf16_plain": max(c["rel_err_bf16_plain"] for c in bf16),
            "interleaved_cases": len(inter),
            "interleaved_worst_rel_err": max(c["rel_err"] for c in inter if c["tol"] <= 1e-5),
            "interleaved_bitwise_equal_planes": all(c["bitwise_equal_planes"] for c in inter)}


def layout_name(storage: str) -> str:
    """The interleaved layout of a chain storage, as ``LAYOUTS`` names it."""
    return "interleaved_" + ("bf16" if storage == "bfloat16" else "f32")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """complex64 tensors equal in every bit (their halves as int32)."""
    def ints(z):
        return torch.view_as_real(z.resolve_conj().contiguous()).view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(ints(a), ints(b)))


def planes_route(fp, x, sat, coeff=0.0, storage="float32", **kw):
    """The plane layout on complex64, as the complex-ended chain calls ran
    it before they had the interleaved layout: the halves cast to planes
    of the storage dtype, the plane launch, the result cast back."""
    st = fp.STORAGE_DTYPES[storage]
    kr, ki = fp.fused_ifft_pa_fft(x.real.to(st).contiguous(), x.imag.to(st).contiguous(), sat,
                                  coeff, **kw)
    return torch.complex(kr.to(torch.float32), ki.to(torch.float32))


def interleaved_checks(fp, dev, g) -> list[dict]:
    """Phase 3 (b): the kernel's interleaved complex64 layouts
    (``fused_ifft_pa_fft_complex``), each case one launch, the same bits
    as the plane layout on the same input (:func:`planes_route`) and
    within 1e-5 (f32) or 1e-2 (bf16) relative L2 of the plain version:
    every n_fft in both modes at both storages, every PA model, a ragged
    last block, one row, a conjugated and a strided view, and the main
    path's shapes."""
    kern = fp.fused_ifft_pa_fft
    tols = {"float32": 1e-5, "bfloat16": BF16_TOL}
    cases = []

    def cplx(rows, n):
        return torch.complex(torch.randn(rows, n, generator=g, device=dev),
                             torch.randn(rows, n, generator=g, device=dev))

    def check(name, x, sat, coeff=0.0, storage="float32", **kw):
        layout = layout_name(storage)
        before, by_layout = kern.launches, kern.launches_by_layout[layout]
        got = fp.fused_ifft_pa_fft_complex(x, sat, coeff, storage=storage, **kw)
        torch.cuda.synchronize()
        launched = (kern.launches - before, kern.launches_by_layout[layout] - by_layout)
        planes = planes_route(fp, x, sat, coeff, storage, **kw)
        st = fp.STORAGE_DTYPES[storage]
        lead = x.shape[:-1]
        s = torch.broadcast_to(torch.as_tensor(sat, dtype=torch.float32, device=dev), lead)
        c = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=dev), lead)
        pr, pi = fp.fused_ifft_pa_fft_plain(x.real.to(st), x.imag.to(st), s, c, **kw)
        torch.cuda.synchronize()
        ref = torch.complex(pr.float(), pi.float())
        err = rel_err(got, ref)
        line = {"case": name, "layout": layout, "shape": list(x.shape),
                "mode": kw["mode"], "n_fft": kw["n_fft"], "pa_model": kw["pa_model"],
                "bitwise_equal_planes": bits_equal(got, planes), "rel_err": err,
                "max_abs_err": float((got - ref).abs().max()), "tol": tols[storage],
                "launched": list(launched)}
        line["ok"] = (line["bitwise_equal_planes"] and err < tols[storage]
                      and launched == (1, 1) and bool(torch.isfinite(got).all()))
        if st == torch.bfloat16:
            b = bf16_plain(fp, x.real.to(st), x.imag.to(st), s, c, **kw)
            line["rel_err_bf16_plain"] = rel_err(got, b)
            line["ok"] = line["ok"] and line["rel_err_bf16_plain"] < BF16_PLAIN_TOL
        print(json.dumps({"phase": "kernel", **line}), flush=True)
        if not line["ok"]:
            raise AssertionError(f"interleaved check {name} failed: {line}")
        cases.append(line)

    for n_fft in (256, 512, 1024, 2048, 4096):
        for mode in ("sc", "full"):
            n_io = n_fft // 2 if mode == "sc" else n_fft
            for storage in ("float32", "bfloat16"):
                rows = 64 if n_fft == 4096 else 96
                sat = torch.rand(rows, generator=g, device=dev) * 2 + 0.2
                check(f"{mode}_softlim_{storage}_nfft{n_fft}", cplx(rows, n_io), sat,
                      storage=storage, pa_model="softlim", n_fft=n_fft, mode=mode)
                if n_fft < 4096:     # 37 rows: the last block is ragged
                    check(f"{mode}_softlim_{storage}_nfft{n_fft}_ragged37", cplx(37, n_io),
                          sat[:37], storage=storage, pa_model="softlim", n_fft=n_fft,
                          mode=mode)
                else:
                    check(f"{mode}_softlim_{storage}_one_row", cplx(1, n_io), 0.4,
                          storage=storage, pa_model="softlim", n_fft=n_fft, mode=mode)
    sat = torch.rand(512, generator=g, device=dev) * 2 + 0.2
    coeff = torch.rand(512, generator=g, device=dev) * 0.05
    for model in ("none", "rapp", "toi"):
        for storage in ("float32", "bfloat16"):
            check(f"sc_{model}_{storage}", cplx(512, 2048), sat, coeff, storage=storage,
                  pa_model=model, n_fft=4096, mode="sc")
    x = cplx(256, 2048)
    check("sc_softlim_bfloat16_conjugated_view", x.conj(), 0.6, storage="bfloat16",
          pa_model="softlim", n_fft=4096, mode="sc")
    check("sc_softlim_float32_strided_view", cplx(2048, 512).T[::2], 0.6,
          pa_model="softlim", n_fft=4096, mode="sc")
    for name, rows, n_fft, mode, storage in MAIN_SHAPES:
        n_io = n_fft // 2 if mode == "sc" else n_fft
        sat = torch.rand(rows, generator=g, device=dev) + 0.2
        check(f"{name}_shape", cplx(rows, n_io), sat, storage=storage, pa_model="softlim",
              n_fft=n_fft, mode=mode)
    return cases


# the interleaved layout's shapes on the main paths: (name, rows, n_fft,
# mode, storage); each is checked in phase 3, and timed in phase 6 or
# beside the analysis timing but the MCNC-MU pass's, which the precoded_mu
# timing times (its ``interleaved_ms``)
MAIN_SHAPES = (("tx_interleaved_bf16", 8192, 4096, "sc", "bfloat16"),
               ("mcnc_mu_interleaved_bf16", 16384, 4096, "sc", "bfloat16"),
               ("scan_sc_interleaved_f32", 2560, 4096, "sc", "float32"),
               ("psd_full_interleaved_f32", 6400, 4096, "full", "float32"))
N_ITERS = 8
CANONICAL_EBN0_DB = 15.0       # the LOS phases' operating point (SNR 22.78 dB)


def bench_rayleigh_cfg(config, alg: str, storage: str = "bfloat16"):
    """bench.py's frame: the canonical config with the Rayleigh channel
    (bench.py:66-114), which PRs 1-2 called "canonical" here."""
    cfg, _ = config.canonical_miso_cnc()
    return cfg.replace(channel=config.ChannelConfig(model="rayleigh"),
                       rx=dataclasses.replace(cfg.rx, algorithm=alg),
                       channel_storage=storage, mxu_fft_storage=storage)


def canonical_cfg(config, alg: str, **changes):
    """The repo's canonical configuration, canonical_miso_cnc() unchanged
    (LOS, RX rerolled per frame, bf16 planes) but for the receiver and the
    fields in ``changes``."""
    cfg, _ = config.canonical_miso_cnc()
    return cfg.replace(rx=dataclasses.replace(cfg.rx, algorithm=alg), **changes)


def drive_path(fp, link, phase: str, cfg, dev, batch: int, rounds: int, snr: float,
               warmup: int = 2, card: str = "") -> dict:
    """``rounds`` timed rounds of ``batch`` frames through make_round_fn
    after ``warmup``, with the kernels' launch counts zeroed just before the
    timed rounds and read just after. Fails unless the fused kernel's
    launches equal the path's count (a TX launch and one launch per replica
    pass a round), the combine kernel's equal its count (a TX launch, and
    one per MCNC replica pass, a round of the planar path on bf16 planes;
    none on other planes or off that path), and the counters are sane: every
    BER in [0, 0.5), the clean BER below iteration 0's, and for MCNC
    iteration 8 no worse than iteration 0."""
    from mimo_ofdm_tpu_torch.kernels import antenna_combine as ac
    from mimo_ofdm_tpu_torch.models import link_planar

    kern = fp.fused_ifft_pa_fft
    alg = cfg.rx.algorithm
    round_fn = link.make_round_fn(cfg, N_ITERS, batch, device=dev)
    for i in range(warmup):                 # allocator, kernel build
        round_fn(0, 10_000 + i, snr)
    torch.cuda.synchronize()
    zero_launches(kern)
    ac.antenna_combine.launches = 0
    t0 = time.perf_counter()
    total = torch.zeros(N_ITERS + 2, dtype=torch.int64, device=dev)
    for i in range(rounds):
        total += round_fn(0, i, snr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(kern)
    combines = ac.antenna_combine.launches
    COMBINE_LAUNCHES[0] += combines
    counts = total.cpu().tolist()
    expected = rounds * (1 + N_ITERS + 1)
    bf16_planar = cfg.channel_storage == "bfloat16" and link_planar.planar_eligible(cfg)
    expected_combines = (rounds * (1 + (N_ITERS + 1 if alg == "mcnc" else 0))
                         if bf16_planar else 0)
    n_bits = rounds * batch * cfg.modem.n_bits_per_ofdm_sym
    ber = [c / n_bits for c in counts]
    line = {"alg": alg, "channel": cfg.channel.model, "storage": cfg.channel_storage,
            "mxu_storage": cfg.mxu_fft_storage, "batch": batch, "rounds": rounds,
            "snr_db": snr, "counters": counts, "ber": ber, "launches": launches,
            "expected_launches": expected, "launches_per_round": launches / rounds,
            "combine_launches": combines, "expected_combine_launches": expected_combines,
            "launches_by_layout": dict(kern.launches_by_layout),
            "seconds": dt, "frames_per_s": rounds * batch / dt,
            "kernel_rows_per_frame": cfg.array.n_elements + (N_ITERS + 1) * (
                cfg.array.n_elements if alg == "mcnc" else 1), "card": card}
    print(json.dumps({"phase": phase, **line}), flush=True)
    if launches != expected:
        raise AssertionError(f"{phase} {alg}: {launches} kernel launches, expected {expected}")
    if combines != expected_combines:
        raise AssertionError(f"{phase} {alg}: {combines} combine kernel launches, expected "
                             f"{expected_combines}")
    if not all(0 <= b < 0.5 for b in ber) or not ber[0] < ber[1]:
        raise AssertionError(f"{phase} {alg}: insane counters {counts}")
    # MCNC cancels the clipping noise; CNC's single-PA replica does not
    # model per-bin Rayleigh fading, and its iterations hurt there, as in
    # the reference's committed curve (docs/CURVE_REPRODUCTION.md:169-178)
    if alg == "mcnc" and not ber[-1] <= ber[1]:
        raise AssertionError(f"{phase} mcnc: iteration 8 worse than iteration 0: {counts}")
    return line


def main_path(fp, config, link, dev, batch: int, rounds: int, card: str = "") -> dict:
    """Phase 4: bench.py's Rayleigh frame, CNC and MCNC rounds at full width."""
    return {alg: drive_path(fp, link, "main_path", bench_rayleigh_cfg(config, alg), dev,
                            batch, rounds, 15.0, card=card)
            for alg in ("cnc", "mcnc")}


def los_paths(fp, config, link, dev, batch: int, rounds: int, snr: float,
              card: str = "") -> dict:
    """Phases 7 and 8: the canonical LOS configuration in CNC and MCNC
    (``rounds`` timed rounds), then one round per receiver of the two-path
    channel on bf16 planes, of the complex64 branch on LOS and of the LOS
    frame on f32 planes (its TX the kernel's one f32-plane launch)."""
    out = {}
    for alg in ("cnc", "mcnc"):
        out[f"los_{alg}"] = drive_path(fp, link, "canonical_los", canonical_cfg(config, alg),
                                       dev, batch, rounds, snr, card=card)
    for alg in ("cnc", "mcnc"):
        two_path = canonical_cfg(config, alg, channel=config.ChannelConfig(model="two_path"))
        out[f"two_path_{alg}"] = drive_path(fp, link, "two_path", two_path, dev, batch, 1,
                                            snr, warmup=1, card=card)
        complex_los = canonical_cfg(config, alg, channel_storage="complex64",
                                    mxu_fft_storage="float32")
        out[f"complex_los_{alg}"] = drive_path(fp, link, "complex64", complex_los, dev,
                                               batch, 1, snr, warmup=1, card=card)
        f32_planes = canonical_cfg(config, alg, channel_storage="float32",
                                   mxu_fft_storage="float32")
        out[f"f32_planes_los_{alg}"] = drive_path(fp, link, "f32_planes", f32_planes, dev,
                                                  batch, 1, snr, warmup=1, card=card)
    return out


def frame_kernel_vs_plain(config, link, dev, snr_los: float, batch: int = 2) -> dict:
    """Phase 5: f32 frames at full width with fixed draws, through the
    kernel and through the plain version forced on CUDA tensors: bench.py's
    Rayleigh frame (SNR 15 dB), the canonical LOS planes, the complex64
    branch on LOS, and the TDL and GSCM channels (Eb/N0 15 dB)."""
    frames = {}
    for alg in ("cnc", "mcnc"):
        frames[f"rayleigh_{alg}"] = (bench_rayleigh_cfg(config, alg, "float32"), 15.0)
        frames[f"los_{alg}"] = (canonical_cfg(config, alg, channel_storage="float32",
                                              mxu_fft_storage="float32"), snr_los)
        frames[f"complex_los_{alg}"] = (canonical_cfg(config, alg, channel_storage="complex64",
                                                      mxu_fft_storage="float32"), snr_los)
        for model in ("tdl_3gpp", "gscm"):
            frames[f"{model}_{alg}"] = (canonical_cfg(
                config, alg, channel=config.ChannelConfig(model=model),
                mxu_fft_storage="float32"), snr_los)
    res = {}
    for name, (cfg, snr) in frames.items():
        frame = link.make_frame_fn(cfg, N_ITERS, device=dev)
        draws = link.FrameDraws.draw(cfg, batch, torch.Generator(device=dev).manual_seed(7))
        got = {}
        for plain in (False, True):
            with routed(plain):
                c = frame(snr, draws)
            got[plain] = [c.clean_err.cpu().tolist(), c.dist_err.cpu().tolist()]
        line = {"frame": name, "alg": cfg.rx.algorithm, "batch": batch, "snr_db": snr,
                "kernel": got[False], "plain": got[True], "equal": got[False] == got[True]}
        print(json.dumps({"phase": "frame", **line}), flush=True)
        if not line["equal"]:
            raise AssertionError(f"{name}: kernel and plain frames disagree: {line}")
        res[name] = line
    return res


def sweep(fp, config, results, ber_sweeps, dev, batch: int, card: str = "") -> dict:
    """Phase 9: miso_ber_vs_ebn0 (canonical LOS, 64 antennas, CNC, 8
    iterations) at two Eb/N0 points through the Monte-Carlo driver, with a
    bit budget of 3 rounds a point (the pipeline adds up to 2). The CSV
    goes to a temporary directory; its name must be results'
    ber_sweep_filename and its layout Eb/N0, the clean row, it0..it8."""
    kern = fp.fused_ifft_pa_fft
    cfg, _ = config.canonical_miso_cnc()
    n_ant = cfg.array.n_elements
    n_bits_round = batch * cfg.modem.n_bits_per_ofdm_sym
    ebn0 = (10.0, 15.0)
    with results_dir() as tmp:
        torch.cuda.synchronize()
        zero_launches(kern)
        t0 = time.perf_counter()
        res = ber_sweeps.miso_ber_vs_ebn0(
            channels=("los",), n_ant=n_ant, n_iters=N_ITERS, ebn0_min=ebn0[0],
            ebn0_max=ebn0[1],
            ebn0_step=ebn0[1] - ebn0[0], n_err_min=10 ** 9,
            bits_sent_max=3 * n_bits_round, batch=batch, verbose=False,
            device=dev)["los"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches(kern)
        name = results.ber_sweep_filename("ber_vs_ebn0", "cnc", "los", n_ant, 0.0,
                                          res.param_values, list(range(1, N_ITERS + 1)))
        files = sorted(os.listdir(tmp))
        x, ber = results.load_ber_sweep(name, tmp) if files == [name + ".csv"] else (None, None)
    rounds = [p.n_rounds for p in res.points]
    line = {"points": list(ebn0), "rounds_per_point": rounds, "launches": launches,
            "expected_launches": sum(rounds) * (N_ITERS + 2), "seconds": dt,
            "frames_per_s": sum(rounds) * batch / dt, "csv": files, "expected_csv": name + ".csv",
            "ber": None if ber is None else ber.tolist(), "card": card}
    print(json.dumps({"phase": "sweep", **line}), flush=True)
    if x is None:
        raise AssertionError(f"sweep: expected one CSV {name}.csv, found {files}")
    if list(x) != list(ebn0) or ber.shape != (N_ITERS + 2, len(ebn0)):
        raise AssertionError(f"sweep: CSV layout {len(x)} x {ber.shape}, expected "
                             f"Eb/N0 {ebn0} then {N_ITERS + 2} rows")
    if not np.all((0 <= ber) & (ber < 0.5)) or not np.all(ber[0] < ber[1]):
        raise AssertionError(f"sweep: insane BER rows {ber.tolist()}")
    if launches != line["expected_launches"] or not all(3 <= r <= 5 for r in rounds):
        raise AssertionError(f"sweep: {launches} launches over rounds {rounds}")
    return line


STOCHASTIC_CHANNELS = {
    "rician": dict(model="rician", rician_k_db=9.0),
    "random_paths": dict(model="random_paths"),
    "tdl_3gpp": dict(model="tdl_3gpp", tdl_profile="uma_los", tdl_subpaths=20),
    "gscm_uma_los": dict(model="gscm", gscm_scenario="uma_los"),
    "gscm_uma_nlos": dict(model="gscm", gscm_scenario="uma_nlos"),
}


def channel_paths(fp, config, link, dev, batch: int, snr: float, card: str = "") -> dict:
    """Phase 10: one full-width round per receiver of the canonical config
    on each stochastic channel, through drive_path."""
    out = {}
    for name, fields in STOCHASTIC_CHANNELS.items():
        for alg in ("cnc", "mcnc"):
            cfg = canonical_cfg(config, alg, channel=config.ChannelConfig(**fields))
            out[f"{name}_{alg}"] = drive_path(fp, link, "channels", cfg, dev, batch, 1, snr,
                                              warmup=1, card=card)
    return out


MU_PATHS = {                    # (precoding, receiver, separate carriers)
    "mrt_cnc": ("mrt", "cnc", False),
    "zf_cnc": ("zf", "cnc", False),
    "mrt_cnc_mu": ("mrt", "cnc_mu", False),
    "mrt_mcnc_mu": ("mrt", "mcnc_mu", False),
    "sep_cnc": ("mrt", "cnc", True),
}


def mu_cfg(config, prec: str, alg: str, storage: str = "bfloat16"):
    """multiuser_ber's configuration (experiments/ber_sweeps.py): the
    canonical frame with 2 users on LOS."""
    cfg, _ = config.canonical_miso_cnc()
    return cfg.replace(modem=dataclasses.replace(cfg.modem, n_users=2), precoding=prec,
                       rx=dataclasses.replace(cfg.rx, algorithm=alg),
                       mxu_fft_storage=storage)


def drive_mu_path(fp, link_mu, name: str, cfg, sep: bool, dev, batch: int, rounds: int,
                  snr: float, card: str = "") -> dict:
    """``rounds`` timed multi-user rounds after one warm-up, under
    torch.cuda.set_sync_debug_mode("warn") with every warning recorded, the
    launch count zeroed just before and read just after. Fails unless there
    are 10 launches a round and every user's counters are sane: BER in [0,
    0.5), clean below iteration 0, and for MCNC-MU iteration 8 no worse
    than iteration 0."""
    import warnings

    kern = fp.fused_ifft_pa_fft
    round_fn = link_mu.make_mu_round_fn(cfg, N_ITERS, batch, sep_carriers=sep, device=dev)
    round_fn(0, 10_000, snr)
    torch.cuda.synchronize()
    zero_launches(kern)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            total = round_fn(0, 0, snr).to(torch.int64)
            for i in range(1, rounds):
                total += round_fn(0, i, snr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # every synchronizing call warns; setting the mode itself warns that
    # the mode is a prototype, which is no sync
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message).lower()
             and "prototype feature" not in str(w.message)]
    launches = read_launches(kern)
    counts = total.cpu().tolist()
    n_usr = len(counts)
    n_bits = rounds * batch * cfg.modem.n_bits_per_ofdm_sym // (n_usr if sep else 1)
    ber = [[c / n_bits for c in row] for row in counts]
    expected = rounds * (1 + N_ITERS + 1)
    line = {"path": name, "precoding": cfg.precoding, "alg": cfg.rx.algorithm,
            "sep_carriers": sep, "batch": batch, "rounds": rounds, "snr_db": snr,
            "counters": counts, "ber": ber, "launches": launches,
            "expected_launches": expected, "launches_per_round": launches / rounds,
            "syncs": len(syncs), "sync_messages": sorted(set(syncs))[:5],
            "seconds": dt, "frames_per_s": rounds * batch / dt, "card": card}
    print(json.dumps({"phase": "multiuser", **line}), flush=True)
    if launches != expected:
        raise AssertionError(f"multiuser {name}: {launches} launches, expected {expected}")
    for u, b in enumerate(ber):
        if not all(0 <= x < 0.5 for x in b) or not b[0] < b[1]:
            raise AssertionError(f"multiuser {name}: insane counters of user {u}: {counts}")
        if cfg.rx.algorithm == "mcnc_mu" and not b[-1] <= b[1]:
            raise AssertionError(f"multiuser {name}: user {u} iteration 8 worse than 0")
    return line


def mu_kernel_vs_plain(config, link_mu, dev, snr: float, batch: int = 2) -> dict:
    """f32 multi-user frames with fixed draws through the kernel and through
    the plain version forced on CUDA tensors: the counters must be equal."""
    pos = link_mu.default_user_positions()
    res = {}
    for name, (prec, alg, sep) in MU_PATHS.items():
        cfg = mu_cfg(config, prec, alg, "float32")
        builder = link_mu.make_mu_sep_frame_fn if sep else link_mu.make_mu_frame_fn
        frame = builder(cfg, N_ITERS, pos, device=dev)
        draws = link_mu.MuFrameDraws.draw(cfg, 2, batch,
                                          torch.Generator(device=dev).manual_seed(9),
                                          sep_carriers=sep)
        got = {}
        for plain in (False, True):
            with routed(plain):
                c = frame(snr, draws)
            got[plain] = [c.clean_err.cpu().tolist(), c.dist_err.cpu().tolist()]
        line = {"frame": f"mu_{name}", "batch": batch, "snr_db": snr, "kernel": got[False],
                "plain": got[True], "equal": got[False] == got[True]}
        print(json.dumps({"phase": "frame", **line}), flush=True)
        if not line["equal"]:
            raise AssertionError(f"mu_{name}: kernel and plain frames disagree: {line}")
        res[name] = line
    return res


MU_REFERENCE_CSV = ("ber_vs_ebn0_mu_mr_cnc_los_nant64_ibo0_ebn0_min5_max20_step1.00"
                    "_niter1_2_3_4_5_6_7_8_angles-30_30_distances100_316.3")


def mu_sweep(fp, results, ber_sweeps, dev, batch: int, card: str = "", n_ant: int = 64,
             small: bool = False) -> dict:
    """A two-point multiuser_ber sweep (MRT, CNC, Eb/N0 10 and 15 dB, a
    bit budget of 3 rounds a point) into a temporary directory. Its CSV must
    have mu_ber_filename's name and the layout Eb/N0, then per user the
    clean row and it0..it8. Prints, and does not check, the ratio of its
    BERs to the committed full-width curve at those points. ``n_ant`` and
    ``small`` (multiuser_ber's n_fft 256 cut) exist for rehearsals on the
    CPU."""
    kern = fp.fused_ifft_pa_fft
    n_bits_round = batch * (128 if small else 2048) * 6
    ebn0 = (10.0, 15.0)
    with results_dir() as tmp:
        torch.cuda.synchronize()
        zero_launches(kern)
        t0 = time.perf_counter()
        x, ber = ber_sweeps.multiuser_ber(
            ebn0_min=ebn0[0], ebn0_max=ebn0[1], ebn0_step=ebn0[1] - ebn0[0],
            n_err_min=10 ** 9, bits_sent_max=3 * n_bits_round, batch=batch, n_ant=n_ant,
            small=small, verbose=False, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches(kern)
        name = results.mu_ber_filename("mr", "los", n_ant, 0.0, x, list(range(1, N_ITERS + 1)),
                                       (-30.0, 30.0), (100.0, 316.3))
        files = sorted(os.listdir(tmp))
        rows = (results.read_from_csv(name, tmp) if files == [name + ".csv"] else None)
    ref = np.asarray(results.read_from_csv(MU_REFERENCE_CSV, COMMITTED_CSV_DIR), float)
    cols = [int(np.argmin(np.abs(ref[0] - e))) for e in ebn0]
    ratio = (ber.reshape(-1, len(ebn0)) / ref[1:, cols]).tolist()
    line = {"points": list(ebn0), "launches": launches, "seconds": dt, "csv": files,
            "expected_csv": name + ".csv", "ber": ber.tolist(),
            "committed_ber": ref[1:, cols].tolist(), "ratio_to_committed": ratio, "card": card}
    print(json.dumps({"phase": "multiuser_sweep", **line}), flush=True)
    if rows is None:
        raise AssertionError(f"multiuser sweep: expected one CSV {name}.csv, found {files}")
    shape = [len(r) for r in rows]
    if shape != [len(ebn0)] * (1 + 2 * (N_ITERS + 2)) or list(rows[0]) != list(ebn0):
        raise AssertionError(f"multiuser sweep: CSV layout {shape}, expected Eb/N0 then "
                             f"{2 * (N_ITERS + 2)} rows of {len(ebn0)}")
    if launches != 2 * 3 * (N_ITERS + 2) or not np.all((0 <= ber) & (ber < 0.5)):
        raise AssertionError(f"multiuser sweep: {launches} launches, BER {ber.tolist()}")
    return line


def multiuser(fp, config, link_mu, results, ber_sweeps, dev, batch: int, snr: float,
              card: str = "") -> dict:
    """Phase 11: the multi-user paths, their f32 kernel-vs-plain frames and
    the two-point multiuser_ber sweep."""
    out = {}
    for name, (prec, alg, sep) in MU_PATHS.items():
        out[f"mu_{name}"] = drive_mu_path(fp, link_mu, name, mu_cfg(config, prec, alg), sep,
                                          dev, batch, 2, snr, card)
    mu_kernel_vs_plain(config, link_mu, dev, snr)
    out["mu_sweep"] = mu_sweep(fp, results, ber_sweeps, dev, batch, card)
    return out


CODED_BATCH = 16                # the coded experiments' default batch
CODED_EBN0_DB = (1.0, 5.0)
CODED_REFERENCE_CSV = ("ldpc_1_2_ber_vs_ebn0_cnc_los_nant64_ibo0_ebn0_min-5_max15_step1.00"
                       "_niter1_2_3_4_5_6_7_8")


def drive_coded(fp, profiling, name: str, round_fn, n_iters: int, payload_bits: int,
                blocks: bool, dev, batch: int, snr: float, card: str = "") -> dict:
    """One timed coded round after a warm-up, with the launch count zeroed
    just before and read just after and the peak memory reset before it;
    then the op-class profile of one more round. Fails unless there are
    ``n_iters + 2`` launches (TX and every replica pass), every BER is in
    [0, 0.5), every BLER in [0, 1], and the clean BER is at most iteration
    0's."""
    kern = fp.fused_ifft_pa_fft
    round_fn(0, 10_000, snr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    zero_launches(kern)
    t0 = time.perf_counter()
    start.record()
    total = round_fn(0, 0, snr)
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(kern)
    peak = torch.cuda.max_memory_allocated()
    counts = total.cpu().tolist()
    n = n_iters + 2
    ber = [c / (batch * payload_bits) for c in counts[:n]]
    bler = [c / batch for c in counts[n:]]
    prof = profiling.profile_coded_round(round_fn, 1, snr)
    line = {"path": name, "batch": batch, "snr_db": snr, "counters": counts, "ber": ber,
            "bler": bler, "launches": launches, "expected_launches": n,
            "seconds": dt, "frames_per_s": batch / dt,
            "stream_ms": start.elapsed_time(end), "peak_memory_bytes": peak,
            "profile": prof, "card": card}
    print(json.dumps({"phase": "coded", **line}), flush=True)
    if launches != n:
        raise AssertionError(f"coded {name}: {launches} kernel launches, expected {n}")
    if (not all(0 <= b < 0.5 for b in ber) or not all(0 <= b <= 1 for b in bler)
            or not ber[0] <= ber[1] or (blocks and len(bler) != n)):
        raise AssertionError(f"coded {name}: insane counters {counts}")
    return line


def coded_kernel_vs_plain(link, link_ldpc, ber_sweeps, dev, snr: float,
                          batch: int = 2, n_ant: int = 64, small: bool = False) -> dict:
    """f32 coded frames of ldpc_ref_ber's configuration with fixed draws,
    through the kernel and through the plain version forced on CUDA
    tensors: the counters must be equal."""
    res = {}
    for alg in ("cnc", "mcnc"):
        cfg = ber_sweeps.coded_link_config("los", alg, n_ant, 0.0, small).replace(
            mxu_fft_storage="float32")
        chain = link_ldpc.reference_chain(cfg, 0.5)
        frame = link_ldpc.make_transport_frame_fn(cfg, N_ITERS, chain, 12,
                                                  ldpc_algorithm="sumprod", device=dev)
        draws = link.FrameDraws.draw(cfg, batch, torch.Generator(device=dev).manual_seed(11),
                                     n_bits=chain.a)
        got = {}
        for plain in (False, True):
            with routed(plain):
                c = frame(snr, draws)
            got[plain] = [x.cpu().tolist() for x in c]
        line = {"frame": f"coded_{alg}", "batch": batch, "snr_db": snr, "kernel": got[False],
                "plain": got[True], "equal": got[False] == got[True]}
        print(json.dumps({"phase": "frame", **line}), flush=True)
        if not line["equal"]:
            raise AssertionError(f"coded_{alg}: kernel and plain frames disagree: {line}")
        res[alg] = line
    return res


def coded_sweep(fp, results, ber_sweeps, dev, batch: int, card: str = "", n_ant: int = 64,
                small: bool = False) -> dict:
    """A two-point ldpc_ref_ber sweep (CNC, 8 iterations, Eb/N0 1 and 5 dB,
    a bit budget of 3 rounds a point) into a temporary directory. Its BER
    and BLER CSVs must have ber_sweep_filename's names and the layout
    Eb/N0, clean, it0..it8. Prints, and does not check, its BERs' ratio to
    the committed full-width curve. ``n_ant`` and ``small`` exist for
    rehearsals on the CPU."""
    kern = fp.fused_ifft_pa_fft
    payload = (768 if small else 12288) // 2
    ebn0 = CODED_EBN0_DB
    with results_dir() as tmp:
        torch.cuda.synchronize()
        zero_launches(kern)
        t0 = time.perf_counter()
        x, ber = ber_sweeps.ldpc_ref_ber(
            n_ant=n_ant, n_iters=N_ITERS, ebn0_min=ebn0[0], ebn0_max=ebn0[1],
            ebn0_step=ebn0[1] - ebn0[0], n_err_min=10 ** 9,
            bits_sent_max=3 * batch * payload, batch=batch, small=small, verbose=False,
            device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches(kern)
        name = results.ber_sweep_filename("ldpc_1_2_ber_vs_ebn0", "cnc", "los", n_ant, 0.0,
                                          x, list(range(1, N_ITERS + 1)))
        bler_name = results.ber_sweep_filename("ldpc_1_2_ber_vs_ebn0_bler", "cnc", "los",
                                               n_ant, 0.0, x, list(range(1, N_ITERS + 1)))
        files = sorted(os.listdir(tmp))
        expected = sorted([name + ".csv", bler_name + ".csv"])
        rows = ([results.read_from_csv(n, tmp) for n in (name, bler_name)]
                if files == expected else None)
    ref = np.asarray(results.read_from_csv(CODED_REFERENCE_CSV, COMMITTED_CSV_DIR), float)
    cols = [int(np.argmin(np.abs(ref[0] - e))) for e in ebn0]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (ber / ref[1:, cols]).tolist()
    line = {"points": list(ebn0), "launches": launches, "seconds": dt, "csv": files,
            "expected_csv": expected, "ber": ber.tolist(),
            "bler": None if rows is None else rows[1][1:],
            "committed_ber": ref[1:, cols].tolist(), "ratio_to_committed": ratio, "card": card}
    print(json.dumps({"phase": "coded_sweep", **line}), flush=True)
    if rows is None:
        raise AssertionError(f"coded sweep: expected {expected}, found {files}")
    for r in rows:
        if [len(v) for v in r] != [len(ebn0)] * (N_ITERS + 3) or list(r[0]) != list(ebn0):
            raise AssertionError(f"coded sweep: CSV layout {[len(v) for v in r]}, expected "
                                 f"Eb/N0 then {N_ITERS + 2} rows of {len(ebn0)}")
    bler = np.asarray(rows[1][1:])
    if (launches != 2 * 3 * (N_ITERS + 2) or not np.all((0 <= ber) & (ber < 0.5))
            or not np.all((0 <= bler) & (bler <= 1))):
        raise AssertionError(f"coded sweep: {launches} launches, BER {ber.tolist()}")
    return line


def coded(fp, link, link_ldpc, profiling, results, ber_sweeps, metrics, dev, card: str = "",
          batch: int = CODED_BATCH, n_ant: int = 64, small: bool = False) -> dict:
    """Phase 12: the coded link at full width (``n_ant`` and ``small``, the
    n_fft 256 cut, exist for rehearsals on the CPU)."""
    snr1, snr5 = (float(metrics.ebn0_to_snr(e, 2048, 2048, 64)) for e in CODED_EBN0_DB)
    out = {}
    for alg in ("cnc", "mcnc"):
        cfg = ber_sweeps.coded_link_config("los", alg, n_ant, 0.0, small)
        chain = link_ldpc.reference_chain(cfg, 0.5)
        rf = link_ldpc.make_transport_round_fn(cfg, N_ITERS, batch, chain, ldpc_iters=12,
                                               ldpc_algorithm="sumprod", device=dev)
        out[f"coded_ref_{alg}"] = drive_coded(fp, profiling, f"ref_{alg}", rf, N_ITERS,
                                              chain.a, True, dev, batch, snr1, card)
    cfg = ber_sweeps.coded_link_config("los", "cnc", n_ant // 4, 0.0, small)
    chain = link_ldpc.reference_chain(cfg, 1 / 3)
    rf = link_ldpc.make_transport_inloop_round_fn(cfg, 3, batch, chain, ldpc_iters=12,
                                                  device=dev)
    out["coded_inloop"] = drive_coded(fp, profiling, "inloop_cnc", rf, 3, chain.a, True, dev,
                                      batch, snr1, card)
    cfg = ber_sweeps.coded_link_config("los", "cnc", n_ant, 0.0, small)
    code = link_ldpc.code_for_modem(cfg, 0.5)
    rf = link_ldpc.make_coded_round_fn(cfg, N_ITERS, batch, code, ldpc_iters=25, device=dev)
    out["coded_ira"] = drive_coded(fp, profiling, "ira_cnc", rf, N_ITERS, code.k, False, dev,
                                   batch, snr1, card)
    coded_kernel_vs_plain(link, link_ldpc, ber_sweeps, dev, snr5, n_ant=n_ant, small=small)
    out["coded_sweep"] = coded_sweep(fp, results, ber_sweeps, dev, batch, card, n_ant, small)
    return out


# --- phase 13: the analysis family -------------------------------------------

SISO_REFERENCE_CSV = "ser_vs_snr_siso_awgn_cnc_ibo0_snr_min15_max31_niter0_1_2_3_5_12"
SDR_REFERENCE_CSV = "sdr_vs_ibo_per_channel_ibo0to8_1_4_16_32_64nant"
SISO_ITERS = (0, 1, 2, 3, 5, 12)


def counted(fp, fn):
    """``(fn(), launches, seconds)`` with the kernel's count zeroed just
    before ``fn`` and read just after, the device drained on both sides."""
    kern = fp.fused_ifft_pa_fft
    torch.cuda.synchronize()
    zero_launches(kern)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches(kern), time.perf_counter() - t0


def check(ok: bool, what: str, line: dict, phase: str = "analysis") -> None:
    if not ok:
        raise AssertionError(f"{phase}: {what}: {line}")


def db(x):
    return 10.0 * np.log10(np.asarray(x, np.float64))


def band_db(f, p, lo, hi):
    """Mean PSD level [dB] over the bins ``lo <= |f| <= hi``."""
    f = np.abs(np.asarray(f))
    return float(db(np.mean(np.asarray(p)[(f >= lo) & (f <= hi)])))


def radiation_check(fp, results, spatial, dev, card, n_ant=64, n_sc=2048,
                    small=False) -> dict:
    """(a) mrt_radiation_pattern at the committed configuration (LOS, IBO 3
    dB, 181 points, 100 snapshots, angles 45 and 78 deg) against the
    committed PSDs (in-band levels within 1 dB, the out-of-band distortion
    shoulder within 0.5 dB) and powers (dB-pattern correlation at least
    0.999, the desired power at the precoding point within 5%)."""
    kw = dict(channels=("los",), n_ant_values=(n_ant,), ibo_db=3.0, n_points=180,
              n_snapshots=100, verbose=False, small=small, device=dev)
    with results_dir() as tmp:
        out, launches, dt = counted(fp, lambda: spatial.mrt_radiation_pattern(**kw))
        files = sorted(os.listdir(tmp))
        sig = results.sig_powers_filename("los", 3.0, 180, 100, 45.0, n_ant)
        port_sig = results.read_from_csv(sig, tmp)
    res = out[("los", n_ant)]
    ref_sig = results.read_from_csv(sig, COMMITTED_CSV_DIR)
    ref_des, ref_dist = (np.asarray(ast.literal_eval(r[-1])) for r in ref_sig)
    port_des = np.asarray(ast.literal_eval(port_sig[0][-1]))
    prec = int(round(180 / 180 * 45.0))
    line = {"launches": launches, "expected_launches": -(-181 // 4) * 10 + 2,
            "seconds": dt, "csv": files, "card": card,
            "des_corr_db": float(np.corrcoef(db(res.desired_pow), db(ref_des))[0, 1]),
            "dist_corr_db": float(np.corrcoef(db(res.distortion_pow), db(ref_dist))[0, 1]),
            "des_at_prec_ratio": float(res.desired_pow[prec] / ref_des[prec]),
            "csv_equals_result": bool(np.allclose(port_des, res.desired_pow, rtol=1e-6))}
    for ang in (45.0, 78.0):
        ref = np.asarray(results.read_from_csv(
            results.psd_filename("los", 3.0, 180, 100, ang, n_ant), COMMITTED_CSV_DIR))
        f, p_des, p_dist = res.psd[ang]
        half = n_sc // 2
        line[f"psd{int(ang)}"] = {
            "in_band_des_db": band_db(f, p_des, 1, half) - band_db(ref[0], ref[1], 1, half),
            "in_band_dist_db": band_db(f, p_dist, 1, half) - band_db(ref[2], ref[3], 1, half),
            "shoulder_dist_db": (band_db(f, p_dist, half + 1, 2 * half)
                                 - band_db(ref[2], ref[3], half + 1, 2 * half))}
    print(json.dumps({"phase": "analysis", "path": "radiation", **line}), flush=True)
    check(launches == line["expected_launches"], "radiation launches", line)
    check(len(files) == 3 and line["csv_equals_result"], "radiation CSVs", line)
    check(min(line["des_corr_db"], line["dist_corr_db"]) >= 0.999, "pattern correlation", line)
    check(abs(line["des_at_prec_ratio"] - 1) <= 0.05, "power at the precoding point", line)
    for ang in (45, 78):
        p = line[f"psd{ang}"]
        check(max(abs(p["in_band_des_db"]), abs(p["in_band_dist_db"])) <= 1.0
              and abs(p["shoulder_dist_db"]) <= 0.5, f"PSD at {ang} deg", line)
    return line


def sdr_check(fp, results, spatial, an, dev, card, n_ant=64, small=False,
              extra_seeds=6) -> dict:
    """(b) sdr_vs_ibo at 64 antennas (LOS, two-path, Rayleigh; IBO 0, 4, 8
    dB; 500 snapshots) against the committed CSV's nant64 rows (linear
    SDRs). The linear mean of 500 per-snapshot ratios is heavy-tailed where
    clipping is rare (IBO 8 dB: one seed moved it by 1.2 dB), so the scan
    is repeated with ``extra_seeds`` other seeds and the linear mean pooled
    over all the runs (3,500 snapshots) must lie within 0.7 dB of the
    committed value at every point. The first run's own deviation is
    printed, not checked."""
    chans, ibo = ("los", "two_path", "rayleigh"), (0.0, 4.0, 8.0)

    def run():
        with results_dir() as tmp:
            x, sdr_db = spatial.sdr_vs_ibo(channels=chans, n_ant_values=(n_ant,),
                                           ibo_values=ibo, n_snapshots=500, verbose=False,
                                           small=small, device=dev)
            rows = np.asarray(results.read_from_csv(
                f"sdr_vs_ibo_per_channel_ibo0to8_{n_ant}nant", tmp), float)
        seeds = [[an.sdr_vs_ibo_curve(spatial._cfg(n_ant, 0.0, chan=c, small=small), ibo,
                                      (212.0, 212.0, 1.5), seed=1000 + k, n_snapshots=500,
                                      device=dev)[1] for c in chans]
                 for k in range(extra_seeds)]
        return sdr_db, rows[1:], np.asarray(seeds)

    (sdr_db, lin, seeds), launches, dt = counted(fp, run)
    ref = np.asarray(results.read_from_csv(SDR_REFERENCE_CSV, COMMITTED_CSV_DIR), float)
    cols = [int(np.argmin(np.abs(ref[0] - v))) for v in ibo]
    ref64 = ref[1 + 4 * 3: 1 + 5 * 3][:, cols]
    pooled = (lin + seeds.sum(0)) / (1 + extra_seeds)
    dev_db = db(pooled) - db(ref64)
    first_db = db(lin) - db(ref64)
    line = {"launches": launches, "expected_launches": (1 + extra_seeds) * 3 * 3 * -(-500 // 16),
            "seconds": dt, "ibo": list(ibo), "sdr_db": sdr_db[0].tolist(),
            "sdr_lin": lin.tolist(), "seed_lin": seeds.tolist(), "pooled_lin": pooled.tolist(),
            "committed_lin": ref64.tolist(), "deviation_db": dev_db.tolist(),
            "median_abs_dev_db": float(np.median(np.abs(dev_db))),
            "max_abs_dev_db": float(np.max(np.abs(dev_db))),
            "first_run_deviation_db": first_db.tolist(), "card": card}
    print(json.dumps({"phase": "analysis", "path": "sdr", **line}), flush=True)
    check(launches == line["expected_launches"], "sdr launches", line)
    check(np.all(np.diff(sdr_db[0], axis=-1) > 0), "SDR rises with IBO", line)
    check(np.all(np.abs(dev_db) <= 0.7), "pooled SDR against the committed curve", line)
    return line


def reference_curve_check(fp, ber_sweeps, dev, card) -> dict:
    """(c) reproduce_reference_curve with its defaults: every counter with
    at least 1,000 errors within 0.8-1.25 of the committed canonical curve."""
    out, launches, dt = counted(fp, lambda: ber_sweeps.reproduce_reference_curve(
        verbose=False, device=dev))
    points = {}
    for ebn0, (ref, ber, pt) in out.items():
        points[str(ebn0)] = {"ber": ber.tolist(), "committed": ref.tolist(),
                             "ratio": (ber / ref).tolist(), "errors": pt.n_err.tolist(),
                             "rounds": pt.n_rounds}
    rounds = sum(p["rounds"] for p in points.values())
    line = {"launches": launches, "expected_launches": rounds * (N_ITERS + 2),
            "seconds": dt, "points": points, "card": card}
    print(json.dumps({"phase": "analysis", "path": "reference_curve", **line}), flush=True)
    check(launches == line["expected_launches"], "reference curve launches", line)
    for p in points.values():
        for r, e in zip(p["ratio"], p["errors"]):
            check(e < 1000 or 0.8 <= r <= 1.25, "ratio to the committed curve", line)
    return line


def siso_check(fp, results, siso_checks, dev, card, small=False) -> dict:
    """(d) siso_ser_vs_snr at full width, SNR 25 and 31 dB, 4 rounds of 64
    frames a point: clean <= it0 and it12 <= it0; the ratio to the
    committed CSV printed, not checked (its script is stale)."""
    n_sc = 128 if small else 2048
    (snrs, ser), launches, dt = counted(fp, lambda: siso_checks.siso_ser_vs_snr(
        snr_min=25.0, snr_max=31.0, snr_step=6.0, n_symb_err_min=10 ** 9,
        n_symb_sent_max=4 * 64 * n_sc, save_csv=False, verbose=False, small=small,
        device=dev))
    ref = np.asarray(results.read_from_csv(SISO_REFERENCE_CSV, COMMITTED_CSV_DIR), float)
    cols = [int(np.argmin(np.abs(ref[0] - s))) for s in snrs]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = ser / ref[1:, cols]
    line = {"launches": launches, "expected_launches": 1 + 2 * 4 * (max(SISO_ITERS) + 2),
            "seconds": dt, "snr_db": snrs.tolist(), "ser": ser.tolist(),
            "committed_ser": ref[1:, cols].tolist(), "ratio_to_committed": ratio.tolist(),
            "card": card}
    print(json.dumps({"phase": "analysis", "path": "siso", **line}, default=str), flush=True)
    check(launches == line["expected_launches"], "siso launches", line)
    check(np.all(ser[0] <= ser[1]) and np.all(ser[-1] <= ser[1]), "SISO SER order", line)
    return line


def experiments_check(fp, misc_evals, siso_checks, spatial, dev, card, n_ant=64,
                      small=False) -> dict:
    """(e) every other new experiment once, at full width and cut depth,
    each with a physics check and its predicted launches."""
    from mimo_ofdm_tpu_torch.ops.pa import bussgang_alpha
    q = dict(verbose=False, device=dev)
    qs = dict(q, save_csv=False, small=small)
    n_sc = 128 if small else 2048

    def intermod(ang, d, e, pred):
        deg, edb = np.degrees(ang), db(e / e.max())

        def at(a):
            return float(edb[int(np.argmin(abs(deg - a)))])
        lobes = {a: at(a) for a in (-60, -40, 40, 60)}
        return {"ok": pred == [-60.0, 60.0] and lobes[60] > lobes[40] + 3
                and lobes[-60] > lobes[-40] + 3, "distortion_db": lobes}

    def zf_beats_mrt(zf, mrt):
        return {"ok": bool(np.all(zf[1] > mrt[1]) and np.all(np.abs(zf[0] - zf[1]) < 0.5)),
                "sinr_zf_db": zf[1].tolist(), "sdr_zf_db": zf[0].tolist(),
                "sinr_mrt_db": mrt[1].tolist()}

    def on_curve(ibo, lam, *_):
        err = float(np.max(np.abs(lam - bussgang_alpha(ibo).numpy())))
        return {"ok": err <= 0.01, "max_abs_dev": err}

    def peak_at(out, a):
        peak = float(np.degrees(out.angles_rad[int(np.argmax(out.desired_pow))]))
        return {"ok": abs(peak - a) <= 5, "peak_deg": peak}

    def rel(a, b):
        return float(abs(a / b - 1))

    runs = {   # name: (call, predicted launches, check returning {"ok": ..., numbers})
        "beampattern": (lambda: spatial.beampattern(
            n_ant_values=(n_ant,), n_points=36, n_snapshots=10, **qs), 1,
            lambda out: peak_at(out[n_ant], -45.0)),
        "mu_radiation_pattern": (lambda: spatial.mu_radiation_pattern(
            n_ant_values=(n_ant,), n_points=36, n_snapshots=10, **qs), -(-37 // 4) + 2,
            lambda out: {"ok": all(out[n_ant].desired_pow[int(round(36 / 180 * a))]
                                   > np.median(out[n_ant].desired_pow)
                                   for a in (45, 120, 150))}),
        "mu_sinr": (lambda: (spatial.mu_sinr(n_users=4, n_ant=n_ant, n_snapshots=4,
                                             precoding="zf", small=small, **q),
                             spatial.mu_sinr(n_users=4, n_ant=n_ant, n_snapshots=4,
                                             precoding="mrt", small=small, **q)), 2,
                    lambda out: zf_beats_mrt(*out)),
        "evm_vs_ibo": (lambda: spatial.evm_vs_ibo(n_ant=n_ant, ibo_values=(0.0, 4.0, 8.0),
                                                  n_snapshots=4, **qs), 3,
                       lambda out: {"ok": bool(np.all(np.diff(out[1]) < 0)),
                                    "evm": out[1].tolist()}),
        "mu_beampattern": (lambda: spatial.mu_beampattern(
            n_ant=n_ant, n_points=90, n_snapshots=4, usr_angles_deg=(-20.0, 20.0), **qs), 1,
            lambda out: intermod(*out)),
        "channel_corr": (lambda: spatial.channel_corr(
            channels=("los", "rayleigh"), n_ant_values=(n_ant,), n_points=36, **qs), 0,
            lambda out: {"ok": all(abs(out[c][1][0, 9] - 1) < 1e-5 for c in out),
                         "corr_at_main": [float(out[c][1][0, 9]) for c in out]}),
        "spatial_corr": (lambda: spatial.spatial_corr(
            channels=("los",), n_ant_values=(n_ant,), n_points=12, **qs), 0,
            lambda out: {"ok": abs(out["los"][1][0, 3] - 1) < 1e-5,
                         "corr_at_main": float(out["los"][1][0, 3])}),
        "psd_eval": (lambda: spatial.psd_eval(n_ant=n_ant, n_snapshots=16, **qs), 1,
                     lambda out: {"ok": out[1].mean() > 10 * out[2].mean(),
                                  "gap_db": float(db(out[1].mean() / out[2].mean()))}),
        "mu_sdr_vs_angle": (lambda: spatial.mu_sdr_vs_angle(
            n_ant=n_ant, n_points=36, **qs), -(-37 // 8),
            lambda out: {"ok": abs(out[1][12] - 1) < 1e-5
                         and abs(out[2][0, 12] - out[2][1, 12]) < 1e-2,
                         "corr_at_main": float(out[1][12]),
                         "sdr_at_main_db": out[2][:, 12].tolist()}),
        "mu_sdr_vs_nusers": (lambda: spatial.mu_sdr_vs_nusers(
            n_users_values=(1, 3), n_ant=n_ant, ibo_values=(0.0, 6.0), n_snapshots=16, **qs),
            2 * 2 * 2, lambda out: {"ok": all(np.all(s[1] > s[0]) for s in out.values()),
                                    "sdr_db": {k: v.tolist() for k, v in out.items()}}),
        "alpha_eval": (lambda: misc_evals.alpha_eval(n_ant=n_ant, n_snapshots=16,
                                                     small=small, **q), 1,
                       lambda out: {"ok": bool(np.allclose(out[1], out[0], rtol=0.02)),
                                    "max_rel_dev": float(np.max(np.abs(out[1] / out[0] - 1)))}),
        "alpha_vs_tx_pow": (lambda: misc_evals.alpha_vs_tx_pow(n_ant=n_ant, n_snapshots=16,
                                                               **qs), 3,
                            lambda out: on_curve(*out)),
        "precoding_nl_commutation": (lambda: misc_evals.precoding_nl_commutation(
            n_frames=64, small=small, **q), 3,
            lambda out: {"ok": rel(out["flat"], out["none"]) < 1e-5, **out,
                         "flat_rel": rel(out["flat"], out["none"]),
                         "swept_rel": rel(out["swept"], out["none"])}),
        "complexity_eval": (lambda: misc_evals.complexity_eval(**q), 0,
                            lambda out: {"ok": out["cnc"][0][0] == out["std"][0]}),
        "pa_characteristics": (lambda: misc_evals.pa_characteristics(**q), 0,
                               lambda out: {"ok": abs(np.max(out[1]) - 1) < 1e-6}),
        "channel_tf": (lambda: misc_evals.channel_tf(n_ant=n_ant, small=small, **q), 0,
                       lambda out: {"ok": bool(torch.isfinite(out).all())}),
        "siso_rayleigh_zf_cnc": (lambda: siso_checks.siso_rayleigh_zf_cnc(
            snr_min=40.0, snr_max=40.0, n_symb_err_min=10 ** 9,
            n_symb_sent_max=2 * 64 * n_sc, **qs), 1 + 2 * (max(SISO_ITERS) + 2),
            lambda out: {"ok": out[1][0, 0] <= out[1][1, 0], "ser": out[1][:, 0].tolist()}),
    }
    per, total, seconds = {}, 0, 0.0
    for name, (call, expected, physics) in runs.items():
        out, launches, dt = counted(fp, call)
        res = physics(out)
        per[name] = {"launches": launches, "expected_launches": expected, "seconds": dt,
                     "check": bool(res.pop("ok")), **res}
        total += launches
        seconds += dt
        print(json.dumps({"phase": "analysis", "path": "experiments", "experiment": name,
                          **per[name], "card": card}), flush=True)
        check(launches == expected, f"{name} launches", per[name])
        check(per[name]["check"], f"{name} physics check", per[name])
    return {"launches": total, "expected_launches": sum(r[1] for r in runs.values()),
            "seconds": seconds, "experiments": per, "card": card}


def analysis_kernel_vs_plain(config, an, siso_checks, dev, n_ant=64, small=False) -> dict:
    """(f) an f32 LOS radiation pattern (18 points, 10 snapshots) through
    the kernel and through the plain version forced on CUDA tensors, on the
    same draws: powers within 1e-5 of the peak, PSDs within 1e-4 of theirs;
    and one SISO CNC frame batch with equal counters."""
    n_fft, n_sc = (256, 128) if small else (4096, 2048)
    cfg = config.LinkConfig(modem=config.ModemConfig(n_fft=n_fft, n_sub_carr=n_sc),
                            array=config.ArrayConfig(n_elements=n_ant),
                            pa=config.PaConfig(ibo_db=3.0))
    siso = siso_checks.SisoDraws.draw(8, n_sc, 6 * n_sc, False,
                                      torch.Generator(device=dev).manual_seed(5))
    frame = siso_checks._make_siso_frame_fn(64, n_fft, n_sc, 0.0, max(SISO_ITERS), 0.62,
                                            False, dev)
    got = {}
    for plain in (False, True):
        with routed(plain):
            r = an.radiation_pattern(cfg, seed=3, n_points=18, n_snapshots=10,
                                     n_samp_per_seg=min(1024, n_fft // 4), device=dev)
            c = [x.cpu().tolist() for x in frame(25.0, siso)]
        got[plain] = (r, c)
    (k, kc), (p, pc) = got[False], got[True]

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b)))
    line = {"desired_rel": rel(k.desired_pow, p.desired_pow),
            "distortion_rel": rel(k.distortion_pow, p.distortion_pow),
            "psd_rel": max(rel(a, b) for ang in p.psd for a, b in zip(k.psd[ang][1:],
                                                                     p.psd[ang][1:])),
            "siso_kernel": kc, "siso_plain": pc, "siso_equal": kc == pc}
    print(json.dumps({"phase": "frame", "frame": "analysis", **line}), flush=True)
    check(max(line["desired_rel"], line["distortion_rel"]) <= 1e-5, "powers kernel vs plain",
          line)
    check(line["psd_rel"] <= 1e-4, "PSDs kernel vs plain", line)
    check(line["siso_equal"], "SISO frame kernel vs plain", line)
    return line


def analysis_timing(fp, ofdm, dev, card: str = "", n_fft: int = 4096) -> dict:
    """The kernel at the analysis shapes, f32 planes: ``full`` mode at the
    PSD transmit ``[6400, 4096]`` (100 snapshots x 64 antennas) and ``sc``
    mode at the radiation scan's chunk ``[2560, 2048]`` (4 points x 10
    snapshots x 64 antennas), beside the bound and the torch.fft chain with
    the clip (:func:`clip_chain`) and without it; then the interleaved f32
    layout, which the analysis paths launch, at the same shapes
    (:func:`layout_timing`). At each shape the kernel must agree with its
    plain version on the same inputs within 1e-5 relative L2, as in phase
    3."""
    kern = fp.fused_ifft_pa_fft
    g = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for name, rows, mode in (("psd_full_f32", 6400, "full"), ("scan_sc_f32", 2560, "sc")):
        n_io = n_fft if mode == "full" else n_fft // 2
        xr = torch.randn(rows, n_io, generator=g, device=dev)
        xi = torch.randn(rows, n_io, generator=g, device=dev)
        sat = torch.full((rows,), 0.5, device=dev)
        coeff = torch.zeros(rows, device=dev)
        kw = dict(pa_model="softlim", n_fft=n_fft, mode=mode)
        ms = time_ms(lambda: kern(xr, xi, sat, coeff, **kw))
        dev_ms = graph_ms(lambda: kern(xr, xi, sat, coeff, **kw))
        plain_ms = time_ms(lambda: fp.fused_ifft_pa_fft_plain(xr, xi, sat, coeff, **kw))
        x = torch.complex(xr, xi)
        full = x if mode == "full" else ofdm.map_subcarriers(x, n_fft)
        lib_ms = time_ms(lambda: clip_chain(full, sat))
        noclip_ms = time_ms(lambda: torch.fft.fft(torch.fft.ifft(full, norm="ortho"),
                                                  norm="ortho"))
        kr, ki = kern(xr, xi, sat, coeff, **kw)
        pr, pi = fp.fused_ifft_pa_fft_plain(xr, xi, sat, coeff, **kw)
        torch.cuda.synchronize()
        got, ref = torch.complex(kr, ki), torch.complex(pr, pi)
        err, max_abs = rel_err(got, ref), float((got - ref).abs().max())
        n_bytes = rows * n_io * 2 * 4 * 2 + rows * 8
        n_ops = rows * fp.flops_per_row(n_fft, mode)
        bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_F32_FLOPS * 1e3
        out[name] = {"rows": rows, "mode": mode, "layout": "planes_f32", "ms": ms,
                     "graph_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_noclip_ms": noclip_ms, "bound_ms": max(bytes_ms, ops_ms), "bound_share": max(bytes_ms, ops_ms) / ms,
                     "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                     "bytes": n_bytes, "flops": n_ops, "rel_err": err, "max_abs_err": max_abs,
                     "card": card}
        print(json.dumps({"phase": "timing", "shape": name, **out[name]}), flush=True)
        if not (err <= 1e-5 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"kernel vs plain at the {name} shape: {out[name]}")
    for shape in MAIN_SHAPES[2:]:
        out[shape[0]] = layout_timing(fp, ofdm, dev, g, *shape, card=card)
    return out


def clip_chain(full: torch.Tensor, sat: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops over the full band of ``full``:
    torch.fft's IFFT, the soft limiter (a sample of power above the row's
    ``sat`` scaled down to it), torch.fft's FFT; the library yardstick."""
    td = torch.fft.ifft(full, norm="ortho")
    pwr = td.real.square() + td.imag.square()
    s = sat[..., None]
    return torch.fft.fft(td * torch.where(pwr <= s, 1.0, torch.sqrt(s / pwr)), norm="ortho")


def layout_timing(fp, ofdm, dev, g, name: str, rows: int, n_fft: int, mode: str,
                  storage: str, card: str = "") -> dict:
    """The interleaved layout at one of ``MAIN_SHAPES``, softlim at sat
    0.5: ``fused_ifft_pa_fft_complex`` (CUDA events and graph replay), its
    plain version, :func:`clip_chain` and the clip-free torch.fft chain,
    the bound, and the complex-ended chain call as callers see it, after
    (``ops.fused_chain``, the interleaved layout) and before
    (:func:`planes_route`), each by events and by graph replay. Fails
    unless the layout agrees with the plain version within 1e-5 (f32) or
    1e-2 (bf16; the bf16 plain version within 2e-3) relative L2 and with
    the plane route bit for bit. A bf16 layout's bound takes its
    operations at the tensor cores' bf16 rate (:func:`ops_bound_ms`)."""
    from mimo_ofdm_tpu_torch.ops import fused_chain
    n_io = n_fft // 2 if mode == "sc" else n_fft
    x = torch.complex(torch.randn(rows, n_io, generator=g, device=dev),
                      torch.randn(rows, n_io, generator=g, device=dev))
    sat = torch.full((rows,), 0.5, device=dev)
    coeff = torch.zeros(rows, device=dev)
    kw = dict(pa_model="softlim", n_fft=n_fft, mode=mode)
    st = fp.STORAGE_DTYPES[storage]

    def entry():
        return fp.fused_ifft_pa_fft_complex(x, sat, coeff, storage=storage, **kw)

    def caller():
        if mode == "sc":
            return fused_chain.fused_sc_ifft_pa_fft_planar(
                x, n_fft, pa_model="softlim", sat=sat, cubic_coeff=coeff, storage=storage)
        return fused_chain.fused_ifft_pa_fft_planar(x, pa_model="softlim", sat=sat,
                                                    cubic_coeff=coeff, storage=storage)

    def planes():
        return planes_route(fp, x, sat, coeff, storage, **kw)

    def plain():
        pr, pi = fp.fused_ifft_pa_fft_plain(x.real.to(st), x.imag.to(st), sat, coeff, **kw)
        return torch.complex(pr.float(), pi.float())

    full = x if mode == "full" else ofdm.map_subcarriers(x, n_fft)
    exact_ms = time_ms(plain)
    line = {"rows": rows, "n_io": n_io, "mode": mode, "layout": layout_name(storage),
            "ms": time_ms(entry), "graph_ms": graph_ms(entry), "plain_ms": exact_ms,
            "exact_plain_ms": exact_ms,
            "library_ms": time_ms(lambda: clip_chain(full, sat)),
            "library_noclip_ms": time_ms(lambda: torch.fft.fft(
                torch.fft.ifft(full, norm="ortho"), norm="ortho")),
            "caller_ms": time_ms(caller), "caller_graph_ms": graph_ms(caller),
            "caller_planes_ms": time_ms(planes), "caller_planes_graph_ms": graph_ms(planes)}
    got, ref, before = entry(), plain(), planes()
    torch.cuda.synchronize()
    # 8 bytes a point each way, and sat and the cubic coefficient a row
    n_bytes = rows * 2 * n_io * 8 + rows * 8
    planes_bytes = rows * 2 * n_io * 2 * st.itemsize + rows * 8
    n_ops = rows * fp.flops_per_row(n_fft, mode)
    bytes_ms, op_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops_bound_ms(n_ops, st)
    bound = max(bytes_ms, op_ms)
    line.update(bound_ms=bound, bound_share=bound / line["ms"],
                graph_bound_share=bound / line["graph_ms"],
                bound_by="bytes" if bytes_ms > op_ms else "operations", bytes=n_bytes,
                flops=n_ops, planes_bound_ms=max(planes_bytes / H100_BYTES_PER_S * 1e3, op_ms),
                rel_err=rel_err(got, ref), max_abs_err=float((got - ref).abs().max()),
                bitwise_equal_planes=bits_equal(got, before), card=card)
    if st == torch.bfloat16:
        def bf16():
            return bf16_plain(fp, x.real.to(st), x.imag.to(st), sat, coeff, **kw)
        line.update(bf16_plain_columns(fp, rows, n_fft, got, bf16(), bf16),
                    bound_ms_f32_rate=max(bytes_ms, n_ops / H100_F32_FLOPS * 1e3))
    print(json.dumps({"phase": "timing", "shape": name, **line}), flush=True)
    tol = 1e-5 if storage == "float32" else BF16_TOL
    if not (line["rel_err"] <= tol and line["bitwise_equal_planes"]
            and line.get("rel_err_bf16_plain", 0.0) <= BF16_PLAIN_TOL
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"interleaved layout at the {name} shape: {line}")
    return line


def analysis(fp, config, results, dev, card: str = "", n_ant: int = 64,
             small: bool = False) -> dict:
    """Phase 13: the analysis family at full width (``n_ant`` and ``small``,
    the n_fft 256 cut, exist for rehearsals on the CPU; the committed-CSV
    checks (a)-(c) hold at full width only)."""
    from mimo_ofdm_tpu_torch.experiments import ber_sweeps, misc_evals, siso_checks, spatial
    from mimo_ofdm_tpu_torch.models import analysis as an
    out = {}
    if not small:
        out["analysis_radiation"] = radiation_check(fp, results, spatial, dev, card)
        out["analysis_sdr"] = sdr_check(fp, results, spatial, an, dev, card)
        out["analysis_reference_curve"] = reference_curve_check(fp, ber_sweeps, dev, card)
    out["analysis_siso"] = siso_check(fp, results, siso_checks, dev, card, small)
    out["analysis_experiments"] = experiments_check(fp, misc_evals, siso_checks, spatial, dev,
                                                    card, n_ant, small)
    analysis_kernel_vs_plain(config, an, siso_checks, dev, n_ant, small)
    for name, p in out.items():          # (g)
        check(p["launches"] > 0 and p["launches"] == p["expected_launches"],
              f"{name} launches", {"launches": p["launches"],
                                   "expected": p["expected_launches"]})
    return out


# --- phase 14: scale-out -------------------------------------------------------

SCALE_KEY = 7
SCALE_TIMEOUT_S = 300           # the 2-rank job's bound, spawn and gloo set-up included


def scale_cfg(config, channel: str, alg: str, n_ant: int = 64, small: bool = False,
              **changes):
    """Phase 14's frames: the canonical configuration with ``channel``,
    the receiver ``alg`` and the fields in ``changes``. ``small`` (n_fft
    256, ``n_ant`` antennas) exists for rehearsals on the CPU."""
    cfg, _ = config.canonical_miso_cnc()
    cfg = cfg.replace(channel=config.ChannelConfig(model=channel),
                      rx=dataclasses.replace(cfg.rx, algorithm=alg), **changes)
    if small:
        cfg = cfg.replace(modem=dataclasses.replace(cfg.modem, n_fft=256, n_sub_carr=128),
                          array=dataclasses.replace(cfg.array, n_elements=n_ant))
    return cfg


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_vs_unsharded(fp, name: str, sharded_fn, plain_fn, rounds: int, batch: int,
                         snr: float, dev, card: str = "") -> dict:
    """``rounds`` rounds of a sharded round function and of its unsharded
    counterpart for the same ``(key, idx)``, after one warm-up each, with
    the kernel's launches counted over the sharded rounds alone. Fails
    unless the counters are equal and there are 10 launches a round."""
    kern = fp.fused_ifft_pa_fft
    sharded_fn(SCALE_KEY, 10_000, snr)
    plain_fn(SCALE_KEY, 10_000, snr)
    torch.cuda.synchronize()
    zero_launches(kern)
    t0 = time.perf_counter()
    got = [sharded_fn(SCALE_KEY, i, snr) for i in range(rounds)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(kern)
    t0 = time.perf_counter()
    want = [plain_fn(SCALE_KEY, i, snr) for i in range(rounds)]
    torch.cuda.synchronize()
    dt_plain = time.perf_counter() - t0
    got = [g.cpu().tolist() for g in got]
    want = [w.cpu().tolist() for w in want]
    expected = rounds * (1 + N_ITERS + 1)
    line = {"path": name, "rounds": rounds, "batch": batch, "snr_db": snr,
            "counters": got, "unsharded_counters": want, "equal": got == want,
            "launches": launches, "expected_launches": expected,
            "frames_per_s": rounds * batch / dt,
            "unsharded_frames_per_s": rounds * batch / dt_plain, "card": card}
    print(json.dumps({"phase": "scale_out", **line}), flush=True)
    if got != want:
        raise AssertionError(f"scale_out {name}: sharded counters {got} != {want}")
    if launches != expected:
        raise AssertionError(f"scale_out {name}: {launches} launches, expected {expected}")
    return line


def draw_cost(round_fn, dev, reps: int = 5) -> dict:
    """Milliseconds and bytes of one round's global draws on this rank."""
    draws = round_fn.draw(SCALE_KEY, 0)
    tensors = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, tuple):
            for v in x:
                walk(v)
    walk(draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        round_fn.draw(SCALE_KEY, 1 + i)
    torch.cuda.synchronize()
    return {"draw_ms": (time.perf_counter() - t0) / reps * 1e3,
            "draw_bytes": sum(t.numel() * t.element_size() for t in tensors)}


def scale_out_rank(rank: int, world: int, port: int, outdir: str, dev_type: str,
                   batch: int, n_ant: int, small: bool, snr_ray: float,
                   snr_los: float) -> None:
    """One rank of phase 14 (b), a spawned process: joins the gloo group,
    runs one dp-2 round per receiver of the Rayleigh frame and one tp-2
    round per receiver of canonical LOS on the complex64 branch, counting
    its own kernel launches, and writes them to ``outdir/rank<r>.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from datetime import timedelta

    import torch.distributed as dist

    from mimo_ofdm_tpu_torch import kernels
    from mimo_ofdm_tpu_torch.kernels import fused_pa as fp
    from mimo_ofdm_tpu_torch.parallel import multihost, sharded
    from mimo_ofdm_tpu_torch.utils import config

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    multihost.initialize(f"127.0.0.1:{port}", world, rank, local_device_ids=[0],
                         backend="gloo", timeout=timedelta(seconds=120))
    try:
        kern = fp.fused_ifft_pa_fft
        out = {"rank": rank, "plain_versions": not kernels.runs_kernel(torch.device("cuda"))}
        meshes = {"dp2": sharded.make_mesh(n_dp=2), "tp2": sharded.make_mesh(n_tp=2)}
        for axis, channel, snr, storage in (("dp2", "rayleigh", snr_ray, {}),
                                            ("tp2", "los", snr_los,
                                             {"channel_storage": "complex64",
                                              "mxu_fft_storage": "float32"})):
            for alg in ("cnc", "mcnc"):
                cfg = scale_cfg(config, channel, alg, n_ant, small, **storage)
                rf = sharded.make_sharded_round_fn(cfg, N_ITERS, batch, meshes[axis],
                                                   device=dev)
                rf(SCALE_KEY, 10_000, snr)
                torch.cuda.synchronize()
                zero_launches(kern)
                t0 = time.perf_counter()
                c = rf(SCALE_KEY, 0, snr).cpu().tolist()
                out[f"{axis}_{alg}"] = {"counters": c, "launches": kern.launches,
                                        "launches_by_layout": dict(kern.launches_by_layout),
                                        "seconds": time.perf_counter() - t0}
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def two_ranks(fp, config, link, dev, batch: int, snr_ray: float, snr_los: float,
              card: str = "", n_ant: int = 64, small: bool = False) -> dict:
    """Phase 14 (b): two spawned ranks on the one card over gloo (NCCL
    refuses two ranks on one GPU; gloo stages CUDA tensors through the
    host, so these times are no scaling figure). dp 2 on the Rayleigh frame
    must equal the single-process round; tp 2 on canonical LOS (complex64
    branch, f32 chain) must lie within JAX's tolerance for non-exact
    sharding (``|a - b| <= 8 + 0.05 b`` a counter), with the differing bits
    printed; each rank must launch the kernel 10 times a round."""
    import multiprocessing

    want = {}
    for axis, channel, snr, storage in (("dp2", "rayleigh", snr_ray, {}),
                                        ("tp2", "los", snr_los,
                                         {"channel_storage": "complex64",
                                          "mxu_fft_storage": "float32"})):
        for alg in ("cnc", "mcnc"):
            cfg = scale_cfg(config, channel, alg, n_ant, small, **storage)
            want[f"{axis}_{alg}"] = link.make_round_fn(cfg, N_ITERS, batch, device=dev)(
                SCALE_KEY, 0, snr).cpu().tolist()
    n_bits = batch * scale_cfg(config, "los", "cnc", n_ant, small).modem.n_bits_per_ofdm_sym
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=scale_out_rank,
                         args=(r, 2, port, outdir, dev.type, batch, n_ant, small, snr_ray,
                               snr_los)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SCALE_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    seconds = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        shutil.rmtree(outdir, ignore_errors=True)
        raise AssertionError(f"scale_out two_ranks: rank exit codes {codes}")
    ranks = []
    for r in range(2):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(outdir, ignore_errors=True)
    line = {"path": "two_ranks_gloo", "batch": batch, "seconds": seconds, "card": card,
            "launches": sum(r[k]["launches"] for r in ranks for k in want)}
    for r in ranks:
        for k in want:
            add_layout_launches(r[k]["launches_by_layout"])
    for k, w in want.items():
        got = [r[k]["counters"] for r in ranks]
        diff = [abs(a - b) for a, b in zip(got[0], w)]
        line[k] = {"counters": got[0], "single_process": w, "differing_bits": sum(diff),
                   "max_counter_gap": max(diff),
                   "launches_per_rank": [r[k]["launches"] for r in ranks],
                   "seconds_per_rank": [r[k]["seconds"] for r in ranks]}
    print(json.dumps({"phase": "scale_out", **line}), flush=True)
    for k, w in want.items():
        got = [r[k]["counters"] for r in ranks]
        if got[0] != got[1]:
            raise AssertionError(f"scale_out {k}: ranks disagree: {got}")
        if k.startswith("dp2") and got[0] != w:
            raise AssertionError(f"scale_out {k}: {got[0]} != single process {w}")
        if k.startswith("tp2") and not all(abs(a - b) <= 8 + 0.05 * b
                                           for a, b in zip(got[0], w)):
            raise AssertionError(f"scale_out {k}: {got[0]} beyond tolerance of {w}")
        launches = [r[k]["launches"] for r in ranks]
        if launches != [1 + N_ITERS + 1] * 2 or any(r["plain_versions"] for r in ranks):
            raise AssertionError(f"scale_out {k}: rank launches {launches}, expected 10")
    return line


def scale_out(fp, config, link, link_mu, link_ldpc, ber_sweeps, dev, batch: int,
              snr_los: float, snr_coded: float, card: str = "", rounds: int = 3,
              n_ant: int = 64, small: bool = False, backend: str = "nccl") -> dict:
    """Phase 14: scale-out. (a) a world-size-1 NCCL job: the sharded
    single-user (Rayleigh frame, CNC and MCNC, ``rounds`` rounds),
    multi-user (MRT+MCNC-MU) and transport-coded (``ldpc_ref_ber``'s CNC
    round, 16 frames) rounds on its (1, 1) mesh against their unsharded
    counterparts, and one round's draw cost; (c) ``weak_scaling`` on one
    device in the same job; (b) two spawned ranks on the card over gloo
    (:func:`two_ranks`). ``n_ant``, ``small`` and ``backend="gloo"``
    exist for rehearsals on the CPU."""
    from datetime import timedelta

    import torch.distributed as dist

    from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS
    from mimo_ofdm_tpu_torch.models.link import FrameDraws
    from mimo_ofdm_tpu_torch.parallel import multihost, sharded

    kern = fp.fused_ifft_pa_fft
    out = {}
    t_phase = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend=backend,
                         timeout=timedelta(seconds=120))
    try:
        mesh = sharded.make_mesh(1, 1)
        for alg in ("cnc", "mcnc"):
            cfg = scale_cfg(config, "rayleigh", alg, n_ant, small,
                            channel_storage="bfloat16", mxu_fft_storage="bfloat16")
            rf = sharded.make_sharded_round_fn(cfg, N_ITERS, batch, mesh, device=dev)
            out[f"scale_ws1_{alg}"] = sharded_vs_unsharded(
                fp, f"ws1_rayleigh_{alg}", rf,
                link.make_round_fn(cfg, N_ITERS, batch, device=dev), rounds, batch, 15.0,
                dev, card)
        cost = draw_cost(rf, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        f32 = FrameDraws.draw(cfg, batch, gen)
        cost["draw_bytes_f32_fade"] = sum(t.numel() * t.element_size() for t in f32
                                          if isinstance(t, torch.Tensor))
        out["scale_ws1_mcnc"]["draw_cost"] = cost
        print(json.dumps({"phase": "scale_out", "path": "draw_cost", "batch": batch,
                          **cost, "card": card}), flush=True)
        cfg = scale_cfg(config, "los", "mcnc_mu", n_ant, small, precoding="mrt",
                        modem=dataclasses.replace(
                            scale_cfg(config, "los", "cnc", n_ant, small).modem, n_users=2))
        out["scale_ws1_mu"] = sharded_vs_unsharded(
            fp, "ws1_mu_mrt_mcnc_mu",
            sharded.make_sharded_mu_round_fn(cfg, N_ITERS, batch, mesh, device=dev),
            link_mu.make_mu_round_fn(cfg, N_ITERS, batch, device=dev), 1, batch, snr_los,
            dev, card)
        cfg = ber_sweeps.coded_link_config("los", "cnc", n_ant, 0.0, small)
        chain = link_ldpc.reference_chain(cfg, 0.5)
        coded_kw = dict(ldpc_iters=12, ldpc_algorithm="sumprod", device=dev)
        out["scale_ws1_coded"] = sharded_vs_unsharded(
            fp, "ws1_coded_ref_cnc",
            sharded.make_sharded_transport_round_fn(cfg, N_ITERS, CODED_BATCH, chain, mesh,
                                                    **coded_kw),
            link_ldpc.make_transport_round_fn(cfg, N_ITERS, CODED_BATCH, chain, **coded_kw),
            1, CODED_BATCH, snr_coded, dev, card)

        zero_launches(kern)
        t0 = time.perf_counter()
        payload = EXPERIMENTS["weak_scaling"](
            n_ant=n_ant, n_iters=N_ITERS, batch_per_device=batch, device_counts=[1],
            small=small, save_json=False, verbose=False, min_seconds=2.0, device=dev)
        launches = read_launches(kern)
        res = payload["results"]["1"]
        line = {"path": "weak_scaling", "platform": payload["platform"],
                "device_name": payload["device_name"], **res, "launches": launches,
                "seconds": time.perf_counter() - t0, "card": card}
        print(json.dumps({"phase": "scale_out", **line}), flush=True)
        if (res["efficiency"] != 1.0 or not res["frames_per_s"] > 0
                or launches == 0 or launches % (1 + N_ITERS + 1)):
            raise AssertionError(f"scale_out weak_scaling: {line}")
        out["scale_weak_scaling"] = line
    finally:
        dist.destroy_process_group()
    snr_ray = 15.0
    out["scale_two_ranks"] = two_ranks(fp, config, link, dev, batch, snr_ray, snr_los,
                                       card, n_ant, small)
    emit("scale_out", seconds=time.perf_counter() - t_phase,
         launches=sum(p["launches"] for p in out.values()), card=card)
    return out


# --- phase 15: the component API ----------------------------------------------

COMPONENTS_SEED = 15
MAX_DIFF_BITS = 1e-4            # (b): kernel-backed receivers against torch.fft's, a pass
CLIP_TOL = 1e-5                 # (c): fused_ifft_clip_fft against its plain version
MODEM_TOL = 1e-6                # (d): the CP modem's round trip, relative L2


def expect(ok: bool, what: str, line: dict) -> None:
    check(ok, what, line, "components")


def within_binomial(a: int, b: int, n: int, sds: float = 5.0) -> bool:
    """``|a - b|`` within ``sds`` binomial standard deviations of their
    pooled error rate over ``n`` bits."""
    p = (a + b) / (2.0 * n)
    return abs(a - b) <= sds * float(np.sqrt(n * p * (1.0 - p)))


def component_frames(cfg, draws, snr: float, dev):
    """Phase 15 (a)'s frames through the component API on the frame
    round's draws: the full-band channel (``make_channel_fn`` on all
    ``n_fft`` bins), MRT, ``compute_agc``, ``array_transmit_fd`` on
    ``torch.fft``, ``propagate``, ``awgn`` with the draws' data-bin normals
    (zero out of band) and ``equalize``. Returns the equalized clean and
    distorted frames and what the MCNC receiver needs."""
    from mimo_ofdm_tpu_torch.models import agc, channels, link, precoding, receivers, transmit
    from mimo_ofdm_tpu_torch.ops import noise, ofdm

    m = cfg.modem.constel_size
    n_fft, n_sc, n_ant = cfg.modem.n_fft, cfg.modem.n_sub_carr, cfg.array.n_elements
    ibo = cfg.pa.ibo_db
    avg_sym_pow = cfg.modem.avg_symbol_power
    tx_pos, freqs, rx_base = link.link_static(cfg, dev)
    h_fd = link.make_channel_fn(cfg, freqs, rx_base, True)(tx_pos, draws)
    v = precoding.mrt_precoder(ofdm.extract_subcarriers(h_fd, n_sc))
    sat = precoding.pa_sat_power(ibo, cfg.modem.avg_sample_power, v)[:, None]
    st = agc.compute_agc(ofdm.extract_subcarriers(h_fd, n_sc), v, ibo, n_ant, n_fft)

    def received(bits, dist, normals, scaler, agc_nfft):
        fd = transmit.array_transmit_fd(bits, constel_size=m, n_fft=n_fft, v=v,
                                        sat_power=sat, skip_dist=not dist)
        rx = noise.awgn(channels.propagate(h_fd, fd), snr, avg_sym_pow * scaler,
                        noise.complex_normal(ofdm.map_subcarriers(normals, n_fft)))
        return receivers.equalize(rx, agc_nfft)

    rx_c = received(draws.bits_c, False, draws.noise_c, st.hk_vk_noise_scaler,
                    st.hk_vk_agc_nfft)
    rx_d = received(draws.bits_d, True, draws.noise_d, st.ak_hk_vk_noise_scaler,
                    st.ak_hk_vk_agc_nfft)
    return rx_c, rx_d, h_fd, v, sat, st


def components(fp, config, link, dev, snr: float, card: str = "", batch: int = 128,
               n_ant: int = 64, small: bool = False) -> dict:
    """Phase 15: the component API at the canonical width (canonical LOS,
    the complex64 branch's configuration of phase 8, f32 chain).

    (a) one round of the complex64 frame path per receiver (CNC, MCNC) on
    fixed draws, then the same bits, noise and RX offsets through the
    component API (:func:`component_frames`) into ``standard_receive``,
    ``cnc_receive`` and ``mcnc_receive``: sane BERs, the clean standard
    receive at or below CNC's iteration 0, MCNC's iteration 8 no worse
    than its iteration 0, and every counter within 5 binomial sd of the
    frame round's; (b) the same equalized frames through ``cnc_iterate``
    with the kernel-backed replicas (``use_mxu_fft=True``, f32 planes): 9
    launches a receive, at most ``MAX_DIFF_BITS`` of the bits differing
    from (a)'s at any pass; (c) ``fused_ifft_clip_fft`` at the PSD shape
    ``[6400, 4096]`` against its plain version, one launch, within
    ``CLIP_TOL``, with its time; (d) the CP modem's round trip at ``[128,
    64, 2048]``, ``cp_len`` 128, within ``MODEM_TOL``. ``n_ant`` and
    ``small`` (n_fft 256, 64 rows at (c)) exist for rehearsals on the
    CPU."""
    from mimo_ofdm_tpu_torch.models import receivers
    from mimo_ofdm_tpu_torch.ops import bits as bits_ops
    from mimo_ofdm_tpu_torch.ops import ofdm

    kern = fp.fused_ifft_pa_fft
    t_phase = time.perf_counter()
    base = scale_cfg(config, "los", "cnc", n_ant, small, channel_storage="complex64",
                     mxu_fft_storage="float32")
    m, n_sc, n_fft = base.modem.constel_size, base.modem.n_sub_carr, base.modem.n_fft
    n_bits = batch * base.modem.n_bits_per_ofdm_sym
    draws = link.FrameDraws.draw(base, batch,
                                 torch.Generator(device=dev).manual_seed(COMPONENTS_SEED))
    out = {}

    # (a) the frame round, then the component API on its draws
    frame_counts = {}
    for alg in ("cnc", "mcnc"):
        cfg = base.replace(rx=dataclasses.replace(base.rx, algorithm=alg))
        c, launches, _ = counted(fp, lambda: link.make_frame_fn(cfg, N_ITERS, device=dev)(
            snr, draws))
        frame_counts[alg] = [int(c.clean_err.sum())] + c.dist_err.sum(0).cpu().tolist()
        out[f"components_frame_{alg}"] = {"launches": launches,
                                          "expected_launches": 1 + N_ITERS + 1}
        expect(launches == 1 + N_ITERS + 1, f"frame {alg} launches",
               out[f"components_frame_{alg}"])

    def api():
        rx_c, rx_d, h_fd, v, sat, st = component_frames(base, draws, snr, dev)
        kw = dict(constel_size=m, n_sc=n_sc)
        return (rx_d, h_fd, v, sat, st,
                receivers.standard_receive(rx_c, n_sc, m),
                receivers.cnc_receive(rx_d, N_ITERS, ibo_db=base.pa.ibo_db, **kw),
                receivers.mcnc_receive(rx_d, N_ITERS, h_fd, v, st.ak_hk_vk_agc_nfft,
                                       sat_power=sat, **kw))
    (rx_d, h_fd, v, sat, st, clean_bits, cnc_bits, mcnc_bits), launches, seconds = counted(
        fp, api)
    bits_d = draws.bits_d.to(dev)
    clean = int(bits_ops.count_bit_errors(draws.bits_c.to(dev), clean_bits))
    api_counts = {alg: [clean] + bits_ops.count_bit_errors(bits_d, b, axis=-1).sum(-1).cpu()
                  .tolist() for alg, b in (("cnc", cnc_bits), ("mcnc", mcnc_bits))}
    line = {"path": "api_torch_fft", "batch": batch, "snr_db": snr, "n_bits": n_bits,
            "api": api_counts, "frame_round": frame_counts,
            "ber": {k: [x / n_bits for x in v_] for k, v_ in api_counts.items()},
            "launches": launches, "seconds": seconds, "card": card}
    print(json.dumps({"phase": "components", **line}), flush=True)
    for alg, counts in api_counts.items():
        ber = [x / n_bits for x in counts]
        expect(all(0 <= b < 0.5 for b in ber), f"{alg} BER", line)
        expect(all(within_binomial(a, b, n_bits) for a, b in zip(counts, frame_counts[alg])),
               f"{alg}: a counter beyond 5 sd of the frame round's", line)
    expect(api_counts["cnc"][0] <= api_counts["cnc"][1], "clean above CNC iteration 0", line)
    expect(api_counts["mcnc"][-1] <= api_counts["mcnc"][1],
           "MCNC iteration 8 worse than iteration 0", line)
    expect(launches == 0, "the torch.fft receivers launched the kernel", line)
    out["components_api"] = line

    # (b) the same frames through the kernel-backed replicas
    mxu = dict(use_mxu_fft=True, mxu_storage="float32")
    rx_sc = ofdm.extract_subcarriers(rx_d, n_sc)
    replicas = {
        "cnc": receivers.make_cnc_replica(m, n_fft, n_sc, base.pa.ibo_db, **mxu),
        "mcnc": receivers.make_mcnc_replica(
            ofdm.extract_subcarriers(h_fd, n_sc), v,
            ofdm.extract_subcarriers(st.ak_hk_vk_agc_nfft, n_sc), constel_size=m,
            n_fft=n_fft, n_sc=n_sc, sat_power=sat, **mxu)}
    torch_fft_bits = {"cnc": cnc_bits, "mcnc": mcnc_bits}
    for alg, replica in replicas.items():
        (bits_k, _), launches, seconds = counted(
            fp, lambda: receivers.cnc_iterate(rx_sc, N_ITERS, m, replica))
        diff = (bits_k != torch_fft_bits[alg]).flatten(1).sum(-1).cpu().tolist()
        line = {"path": f"kernel_replica_{alg}", "differing_bits": diff,
                "max_share": max(diff) / n_bits, "tol": MAX_DIFF_BITS,
                "launches": launches, "expected_launches": N_ITERS + 1,
                "seconds": seconds, "card": card}
        print(json.dumps({"phase": "components", **line}), flush=True)
        expect(launches == N_ITERS + 1, f"kernel replica {alg} launches", line)
        expect(line["max_share"] <= MAX_DIFF_BITS, f"kernel replica {alg} differs", line)
        out[f"components_kernel_{alg}"] = line

    # (c) fused_ifft_clip_fft by name at the PSD shape
    rows = 64 if small else 6400
    g = torch.Generator(device=dev).manual_seed(COMPONENTS_SEED)
    x = torch.complex(torch.randn(rows, fp.N, generator=g, device=dev),
                      torch.randn(rows, fp.N, generator=g, device=dev))
    sat_c = 1.5
    y, launches, _ = counted(fp, lambda: fp.fused_ifft_clip_fft(x, sat_c))
    interleaved = kern.launches_by_layout["interleaved_f32"]
    ones = torch.ones(rows, device=dev)
    full = dict(pa_model="softlim", n_fft=fp.N, mode="full")
    pr, pi = fp.fused_ifft_pa_fft_plain(x.real, x.imag, ones * sat_c, ones * 0.0, **full)
    ref = torch.complex(pr, pi)
    err = rel_err(y, ref)
    # the route it took before it had the interleaved layout
    before = planes_route(fp, x, sat_c, **full)
    line = {"path": "fused_ifft_clip_fft", "shape": [rows, fp.N], "rel_err": err,
            "max_abs_err": float((y - ref).abs().max()), "tol": CLIP_TOL,
            "bitwise_equal_planes": bits_equal(y, before), "launches": launches,
            "interleaved_f32_launches": interleaved, "expected_launches": 1, "card": card}
    if dev.type == "cuda":
        # complex64 in and out: each input byte read once, each output byte
        # written once; the split-radix operations of two transforms a row
        bytes_ms = 2 * x.numel() * x.element_size() / H100_BYTES_PER_S * 1e3
        ops_ms = rows * fp.flops_per_row(fp.N, "full") / H100_F32_FLOPS * 1e3
        line.update(ms=time_ms(lambda: fp.fused_ifft_clip_fft(x, sat_c)),
                    graph_ms=graph_ms(lambda: fp.fused_ifft_clip_fft(x, sat_c)),
                    plain_ms=time_ms(lambda: fp.fused_ifft_pa_fft_plain(
                        x.real, x.imag, ones * sat_c, ones * 0.0, **full)),
                    library_ms=time_ms(lambda: clip_chain(x, ones * sat_c)),
                    library_noclip_ms=time_ms(lambda: ofdm.td_to_fd(ofdm.fd_to_td(x))),
                    planes_ms=time_ms(lambda: planes_route(fp, x, sat_c, **full)),
                    planes_graph_ms=graph_ms(lambda: planes_route(fp, x, sat_c, **full)),
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms > ops_ms else "operations")
        line["bound_share"] = line["bound_ms"] / line["ms"]
    print(json.dumps({"phase": "components", **line}), flush=True)
    expect(launches == 1 and (interleaved == 1 or dev.type != "cuda")
           and line["bitwise_equal_planes"]
           and err <= CLIP_TOL and bool(torch.isfinite(y).all()), "fused_ifft_clip_fft", line)
    out["components_fused_ifft_clip_fft"] = line

    # (d) the CP modem's round trip
    n_frames = 8 if small else 128
    sym = torch.complex(torch.randn(n_frames, n_ant, n_sc, generator=g, device=dev),
                        torch.randn(n_frames, n_ant, n_sc, generator=g, device=dev))
    cp_len = base.modem.cp_len
    td = ofdm.ofdm_modulate(sym, n_fft, cp_len)
    back = ofdm.ofdm_demodulate(td, n_sc, cp_len)
    line = {"path": "ofdm_modem", "shape": list(sym.shape), "cp_len": cp_len,
            "td_shape": list(td.shape), "rel_err": rel_err(back, sym), "tol": MODEM_TOL,
            "launches": 0, "card": card}
    print(json.dumps({"phase": "components", **line}), flush=True)
    expect(tuple(td.shape) == (n_frames, n_ant, n_fft + cp_len)
           and line["rel_err"] <= MODEM_TOL, "CP modem round trip", line)
    out["components_ofdm_modem"] = line
    emit("components", seconds=time.perf_counter() - t_phase,
         launches=sum(p["launches"] for p in out.values()), card=card)
    return out


# --- phase 16: the port's bench ------------------------------------------------

BENCH_ENV = {"BENCH_WINDOWS": "3", "BENCH_WINDOW_S": "1"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "windows", "mcnc_frames_per_s",
              "mcnc_windows", "device"}
BENCH_TIMEOUT_S = 600           # the module in a subprocess: its start, warm-up, windows


def bench_phase(fp, bench, dev, sync: dict, card: str = "") -> dict:
    """Phase 16: ``bench.run`` at full width, its default batches and depth,
    3 windows of 1 s an arm, with the kernel's launch count zeroed just
    before and read just after; fails unless bench.py's keys plus
    ``device`` come back, every round launched the kernel 10 times, and the
    counters the bench consumed are sane (every BER in [0, 0.5), clean
    below iteration 0, MCNC iteration 8 no worse than iteration 0). Then
    ``python -m mimo_ofdm_tpu_torch.bench`` once in a subprocess with the
    same windows, which must print exactly one JSON line with those keys.
    ``sync`` holds phase 4's synchronous rounds, for the ratio."""
    kern = fp.fused_ifft_pa_fft
    settings = bench.settings(BENCH_ENV)
    cfg = bench.workload()
    batches = {"cnc": settings["batch"], "mcnc": settings["mcnc_batch"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kern)
    tallies = {}
    t0 = time.perf_counter()
    out = bench.run(cfg, **settings, device=dev, tallies=tallies)
    seconds = time.perf_counter() - t0
    launches = read_launches(kern)
    peak = torch.cuda.max_memory_allocated()
    rounds = sum(t["rounds"] for t in tallies.values())
    medians = {"cnc": out["value"], "mcnc": out["mcnc_frames_per_s"]}
    arms = {arm: {"batch": batches[arm], "rounds": t["rounds"], "counters": t["counters"],
                  "ber": [c / (t["rounds"] * batches[arm] * cfg.modem.n_bits_per_ofdm_sym)
                          for c in t["counters"]],
                  "median_frames_per_s": medians[arm],
                  "windows": out["windows" if arm == "cnc" else "mcnc_windows"],
                  "vs_sync": medians[arm] / sync[arm]["frames_per_s"],
                  "sync_frames_per_s": sync[arm]["frames_per_s"],
                  "sync_batch": sync[arm]["batch"]}
            for arm, t in tallies.items()}
    line = {"settings": settings, "bench_line": out, "arms": arms, "seconds": seconds,
            "rounds": rounds, "launches": launches, "launches_per_round": launches / rounds,
            "launches_by_layout": dict(kern.launches_by_layout),
            "peak_memory_bytes": peak, "card": card}
    print(json.dumps({"phase": "bench", **line}), flush=True)
    check(set(out) == BENCH_KEYS, "bench.py's keys plus device", line, "bench")
    check(launches == rounds * (N_ITERS + 2), "10 kernel launches a round", line, "bench")
    for arm, a in arms.items():
        ber = a["ber"]
        check(all(0 <= b < 0.5 for b in ber) and ber[0] < ber[1], f"{arm}: sane BERs",
              line, "bench")
        check(arm != "mcnc" or ber[-1] <= ber[1], "mcnc: iteration 8 no worse than 0",
              line, "bench")

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "mimo_ofdm_tpu_torch.bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          env={**env, **BENCH_ENV}, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    printed = proc.stdout.strip().splitlines()
    sub = {"returncode": proc.returncode, "lines": len(printed),
           "line": json.loads(printed[0]) if len(printed) == 1 else printed[-5:],
           "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""}
    print(json.dumps({"phase": "bench", "module": sub, "card": card}), flush=True)
    check(proc.returncode == 0 and len(printed) == 1 and set(sub["line"]) == BENCH_KEYS,
          "python -m mimo_ofdm_tpu_torch.bench prints one line with the keys", sub, "bench")
    line["module"] = sub["line"]
    return {"bench": line}


def bench_shapes(fp, ofdm, dev, settings: dict, card: str = "") -> dict:
    """The kernel at the bench's shapes (phase 16's settings): the TX launch
    on bf16 planes ``[batch * 64, 2048]`` of each arm, each within 1e-2
    relative L2 of the exact plain version and 2e-3 of the bf16 one, and in
    the precoded bf16 layout, which the TX and the MCNC replica passes run
    (:func:`precoded_timing`), and the CNC replica pass in the interleaved
    bf16 layout ``[batch, 2048]``."""
    g = torch.Generator(device=dev).manual_seed(16)
    tx = {"bench_tx": settings["batch"]}
    if settings["mcnc_batch"] not in (None, settings["batch"]):
        tx["bench_mcnc_tx"] = settings["mcnc_batch"]
    out = {}
    for name, b in tx.items():
        out[name] = planes_timing(fp, ofdm, dev, g, name, b * 64, torch.bfloat16, card)
        check(out[name]["rel_err"] <= BF16_TOL
              and out[name]["rel_err_bf16_plain"] <= BF16_PLAIN_TOL,
              f"kernel at {name}", out[name], "bench")
        out[f"{name}_precoded"] = precoded_timing(fp, ofdm, dev, g, f"{name}_precoded", b,
                                                  torch.bfloat16, card)
    out["bench_cnc_replica"] = layout_timing(fp, ofdm, dev, g, "bench_cnc_replica",
                                             settings["batch"], 4096, "sc", "bfloat16", card)
    return out


def planes_timing(fp, ofdm, dev, g, name: str, rows: int, dtype, card: str = "",
                  n_fft: int = 4096, n_sc: int = 2048) -> dict:
    """The kernel on ``sc`` planes of ``dtype`` at ``[rows, n_sc]``, softlim
    at sat 0.5: CUDA events, graph replay, without the PA, its plain
    version, :func:`clip_chain` and the clip-free torch.fft chain, the
    bound (bf16: its operations at the tensor cores' rate, :func:`ops_bound_ms`),
    and its error against the plain version (relative L2 and largest)."""
    kern = fp.fused_ifft_pa_fft
    xr = torch.randn(rows, n_sc, generator=g, device=dev).to(dtype)
    xi = torch.randn(rows, n_sc, generator=g, device=dev).to(dtype)
    sat = torch.full((rows,), 0.5, device=dev)
    coeff = torch.zeros(rows, device=dev)
    kw = dict(pa_model="softlim", n_fft=n_fft, mode="sc")
    ms = time_ms(lambda: kern(xr, xi, sat, coeff, **kw))
    dev_ms = graph_ms(lambda: kern(xr, xi, sat, coeff, **kw))
    # the same launch with the PA switched off: what the PA costs in it
    no_pa_ms = time_ms(lambda: kern(xr, xi, sat, coeff, **{**kw, "pa_model": "none"}))
    exact_ms = time_ms(lambda: fp.fused_ifft_pa_fft_plain(xr, xi, sat, coeff, **kw))
    full = ofdm.map_subcarriers(torch.complex(xr.float(), xi.float()), n_fft)
    lib_ms = time_ms(lambda: clip_chain(full, sat))
    noclip_ms = time_ms(lambda: torch.fft.fft(torch.fft.ifft(full, norm="ortho"),
                                              norm="ortho"))
    kr, ki = kern(xr, xi, sat, coeff, **kw)
    pr, pi = fp.fused_ifft_pa_fft_plain(xr, xi, sat, coeff, **kw)
    torch.cuda.synchronize()
    got, ref = torch.complex(kr.float(), ki.float()), torch.complex(pr.float(), pi.float())
    n_bytes = rows * n_sc * 2 * xr.element_size() * 2 + rows * 8
    n_ops = rows * fp.flops_per_row(n_fft, "sc")
    bytes_ms, op_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops_bound_ms(n_ops, dtype)
    line = {"rows": rows, "mode": "sc", "ms": ms, "graph_ms": dev_ms,
            "layout": "planes_bf16" if dtype == torch.bfloat16 else "planes_f32",
            "ms_without_pa": no_pa_ms, "plain_ms": exact_ms, "exact_plain_ms": exact_ms,
            "library_ms": lib_ms, "library_noclip_ms": noclip_ms,
            "bound_ms": max(bytes_ms, op_ms),
            "bound_share": max(bytes_ms, op_ms) / ms,
            "bound_by": "bytes" if bytes_ms > op_ms else "operations",
            "bytes": n_bytes, "flops": n_ops, "ns_per_row": ms * 1e6 / rows,
            "rel_err": rel_err(got, ref), "max_abs_err": float((got - ref).abs().max()),
            "card": card}
    if dtype == torch.bfloat16:
        # the layout's own plain version is the tensor-core arithmetic's
        plain = bf16_plain(fp, xr, xi, sat, coeff, **kw)
        line.update(bf16_plain_columns(fp, rows, n_fft, got, plain,
                                       lambda: bf16_plain(fp, xr, xi, sat, coeff, **kw)),
                    bound_ms_f32_rate=max(bytes_ms, n_ops / H100_F32_FLOPS * 1e3))
    print(json.dumps({"phase": "timing", "shape": name, **line}), flush=True)
    return line


def precoded_timing(fp, ofdm, dev, g, name: str, frames: int, dtype, card: str = "",
                    n_ant: int = 64, n_fft: int = 4096, n_sc: int = 2048) -> dict:
    """The precoded layout at the transmitter's shape, ``frames`` frames of
    ``n_ant`` rows on ``sc`` planes of ``dtype``, softlim at sat 0.5: CUDA
    events and graph replay of ``fused_precoded_ifft_pa_fft``, and of the
    route it replaces (``precode_planes``, then the planes' layout) and of
    that route's launch alone, the precode followed by the layout's plain
    version and by :func:`clip_chain`, and the bound (the precoder's planes
    in, the output planes out, the symbols once a frame). Fails unless the
    layout equals that route bit for bit and agrees with the plain version
    on the same inputs within 1e-5 (f32) or 1e-2 (bf16; the bf16 plain
    version within 2e-3) relative L2."""
    sym = torch.complex(torch.randn(frames, n_sc, generator=g, device=dev),
                        torch.randn(frames, n_sc, generator=g, device=dev))
    v = torch.randn(2, frames, n_ant, n_sc, generator=g, device=dev) / math.sqrt(n_ant)
    vr, vi = v[0].to(dtype), v[1].to(dtype)
    rows = frames * n_ant
    sat = torch.full((frames, n_ant), 0.5, device=dev)
    coeff = torch.zeros(frames, n_ant, device=dev)
    kw = dict(pa_model="softlim", n_fft=n_fft)

    def precoded():
        return fp.fused_precoded_ifft_pa_fft(sym, vr, vi, sat, coeff, **kw)

    def eager():
        return fp.fused_ifft_pa_fft(*fp.precode_planes(sym, vr, vi), sat, coeff, mode="sc", **kw)

    def plain():
        pr, pi = fp.fused_ifft_pa_fft_plain(*fp.precode_planes(sym, vr, vi), sat, coeff,
                                            mode="sc", **kw)
        return torch.complex(pr.float(), pi.float())

    def full():
        pr, pi = fp.precode_planes(sym, vr, vi)
        return ofdm.map_subcarriers(torch.complex(pr.float(), pi.float()), n_fft)

    pr, pi = fp.precode_planes(sym, vr, vi)
    got, want, ref = precoded(), eager(), plain()
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    equal = all(torch.equal(a.view(bits), b.view(bits)) for a, b in zip(got, want))
    got = torch.complex(got[0].float(), got[1].float())
    n_bytes = rows * n_sc * 2 * vr.element_size() * 2 + frames * n_sc * 8 + rows * 8
    n_ops = rows * fp.flops_per_row(n_fft, "sc")
    bytes_ms, op_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops_bound_ms(n_ops, dtype)
    ms, exact_ms = time_ms(precoded), time_ms(plain)
    line = {"rows": rows, "mode": "sc", "ms": ms, "graph_ms": graph_ms(precoded),
            "layout": "precoded_bf16" if dtype == torch.bfloat16 else "precoded_f32",
            "eager_route_ms": time_ms(eager), "eager_route_graph_ms": graph_ms(eager),
            "planes_ms": time_ms(lambda: fp.fused_ifft_pa_fft(pr, pi, sat, coeff, mode="sc",
                                                              **kw)),
            "plain_ms": exact_ms, "exact_plain_ms": exact_ms,
            "library_ms": time_ms(lambda: clip_chain(full(), sat)),
            "library_noclip_ms": time_ms(lambda: torch.fft.fft(
                torch.fft.ifft(full(), norm="ortho"), norm="ortho")),
            "bound_ms": max(bytes_ms, op_ms), "bound_share": max(bytes_ms, op_ms) / ms,
            "bound_by": "bytes" if bytes_ms > op_ms else "operations", "bytes": n_bytes,
            "flops": n_ops, "rel_err": rel_err(got, ref),
            "max_abs_err": float((got - ref).abs().max()),
            "bitwise_equal_eager_route": equal, "card": card}
    if dtype == torch.bfloat16:
        def bf16():
            return bf16_plain(fp, pr, pi, sat, coeff, mode="sc", **kw)
        line.update(bf16_plain_columns(fp, rows, n_fft, got, bf16(), bf16),
                    bound_ms_f32_rate=max(bytes_ms, n_ops / H100_F32_FLOPS * 1e3))
    print(json.dumps({"phase": "timing", "shape": name, **line}), flush=True)
    tol = 1e-5 if dtype == torch.float32 else BF16_TOL
    check(equal and line["rel_err"] <= tol
          and line.get("rel_err_bf16_plain", 0.0) <= BF16_PLAIN_TOL
          and bool(torch.isfinite(got).all()),
          f"precoded layout at {name}: the eager precode and the planes bit for bit, "
          "the plain version within its tolerance", line, "timing")
    return line


# the precoded_mu layout's shapes in the two-user cell: (name, frames, an
# MCNC-MU replica pass: rows [2, frames, 64], else the TX: [frames, 64])
MU_SHAPES = (("mcnc_mu_precoded_mu", 128, True), ("mu_tx_precoded_mu", 128, False))


def precoded_mu_timing(fp, ofdm, dev, g, name: str, frames: int, replica: bool,
                       card: str = "", n_ant: int = 64, n_usr: int = 2, n_fft: int = 4096,
                       n_sc: int = 2048) -> dict:
    """The precoded_mu bf16 layout at the two-user cell's shapes: the TX
    (``[frames, n_ant]`` rows) or an MCNC-MU replica pass (``[n_usr,
    frames, n_ant]`` rows, each user's detection swapped in), softlim at
    sat 0.5, a precoder laid out users first as the joint MRT returns it:
    CUDA events and graph replay of ``fused_precoded_mu_ifft_pa_fft`` and
    of the route it replaces (the eager swap and precode, then the
    interleaved layout) and of that route's launch alone, the bf16 plain
    version, :func:`clip_chain` and the clip-free torch.fft chain, and the
    bound (V read once, the symbols, the output). Fails unless it equals
    the route it replaces bit for bit and lies within 2e-3 relative L2 of
    the bf16 plain version."""
    def cplx(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=dev),
                             torch.randn(*shape, generator=g, device=dev))

    usr = cplx(frames, n_usr, n_sc)
    det = cplx(n_usr, frames, n_sc) if replica else None
    v = (cplx(n_usr, frames, n_ant, n_sc) / math.sqrt(n_ant)).permute(1, 2, 0, 3)
    lead = ((n_usr,) if replica else ()) + (frames, n_ant)
    rows = math.prod(lead)
    sat = torch.full(lead, 0.5, device=dev)
    kw = dict(pa_model="softlim", n_fft=n_fft, storage="bfloat16")

    def fused():
        return fp.fused_precoded_mu_ifft_pa_fft(usr, v, sat, det_sym=det, **kw)

    def precode():
        return fp.precode_users(usr if det is None else fp.swap_detections(det, usr), v)

    def eager():
        return fp.fused_ifft_pa_fft_complex(precode(), sat, mode="sc", **kw)

    x = precode()
    full = ofdm.map_subcarriers(x, n_fft)
    got, want = fused(), eager()
    plain = bf16_plain(fp, x.real.bfloat16(), x.imag.bfloat16(), sat, pa_model="softlim",
                       n_fft=n_fft, mode="sc")
    torch.cuda.synchronize()
    ms = time_ms(fused)
    line = {"rows": rows, "mode": "sc", "layout": "precoded_mu_bf16", "ms": ms,
            "graph_ms": graph_ms(fused),
            "eager_route_ms": time_ms(eager), "eager_route_graph_ms": graph_ms(eager),
            "eager_precode_ms": time_ms(precode),
            "interleaved_ms": time_ms(lambda: fp.fused_ifft_pa_fft_complex(x, sat, mode="sc",
                                                                          **kw)),
            "bitwise_equal_eager_route": bits_equal(got, want)}
    n_bytes = (frames * n_ant * n_usr * n_sc * 8 + (2 if replica else 1) * frames * n_usr
               * n_sc * 8 + rows * n_sc * 8 + rows * 8)
    n_ops = rows * fp.flops_per_row(n_fft, "sc")
    bytes_ms, op_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops_bound_ms(n_ops, torch.bfloat16)
    exact = fp.fused_ifft_pa_fft_plain(x.real, x.imag, sat, torch.zeros_like(sat),
                                       pa_model="softlim", n_fft=n_fft, mode="sc")
    exact = torch.complex(*exact)
    line.update(bound_ms=max(bytes_ms, op_ms), bound_share=max(bytes_ms, op_ms) / ms,
                graph_bound_share=max(bytes_ms, op_ms) / line["graph_ms"],
                bound_by="bytes" if bytes_ms > op_ms else "operations", bytes=n_bytes,
                flops=n_ops, rel_err=rel_err(got, exact),
                exact_plain_ms=time_ms(lambda: fp.fused_ifft_pa_fft_plain(
                    x.real, x.imag, sat, torch.zeros_like(sat), pa_model="softlim",
                    n_fft=n_fft, mode="sc"), n=5, warmup=1),
                library_ms=time_ms(lambda: clip_chain(full, sat)),
                library_noclip_ms=time_ms(lambda: torch.fft.fft(
                    torch.fft.ifft(full, norm="ortho"), norm="ortho")), card=card)
    line.update(bf16_plain_columns(fp, rows, n_fft, got, plain,
                                   lambda: bf16_plain(fp, x.real.bfloat16(), x.imag.bfloat16(),
                                                      sat, pa_model="softlim", n_fft=n_fft,
                                                      mode="sc")))
    print(json.dumps({"phase": "timing", "shape": name, **line}), flush=True)
    check(line["bitwise_equal_eager_route"]
          and line["rel_err_bf16_plain"] <= BF16_PLAIN_TOL and line["rel_err"] <= BF16_TOL
          and bool(torch.isfinite(got).all()),
          f"precoded_mu layout at {name}: the eager swap, precode and interleaved layout bit "
          "for bit, the plain versions within their tolerances", line,
          "timing")
    return line


def bf16_plain_columns(fp, rows: int, n_fft: int, got, plain, plain_fn) -> dict:
    """A bf16 layout's timing line against its own plain version: that
    version's time (``plain_ms``; the exact one's stays ``exact_plain_ms``),
    the kernel's error against it (``max_abs_err``; against the exact one
    ``rel_err``), and the tensor-core products' flops with their time at
    the dense bf16 peak (timing lines only; the kernels line keeps
    ``bound_ms``)."""
    flops = tensor_core_flops(rows, n_fft)
    return {"plain_ms": time_ms(plain_fn, n=5, warmup=1),
            "rel_err_bf16_plain": rel_err(got, plain),
            "max_abs_err": float((got - plain).abs().max()),
            "tensor_core_flops": flops, "tensor_core_ms": flops / H100_BF16_FLOPS * 1e3}


def timing(fp, ofdm, dev, batch: int, card: str = "", n_fft: int = 4096,
           n_sc: int = 2048) -> dict:
    """Phase 6: kernel, plain and torch.fft chain (with and without the
    clip) at the main path's shapes on planes; the precoded f32 layout at
    the TX shape (:func:`precoded_timing`); then the interleaved bf16
    layout at the TX shape (:func:`layout_timing`), and the precoded_mu
    bf16 layout that the two-user TX and MCNC-MU replica passes run
    (:func:`precoded_mu_timing`, which also times the interleaved launch
    at an MCNC-MU pass)."""
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, rows, dtype in (("tx", batch * 64, torch.bfloat16),
                              ("cnc_replica", batch, torch.bfloat16),
                              ("tx_f32", batch * 64, torch.float32),
                              ("cnc_replica_f32", batch, torch.float32)):
        out[name] = planes_timing(fp, ofdm, dev, g, name, rows, dtype, card, n_fft, n_sc)
        if dtype == torch.bfloat16:
            check(out[name]["rel_err"] <= BF16_TOL
                  and out[name]["rel_err_bf16_plain"] <= BF16_PLAIN_TOL,
                  f"bf16 kernel at the {name} shape", out[name], "timing")
    out["tx_precoded_f32"] = precoded_timing(fp, ofdm, dev, g, "tx_precoded_f32", batch,
                                             torch.float32, card, n_fft=n_fft, n_sc=n_sc)
    out[MAIN_SHAPES[0][0]] = layout_timing(fp, ofdm, dev, g, *MAIN_SHAPES[0], card=card)
    for name, frames, replica in MU_SHAPES:
        out[name] = precoded_mu_timing(fp, ofdm, dev, g, name, frames, replica, card,
                                       n_fft=n_fft, n_sc=n_sc)
    return out


# frames of the combine kernel's timing shapes: MCNC b512's pass and LOS b32's
COMBINE_FRAMES = (512, 32)
COMBINE_TOL = 1e-5              # relative L2 of the combine kernel against the eager one


def combine_build(ac) -> dict:
    """The antenna combine kernel's build (``csrc/antenna_combine.cu``):
    ptxas's report and each instantiation's resources. Fails if one spills
    or holds fewer than 4 blocks an SM."""
    t0 = time.perf_counter()
    _, ptxas = ac.build_library()
    seconds = time.perf_counter() - t0
    print(ptxas, flush=True)
    resources = ac.kernel_resources()
    line = {"seconds": seconds, "instantiations": resources}
    emit("combine_build", **line)
    check(all(r["local_bytes"] == 0 and r["blocks_per_sm"] >= 4 for r in resources),
          "combine kernel: no spills, 4 blocks an SM", line, "combine_build")
    return line


def combine_timing(ac, dev, card: str = "", n_ant: int = 64, n_sc: int = 2048) -> dict:
    """The antenna combine kernel at MCNC b512's and LOS b32's TX shapes,
    ``[B, n_ant, n_sc]`` bf16 planes: CUDA events and graph replay of the
    kernel and of its plain version (the eager expression it replaces),
    the bound (the four planes in, complex64 out, at 3.35 TB/s) and the
    kernel's error against the plain version. Fails unless it agrees
    within ``COMBINE_TOL`` relative L2 (the float32 sum's order alone
    differs) and two calls give the same bits."""
    g = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for frames in COMBINE_FRAMES:
        p = [(torch.randn(frames, n_ant, n_sc, generator=g, device=dev) / 8).bfloat16()
             for _ in range(4)]
        got, again = ac.antenna_combine(*p), ac.antenna_combine(*p)
        ref = ac.antenna_combine_plain(*p)
        torch.cuda.synchronize()
        n_bytes = 4 * frames * n_ant * n_sc * 2 + frames * n_sc * 8
        ms = time_ms(lambda: ac.antenna_combine(*p))
        line = {"shape": [frames, n_ant, n_sc], "ms": ms,
                "graph_ms": graph_ms(lambda: ac.antenna_combine(*p)),
                "plain_ms": time_ms(lambda: ac.antenna_combine_plain(*p)),
                "plain_graph_ms": graph_ms(lambda: ac.antenna_combine_plain(*p)),
                "bytes": n_bytes, "bound_ms": n_bytes / H100_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "rel_err": rel_err(got, ref), "max_abs_err": float((got - ref).abs().max()),
                "deterministic": bool(torch.equal(got, again)), "card": card}
        line["bound_share"] = line["bound_ms"] / ms
        line["graph_bound_share"] = line["bound_ms"] / line["graph_ms"]
        print(json.dumps({"phase": "combine_timing", **line}), flush=True)
        check(line["rel_err"] <= COMBINE_TOL and line["deterministic"]
              and bool(torch.isfinite(got).all()),
              f"combine kernel at [{frames}, {n_ant}, {n_sc}] against its plain version",
              line, "combine_timing")
        out[f"combine_b{frames}"] = line
    return out


def combine_row(build: dict, times: dict, smi: str) -> dict:
    """The combine kernel's row of the ``{"kernels": [...]}`` line: its
    launches in the paths' timed rounds (drive_path) and its times at MCNC
    b512's pass."""
    t = times[f"combine_b{COMBINE_FRAMES[0]}"]
    return {"name": "antenna_combine", "route": "cuda",
            "source": "mimo_ofdm_tpu_torch/csrc/antenna_combine.cu", "replaces": None,
            "launches": COMBINE_LAUNCHES[0],
            "registers": [r["registers"] for r in build["instantiations"]],
            **{f: t[f] for f in ("shape", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                                 "bound_share", "rel_err", "max_abs_err")},
            "shapes": times, "card": smi}


def kernels_line(paths: dict, times: dict, analysis_times: dict, smi: str) -> dict:
    """The ``{"kernels": [...]}`` line: one row per I/O layout of the
    kernel, with the launches the paths made in it (``LAYOUT_LAUNCHES``)
    and its times at the shape where the paths launch it most; the first
    row also carries the launches in all, by path, and the
    ``fused_ifft_clip_fft`` entry point's numbers. Fails if the layouts'
    launches do not add up to the paths' or a layout other than
    ``PLANES_LAYOUTS`` was never launched; the planes' rows keep their
    times at the same shapes."""
    clip = paths["components_fused_ifft_clip_fft"]
    launches = sum(p["launches"] for p in paths.values())
    if sum(LAYOUT_LAUNCHES.values()) != launches:
        raise AssertionError(f"launches by layout {LAYOUT_LAUNCHES} do not add up to {launches}")
    keep = ("rows", "mode", "ms", "graph_ms", "plain_ms", "library_ms", "library_noclip_ms",
            "bound_ms", "bound_by", "bound_share", "max_abs_err")
    shapes = {**times, **analysis_times}
    # each layout's row: its times at the shape where the paths launch it
    # most; the bench (phase 16) launches the two bf16 layouts most
    rows = (("precoded_bf16", "bench_tx_precoded", "bench TX and MCNC replica pass, sc "
             f"precoded bf16 [{shapes['bench_tx_precoded']['rows']}, 2048]"),
            ("precoded_f32", "tx_precoded_f32", "main-path TX at f32 storage, sc precoded "
             f"f32 [{shapes['tx_precoded_f32']['rows']}, 2048]"),
            ("precoded_mu_bf16", "mcnc_mu_precoded_mu", "MCNC-MU replica pass, sc "
             f"precoded_mu bf16 [{shapes['mcnc_mu_precoded_mu']['rows']}, 2048] (the MU TX: "
             f"[{shapes['mu_tx_precoded_mu']['rows']}, 2048])"),
            ("planes_bf16", "bench_tx", "bench TX shape, sc bf16 planes "
             f"[{shapes['bench_tx']['rows']}, 2048]"),
            ("planes_f32", "scan_sc_f32", "radiation-scan chunk, sc f32 planes [2560, 2048]"),
            ("interleaved_bf16", "bench_cnc_replica",
             "bench CNC replica pass, sc complex64 rounded to bf16 "
             f"[{shapes['bench_cnc_replica']['rows']}, 2048]"),
            ("interleaved_f32", "psd_full_interleaved_f32",
             "PSD transmit and fused_ifft_clip_fft, full complex64 [6400, 4096]"))
    kernels = {"kernels": [{
        "name": f"fused_ifft_pa_fft[{layout}]", "route": "cuda",
        "source": "mimo_ofdm_tpu_torch/csrc/fused_pa.cu",
        "replaces": "mimo_ofdm_tpu/kernels/fused_pa.py:113",
        "replaces_function": "mimo_ofdm_tpu/kernels/fused_pa.py::fused_ifft_clip_fft",
        "launches": LAYOUT_LAUNCHES.get(layout, 0),
        **{f: shapes[key][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "bound_share", "graph_ms")},
        "shape": what,
        "exact_plain_ms": shapes[key].get("exact_plain_ms", shapes[key]["plain_ms"]),
        **{f: shapes[key][f] for f in ("rel_err_bf16_plain",) if f in shapes[key]},
        # a precoded row: the time of the route it replaces, which it equals bit for bit
        **({"eager_route_ms": shapes[key]["eager_route_ms"]} if layout in PRECODED_LAYOUTS
           else {}),
        "shapes": {k: {f: t[f] for f in keep} for k, t in shapes.items()
                   if t["layout"] == layout},
        "card": smi} for layout, key, what in rows]}
    kernels["kernels"][0].update(
        launches_all_layouts=launches,
        launches_by_path={k: p["launches"] for k, p in paths.items()},
        max_rel_err=RESULTS["kernel_summary"]["worst_rel_err"],
        entry_points={"fused_ifft_clip_fft": {
            f: clip[f] for f in ("shape", "ms", "graph_ms", "plain_ms", "library_ms",
                                 "library_noclip_ms", "planes_ms", "planes_graph_ms",
                                 "bound_ms", "bound_by", "bound_share", "rel_err",
                                 "max_abs_err", "launches")}})
    missing = [f"fused_ifft_pa_fft[{layout}]" for layout, *_ in rows
               if not LAYOUT_LAUNCHES.get(layout, 0) and layout not in PLANES_LAYOUTS]
    if missing:
        raise AssertionError(f"layouts the paths never launched: {missing}")
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128, help="frames per round")
    ap.add_argument("--rounds", type=int, default=20,
                    help="timed rounds per arm of bench.py's Rayleigh frame")
    ap.add_argument("--los-rounds", type=int, default=5,
                    help="timed rounds per arm of the canonical LOS configuration")
    ap.add_argument("--out", default=None, help="also write all results as JSON here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mimo_ofdm_tpu_torch import bench
    from mimo_ofdm_tpu_torch.experiments import ber_sweeps
    from mimo_ofdm_tpu_torch.kernels import fused_pa as fp
    from mimo_ofdm_tpu_torch.models import link, link_ldpc, link_mu
    from mimo_ofdm_tpu_torch.ops import metrics, ofdm
    from mimo_ofdm_tpu_torch.utils import config, profiling, results

    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _, ptxas = fp.build_library()
    seconds = time.perf_counter() - t0
    print(ptxas, flush=True)
    resources = fp.kernel_resources()
    for r in resources:
        print(json.dumps({"phase": "build", "instantiation": r}), flush=True)
    tensor = [r for r in resources if r["tensor_cores"]]
    emit("build", seconds=seconds, instantiations=len(resources),
         tensor_core_instantiations=len(tensor),
         tensor_core_registers=[min(r["registers"] for r in tensor),
                                max(r["registers"] for r in tensor)],
         tensor_core_blocks_per_sm=min(r["blocks_per_sm"] for r in tensor),
         tensor_core_sass_mma=min(r["sass_mma"] for r in tensor))
    # every 4096-point instantiation, each layout: no spills, 2 blocks an SM
    short = [r for r in resources if r["n_fft"] == 4096
             and (r["local_bytes"] or r["blocks_per_sm"] < 2)]
    if short:
        raise AssertionError(f"4096-point instantiations spill or hold < 2 blocks/SM: {short}")
    # every bf16 instantiation on the tensor cores (HMMA or HGMMA in its
    # SASS), without spills, 2 blocks an SM; no f32 one on them
    wrong = [r for r in resources if r["layout"].endswith("bf16") != r["tensor_cores"]
             or (r["sass_mma"] > 0) != r["tensor_cores"]
             or (r["tensor_cores"] and (r["local_bytes"] or r["blocks_per_sm"] < 2))]
    if wrong:
        raise AssertionError(f"instantiations off their design: {wrong}")

    from mimo_ofdm_tpu_torch.kernels import antenna_combine as ac
    combine = combine_build(ac)
    combine_times = combine_timing(ac, dev, smi)

    emit("kernel_summary", **kernel_checks(fp, dev))
    snr_los = float(metrics.ebn0_to_snr(CANONICAL_EBN0_DB, 2048, 2048, 64))
    paths = main_path(fp, config, link, dev, args.batch, args.rounds, smi)
    frame_kernel_vs_plain(config, link, dev, snr_los)
    times = timing(fp, ofdm, dev, args.batch, smi)
    paths.update(los_paths(fp, config, link, dev, args.batch, args.los_rounds, snr_los, smi))
    paths["sweep"] = sweep(fp, config, results, ber_sweeps, dev, args.batch, smi)
    paths.update(channel_paths(fp, config, link, dev, args.batch, snr_los, smi))
    paths.update(multiuser(fp, config, link_mu, results, ber_sweeps, dev, args.batch,
                           snr_los, smi))
    paths.update(coded(fp, link, link_ldpc, profiling, results, ber_sweeps, metrics, dev, smi))
    paths.update(analysis(fp, config, results, dev, smi))
    analysis_times = analysis_timing(fp, ofdm, dev, smi)
    snr_coded = float(metrics.ebn0_to_snr(CODED_EBN0_DB[0], 2048, 2048, 64))
    paths.update(scale_out(fp, config, link, link_mu, link_ldpc, ber_sweeps, dev, args.batch,
                           snr_los, snr_coded, smi))
    paths.update(components(fp, config, link, dev, snr_los, smi, args.batch))
    paths.update(bench_phase(fp, bench, dev, paths, smi))
    times.update(bench_shapes(fp, ofdm, dev, paths["bench"]["settings"], smi))
    kernels = kernels_line(paths, times, analysis_times, smi)
    kernels["kernels"].append(combine_row(combine, combine_times, smi))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": RESULTS, "main_path": paths, "timing": times,
                       "combine_timing": combine_times,
                       "analysis_timing": analysis_times, **kernels}, f, indent=1,
                      default=str)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
